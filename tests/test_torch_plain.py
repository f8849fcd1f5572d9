"""The plain layout and uniform precision against the JAX package's: the
K1p (``star7_mv``) twin against ``star7_mv_pallas`` in the Pallas
interpreter, ``StarStencil3D.mv`` in f32 and f64, ``solve_poisson`` with
``layout="plain"`` and ``precision="f64"|"f32"`` against the JAX driver,
and the CLI's ``-layout plain`` / ``-precision`` against the JAX CLI.

On the CPU ``star7_mv`` runs its plain twin; ``test_torch_cuda.py`` holds
the CUDA kernel against the twin on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.__main__ import main as j_main
from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.amg.hierarchy import gamg_setup_compiled as j_gamg_setup_compiled
from tpusparse.amg.hierarchy import vcycle as j_vcycle
from tpusparse.bench.driver import solve_poisson as j_solve_poisson
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import poisson_stencil as j_poisson_stencil
from tpusparse.grid.poisson import poisson_stencil_device as j_poisson_stencil_device
from tpusparse.kernels.stencil7 import star7_mv_pallas
from tpusparse.solve.cg import cg as j_cg
from tpusparse.solve.refine import cg_refined as j_cg_refined
from tpusparse_torch import kernels
from tpusparse_torch.__main__ import main
from tpusparse_torch.amg.hierarchy import AMGParams, gamg_setup, vcycle
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil_device
from tpusparse_torch.interop import star_from_numpy
from tpusparse_torch.kernels.stencil7 import star7_mv
from tpusparse_torch.solve.cg import cg
from tpusparse_torch.solve.refine import cg_refined
from test_torch_cli import _grid, _run

KW = dict(rtol=1e-8, atol=1e-12, pc="gamg", warmup=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stars(shape, pinned, dtype=np.float32):
    nz, ny, nx = shape
    jop, _, _ = j_poisson_stencil(JGrid3D(nx, ny, nz), pin=pinned, dtype=dtype)
    op = star_from_numpy(np.asarray(jop.diag), jop.cx, jop.cy, jop.cz, pinned, device="cpu")
    x = np.random.default_rng(3).standard_normal(shape).astype(dtype)
    return jop, op, x


@pytest.mark.parametrize("pinned", [True, False])
def test_k1p_twin_matches_pallas_interpreter(pinned):
    """star7_mv against star7_mv_pallas (pad, K1, crop) in the interpreter
    on a ragged plain field, to test_k1_twin_matches_pallas_interpreter's
    tolerance (the interpreter sums in another order)."""
    shape = (12, 11, 13)
    jop, op, x = _stars(shape, pinned)
    want = np.asarray(star7_mv_pallas(jop.diag, jop.cx, jop.cy, jop.cz, jnp.asarray(x), pinned,
                                      interpret=True))
    got = star7_mv(op.diag, op.cx, op.cy, op.cz, torch.tensor(x), pinned)
    assert kernels.LAUNCHES["star7_mv"] == 0   # CPU tensors: the twin
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype, rtol", [(np.float32, 1e-6), (np.float64, 1e-14)])
def test_star_stencil_mv_matches_jax(dtype, rtol):
    """StarStencil3D.mv (K1p's twin in f32, plain torch in f64) against the
    JAX operator's XLA apply."""
    jop, op, x = _stars((9, 7, 10), True, dtype)
    want = np.asarray(jop.mv(jnp.asarray(x)))
    got = op.mv(torch.tensor(x)).numpy()
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_plain_layout_solve_matches_jax():
    """Mixed precision over the plain layout at 18^3: the same reason and
    sweeps, inner within 1, Linf to 1e-6 (as the padded route's slice test)."""
    want = j_solve_poisson(18, layout="plain", **KW)
    got = solve_poisson(18, device="cpu", layout="plain", **KW)
    assert (got.reason, got.outer_iters) == (want.reason, want.outer_iters) == (2, 2)
    assert abs(got.iters - want.iters) <= 1
    assert abs(got.linf_error - want.linf_error) < 1e-6


@pytest.fixture(scope="module")
def plain16():
    """The 16^3 plain-layout system of each package with its own hierarchy,
    built as each driver builds it (the JAX one compiled)."""
    grid = (16, 16, 16)
    jop, jb, _ = j_poisson_stencil_device(JGrid3D(*grid), dtype=np.float64)
    jlo = j_poisson_stencil_device(JGrid3D(*grid), dtype=np.float32)[0]
    op, b, _ = poisson_stencil_device(Grid3D(*grid), dtype=torch.float64, device="cpu")
    lo = poisson_stencil_device(Grid3D(*grid), dtype=torch.float32, device="cpu")[0]
    return {
        "jax": (jop, jlo, jb, j_gamg_setup_compiled(jlo, JAMGParams())),
        "port": (op, lo, b, gamg_setup(lo, AMGParams())),
    }


@pytest.fixture(scope="module")
def second_rhs(plain16):
    """Each package's r = b - A x after one defect-correction sweep."""
    jop, jlo, jb, jh = plain16["jax"]
    jx = j_cg_refined(jop.mv, jlo.mv, jb, m_lo_mv=lambda r: j_vcycle(jh, r), max_outer=1,
                      rtol=KW["rtol"], atol=KW["atol"]).x
    op, lo, b, h = plain16["port"]
    x = cg_refined(op.mv, lo.mv, b, m_lo_mv=lambda r: vcycle(h, r), max_outer=1,
                   rtol=KW["rtol"], atol=KW["atol"]).x
    jx, x = np.asarray(jx), x.numpy()
    print(f"first sweep: x apart by {np.linalg.norm(x - jx) / np.linalg.norm(jx):.3e} relative")
    return {"jax": np.asarray(jb - jop.mv(jnp.asarray(jx))), "port": (b - op.mv(torch.tensor(x))).numpy()}


@pytest.mark.parametrize("first", ["jax", "port"])
def test_plain_second_inner_solve_matches_jax_on_one_rhs(plain16, second_rhs, first):
    """At 16^3 the plain route's inner counts part (JAX 19, the port 15 on
    the CPU and 19 on the card): the first sweep's f32 solutions differ by
    ~1e-5, so the second sweep's right-hand side, a residual of 1e-5 ||b||,
    differs by ~14%, and that solve's count follows it.  Fed one and the
    same right-hand side (from either package's first sweep), the two
    packages' second inner solves take the same count."""
    r2, other = second_rhs[first], second_rhs["port" if first == "jax" else "jax"]
    apart = np.linalg.norm(r2 - other) / np.linalg.norm(other)
    assert apart > 0.05   # the premise: the two right-hand sides differ
    rnorm = np.linalg.norm(r2)
    bnorm = np.linalg.norm(plain16["port"][2].numpy())
    need = float(np.float32(min(max(0.25 * max(KW["rtol"] * bnorm, KW["atol"]) / rnorm, 1e-5), 0.5)))
    r_lo = (r2 / rnorm).astype(np.float32)
    _, jlo, _, jh = plain16["jax"]
    _, lo, _, h = plain16["port"]
    want = j_cg(jlo.mv, jnp.asarray(r_lo), rtol=need, maxiter=200, m_mv=lambda r: j_vcycle(jh, r))
    got = cg(lo.mv, torch.tensor(r_lo), rtol=need, maxiter=200, m_mv=lambda r: vcycle(h, r))
    print(f"second inner solve on the {first} right-hand side ({apart:.3f} apart):"
          f" JAX {int(want.iters)}, the port {got.iters}")
    assert got.reason == int(want.reason) == 2
    assert got.iters == int(want.iters)


@pytest.mark.parametrize(
    "precision, rtol, linf_abs",
    [
        ("f64", 1e-8, 1e-6),
        # at rtol 1e-6 each package's f32 solve leaves an algebraic error of
        # ~5e-6 against the f64 solve's Linf, rounded differently (8e-6
        # apart here, and as far with the JAX right-hand side fed to the port)
        ("f32", 1e-6, 2e-5),
    ],
)
def test_uniform_precision_solve_matches_jax(precision, rtol, linf_abs):
    """One solve in the operator's dtype, no defect correction, at 16^3:
    the same reason, iterations within 1."""
    kw = dict(KW, rtol=rtol)
    want = j_solve_poisson(16, precision=precision, **kw)
    got = solve_poisson(16, device="cpu", precision=precision, **kw)
    assert got.reason == want.reason == 2
    assert got.outer_iters == 0 and got.precision == precision
    assert abs(got.iters - want.iters) <= 1
    assert abs(got.linf_error - want.linf_error) < linf_abs


@pytest.mark.parametrize(
    "argv",
    [["-layout", "plain"], ["-precision", "f64"]],
)
def test_cli_routes_match_jax(argv):
    """-layout plain and -precision f64 through both CLIs at 12^3 (the JAX
    CLI's default layout on the CPU is the plain one)."""
    args = [*_grid(12), "-ksp_rtol", "1e-8", "-ksp_atol", "1e-12", "-ksp_view", *argv]
    wtext, want = _run(j_main, args)
    text, got = _run(main, [*args, "-device", "cpu"])
    assert (got["reason"], got["outer_iters"]) == (want["reason"], want["outer_iters"])
    assert got["reason"] == 2 and abs(got["iters"] - want["iters"]) <= 1
    assert got["linf_error"] == pytest.approx(want["linf_error"], abs=1e-6)
    assert "operator StarStencil3D" in text


@pytest.mark.parametrize(
    "argv, match",
    [
        (["-precision", "tf"], "not to port"),
        # -mat_structure_detect 0 -pc_bjacobi_bs 4 on aij stood here; item
        # 9.2 runs it (tests/test_torch_unstructured.py).  -problem
        # diffusion, refused as queue 11 before, runs on one device
        # (tests/test_torch_diffusion.py), with -devices p too, as in the
        # JAX CLI: test_former_cli_refusals_run
    ],
)
def test_cli_refusals_name_their_roadmap_item(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        main([*_grid(8), *argv, "-device", "cpu"])


@pytest.mark.parametrize(
    "argv, expect",
    [
        (["-pc_dtype", "bf16", "-layout", "plain"], "pc_dtype: bf16"),
        (["-pc_dtype", "bf16", "-precision", "f32"], "pc_dtype: bf16"),
        (["-ksp_compute_eigenvalues", "-precision", "f64"], "Iteratively computed eigenvalues"),
        (["-problem", "diffusion", "-devices", "2"], "problem: diffusion"),
    ],
)
def test_former_cli_refusals_run(argv, expect):
    """The values these routes refused until cast_hierarchy and
    solve/spectrum.py were ported, and -problem diffusion with -devices p
    (the one-device solve, as the JAX CLI runs it), run at 8^3 on the CPU."""
    text, got = _run(main, [*_grid(8), *argv, "-ksp_view", "-device", "cpu"])
    assert got["reason"] == 2 and expect in text

"""The diffusion family (``-problem diffusion``) on the port against the JAX
package on the CPU: ``default_kappa``, ``assemble_diffusion``,
``VarStencil27``'s host members, ``solve_diffusion`` and the CLI branch.

The assembly is bit for bit JAX's: the 7 star planes are JAX's numpy
arithmetic.  The solves: JAX's hierarchy is built under
``jax.disable_jit()`` (compiled, XLA rounds the rho start vector once
where both eager forms round twice: ``tests/test_torch_amg.py``), once
per fine operator and reused for the V- and W-cycle.  Counts and reasons
are held exactly where they agree (inner within 2); Linf in f64 to 1e-10.
Under mixed and f32 precision each package's f32 dots sum in their own
order, so the solutions differ inside what the tolerance allows: at
16^3-18^3 Linf differs by up to 4.1e-7 (mixed, Linf ~1e-6) and 9.5e-4
(f32, Linf ~1e-3, the f32 system's own rounding); those are held to
1e-6 and to Linf < 2e-3 in both packages.
"""

import contextlib
import io
import json
import warnings

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpusparse.amg.hierarchy as j_hierarchy
from tpusparse.__main__ import main as j_main
from tpusparse.bench.driver import solve_diffusion as j_solve_diffusion
from tpusparse.grid.diffusion import assemble_diffusion as j_assemble_diffusion
from tpusparse.grid.diffusion import default_kappa as j_default_kappa
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.sparse.varstencil import VarStencil27 as JVarStencil27
from tpusparse_torch.__main__ import main
from tpusparse_torch.bench.driver import solve_diffusion
from tpusparse_torch.grid.diffusion import assemble_diffusion, default_kappa
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.sparse.varstencil import VarStencil27


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("contrast", [1.0, 100.0])
def test_default_kappa_is_jax_bit_for_bit(contrast):
    got = default_kappa(Grid3D(12, 12, 12), contrast=contrast)
    want = j_default_kappa(JGrid3D(12, 12, 12), contrast=contrast)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("pin", [True, False])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_assembly_matches_jax(dtype, pin):
    """The coefficient planes (within 1 ulp; equal in practice), the CSR
    (pattern exact, values within 1 ulp) and b equal JAX's, on a ragged
    grid."""
    g, jg = Grid3D(12, 10, 9), JGrid3D(12, 10, 9)
    kappa = default_kappa(g)
    op, a, b = assemble_diffusion(g, kappa, pin=pin, dtype=dtype, device="cpu")
    jop, ja, jb = j_assemble_diffusion(jg, kappa, pin=pin, dtype=dtype)
    assert op.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    np.testing.assert_array_max_ulp(op.coef.numpy(), np.asarray(jop.coef), maxulp=1)
    assert np.array_equal(a.indptr, ja.indptr) and np.array_equal(a.indices, ja.indices)
    np.testing.assert_array_max_ulp(a.data, ja.data, maxulp=1)
    assert np.array_equal(b.numpy(), jb)


def test_assembly_takes_callables_and_checks_kappa():
    g = Grid3D(6, 6, 6)
    op, _, _ = assemble_diffusion(g, lambda grid: np.ones(grid.shape), device="cpu")
    jop, _, _ = j_assemble_diffusion(JGrid3D(6, 6, 6), lambda grid: np.ones(grid.shape))
    assert np.array_equal(op.coef.numpy(), np.asarray(jop.coef))
    with pytest.raises(ValueError, match="kappa shape"):
        assemble_diffusion(g, np.ones((5, 6, 6)), device="cpu")


def test_operator_is_symmetric_negative_definite():
    _, a, _ = assemble_diffusion(Grid3D(10, 10, 10), device="cpu")
    s = a.to_scipy()
    assert abs(s - s.T).max() == 0.0
    eig = np.linalg.eigvalsh(s.toarray())
    assert eig.max() < 0.0


def test_varstencil_host_members_match_jax():
    """shape, mv_flat, @ on fields and flat vectors, and to_csr on random
    27-point coefficients (the targets off the grid dropped)."""
    rng = np.random.default_rng(7)
    coef = rng.standard_normal((27, 5, 4, 6))
    op, jop = VarStencil27(coef=torch.tensor(coef)), JVarStencil27(coef=jax.numpy.asarray(coef))
    assert op.shape == tuple(jop.shape) == (120, 120)
    x = rng.standard_normal(120)
    want = np.asarray(jop.mv_flat(jax.numpy.asarray(x)))
    np.testing.assert_allclose(op.mv_flat(torch.tensor(x)).numpy(), want, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose((op @ torch.tensor(x)).numpy(), want, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose((op @ torch.tensor(x.reshape(5, 4, 6))).numpy().reshape(-1), want,
                               rtol=1e-13, atol=1e-13)
    a, ja = op.to_csr(), jop.to_csr()
    assert np.array_equal(a.indptr, ja.indptr) and np.array_equal(a.indices, ja.indices)
    assert np.array_equal(a.data, ja.data)
    np.testing.assert_allclose(a.mv(x), want, rtol=1e-12, atol=1e-12)
    assert isinstance(a.to_scipy(), sp.csr_matrix)


@pytest.fixture(scope="module")
def jax_eager_setup():
    """JAX's ``gamg_setup_compiled`` replaced by the eager build, one a
    fine operator (mixed and f32 share the f32 one)."""
    cache = {}
    orig = j_hierarchy.gamg_setup_compiled

    def eager(op, params):
        key = (tuple(op.coef.shape), str(op.coef.dtype), params)
        if key not in cache:
            with jax.disable_jit():
                cache[key] = j_hierarchy.gamg_setup(op, params)
        return cache[key]

    j_hierarchy.gamg_setup_compiled = eager
    yield
    j_hierarchy.gamg_setup_compiled = orig


@pytest.mark.parametrize("mg_cycle", ["v", "w"])
@pytest.mark.parametrize("precision", ["mixed", "f64", "f32"])
@pytest.mark.parametrize("n", [16, 18])
def test_solve_diffusion_matches_jax(jax_eager_setup, n, precision, mg_cycle):
    rtol = 1e-6 if precision == "f32" else 1e-8
    kw = dict(precision=precision, mg_cycle=mg_cycle, rtol=rtol, warmup=False)
    want = j_solve_diffusion(n, **kw)
    got = solve_diffusion(n, device="cpu", **kw)
    print(f"{n}^3 {precision} {mg_cycle}: inner {got.iters} / {want.iters} (JAX), Linf {got.linf_error:.3e} /"
          f" {want.linf_error:.3e}")
    assert (got.reason, got.outer_iters) == (want.reason, want.outer_iters)
    assert got.reason == 2 and abs(got.iters - want.iters) <= 2
    assert (got.mat_type, got.source) == (want.mat_type, want.source) == ("varstencil", "diffusion(contrast=100)")
    if precision == "f64":
        assert got.linf_error == pytest.approx(want.linf_error, abs=1e-10)
    elif precision == "mixed":
        assert got.linf_error == pytest.approx(want.linf_error, abs=1e-6)
    else:
        assert max(got.linf_error, want.linf_error) < 2e-3


def test_solve_diffusion_view_and_refusals():
    rep = solve_diffusion(9, device="cpu", view=True, warmup=False)
    assert "problem: diffusion (contrast 100, VarStencil27 fine level)" in rep.solver_view
    assert "operator VarStencil27" in rep.solver_view
    with pytest.raises(ValueError, match="precision"):
        solve_diffusion(9, device="cpu", precision="tf")


def _run(fn, argv) -> tuple[str, dict]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fn(argv) == 0
    text = out.getvalue()
    side = [line for line in text.splitlines() if line.startswith("JSON: ")]
    assert len(side) == 1
    return text, json.loads(side[0][len("JSON: "):])


def test_cli_reference_block_matches_jax():
    """-problem diffusion through both CLIs at 12^3 (JAX's hierarchy
    compiled, as its CLI runs it): the reference block's head and counts
    alike, Linf within 1e-6."""
    argv = ["-problem", "diffusion", "-da_grid_x", "12", "-da_grid_y", "12", "-da_grid_z", "12",
            "-diffusion_contrast", "100", "-ksp_rtol", "1e-8", "-ksp_converged_reason"]
    jtext, want = _run(j_main, argv)
    text, got = _run(main, [*argv, "-device", "cpu"])
    assert (got["iters"], got["outer_iters"], got["reason"]) == (want["iters"], want["outer_iters"], want["reason"])
    assert got["linf_error"] == pytest.approx(want["linf_error"], abs=1e-6)
    head = [line for line in text.splitlines() if not line.startswith(("L2 norm", "Maximum", "Time", "JSON"))]
    jhead = [line for line in jtext.splitlines() if not line.startswith(("L2 norm", "Maximum", "Time", "JSON"))]
    assert head == jhead
    assert "Problem: diffusion(contrast=100)" in text


@pytest.mark.parametrize("argv", [["-ksp_type", "gmres"], ["-pc_type", "jacobi"]])
def test_cli_refuses_other_methods_as_jax(argv):
    full = ["-problem", "diffusion", "-da_grid_x", "6", "-da_grid_y", "6", "-da_grid_z", "6", *argv]
    with pytest.raises(ValueError, match="-problem diffusion runs"):
        j_main(full)
    with pytest.raises(ValueError, match="-problem diffusion runs"):
        main([*full, "-device", "cpu"])


def test_cli_warnings_and_the_devices_refusal():
    argv = ["-problem", "diffusion", "-da_grid_x", "6", "-da_grid_y", "6", "-da_grid_z", "6", "-device", "cpu"]
    with pytest.warns(UserWarning, match="not wired to the diffusion driver"):
        _, got = _run(main, [*argv, "-ksp_monitor"])
    assert got["reason"] > 0 and got["residual_history"] is None
    # the JAX CLI runs its one-device driver whatever -devices says; the
    # port does as well, and says so
    with pytest.warns(UserWarning, match="-devices 2 is ignored for -problem diffusion"):
        _, got = _run(main, [*argv, "-devices", "2"])
    assert got["reason"] > 0 and got["z_shards"] == 1
    with pytest.raises(ValueError, match="unknown -problem"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            main([*argv[:-2], "-problem", "heat", "-device", "cpu"])


@pytest.mark.slow
@pytest.mark.parametrize("n", [32, 48])
def test_diffusion_count_spread_witness(n):
    """The witness behind ``chip_smoke.py``'s diffusion gate (134 +- 35
    inner, Linf < 1e-4 at 192^3): past 18^3 the count follows the rounding
    of the f32 inner solves, so the JAX package with its compiled
    hierarchy (as its driver runs), JAX with the eager one and the port
    take different counts (at 48^3: 66, 86 and 71).  Each lies within the
    gate's relative window, 35/134, of the port's, each converges with
    reason 2 in 3 sweeps, and Linf stays far below 1e-4.  ~3 min for both
    sizes: ``pytest -m slow``."""
    got = solve_diffusion(n, device="cpu", warmup=False)
    compiled = j_solve_diffusion(n, warmup=False)
    orig = j_hierarchy.gamg_setup_compiled

    def eager(op, params):
        with jax.disable_jit():
            return j_hierarchy.gamg_setup(op, params)

    j_hierarchy.gamg_setup_compiled = eager
    try:
        eager_rep = j_solve_diffusion(n, warmup=False)
    finally:
        j_hierarchy.gamg_setup_compiled = orig
    print(f"{n}^3 inner + outer, Linf: port {got.iters} + {got.outer_iters} {got.linf_error:.3e}; JAX compiled"
          f" {compiled.iters} + {compiled.outer_iters} {compiled.linf_error:.3e}; JAX eager {eager_rep.iters} +"
          f" {eager_rep.outer_iters} {eager_rep.linf_error:.3e}")
    for rep in (got, compiled, eager_rep):
        assert rep.reason == 2 and rep.linf_error < 1e-4
        assert abs(rep.iters - got.iters) <= 35 / 134 * got.iters

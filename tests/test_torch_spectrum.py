"""The Krylov methods' records against the JAX package's on the CPU:
``solve/spectrum.py`` (Ritz values from CG's scalars), ``cg``'s
``spectrum``/``history``/``state0``, every method's
``history``, the driver's eigenvalues and uniform ``-ksp_monitor``,
``cast_hierarchy`` and the bf16 V-cycle, and the headline bench entry."""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.amg.hierarchy import cast_hierarchy as j_cast_hierarchy
from tpusparse.amg.hierarchy import gamg_setup as j_gamg_setup
from tpusparse.amg.hierarchy import vcycle as j_vcycle
from tpusparse.bench.driver import solve_poisson as j_solve_poisson
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import poisson_stencil_device as j_poisson_stencil_device
from tpusparse.solve.bcgs import bicgstab as j_bicgstab
from tpusparse.solve.cg import cg as j_cg
from tpusparse.solve.chebyshev import chebyshev as j_chebyshev
from tpusparse.solve.fgmres import fgmres as j_fgmres
from tpusparse.solve.gmres import gmres as j_gmres
from tpusparse.solve.minres import minres as j_minres
from tpusparse.solve.pipelined import cg_pipelined as j_cg_pipelined
from tpusparse.solve.simple import preonly as j_preonly
from tpusparse.solve.simple import richardson as j_richardson
from tpusparse.solve.spectrum import eigenvalue_block as j_eigenvalue_block
from tpusparse.solve.spectrum import ritz_values as j_ritz_values
from tpusparse_torch.amg.hierarchy import cast_hierarchy, vcycle
from tpusparse_torch.bench import headline
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil_device
from tpusparse_torch.interop import hierarchy_from_numpy
from tpusparse_torch.solve.bcgs import bicgstab
from tpusparse_torch.solve.cg import cg
from tpusparse_torch.solve.chebyshev import chebyshev
from tpusparse_torch.solve.fgmres import fgmres
from tpusparse_torch.solve.gmres import gmres
from tpusparse_torch.solve.minres import minres
from tpusparse_torch.solve.pipelined import cg_pipelined
from tpusparse_torch.solve.simple import preonly, richardson
from tpusparse_torch.solve.spectrum import eigenvalue_block, ritz_values
from torch_parity import jax_levels, port_copy

N = 12
P = functools.partial
# name -> (JAX solver, port solver); restart 8 makes GMRES restart
SOLVERS = {
    "cg": (j_cg, cg),
    "pipecg": (j_cg_pipelined, cg_pipelined),
    "gmres": (P(j_gmres, restart=8), P(gmres, restart=8)),
    "fgmres": (P(j_fgmres, restart=8), P(fgmres, restart=8)),
    "bcgs": (j_bicgstab, bicgstab),
    "minres": (j_minres, minres),
    "chebyshev": (j_chebyshev, chebyshev),
    "richardson": (P(j_richardson, scale=0.9), P(richardson, scale=0.9)),
    "preonly": (j_preonly, preonly),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def systems():
    """The pinned f64 Poisson system at N^3 in both packages, preconditioned
    by one f64 GAMG V-cycle: the JAX package's hierarchy and the port's copy
    of it (its coefficient stacks kept in f64)."""
    jop, jb, _ = j_poisson_stencil_device(JGrid3D(N, N, N))
    jh = j_gamg_setup(jop)
    levels = jax_levels(jh)
    for lv, jlev in zip(levels, jh.levels):
        if "coef" in lv["op"]:
            lv["op"]["coef"] = np.asarray(jlev.op.coef)
    ph = hierarchy_from_numpy(
        levels, damping=np.asarray(jh.damping), smoother=jh.smoother, degree=jh.degree,
        cheby_lo=jh.cheby_lo, cheby_hi=jh.cheby_hi, level_spec=jh.level_spec, device="cpu",
    )
    op, b, _ = poisson_stencil_device(Grid3D(N, N, N), device="cpu")
    return (jop, jb, lambda r: j_vcycle(jh, r)), (op, b, lambda r: vcycle(ph, r))


@pytest.mark.parametrize("k", [1, 2, 5, 17])
def test_ritz_values_and_block_match_jax(k):
    """The same scalars give the same Ritz values and the same text."""
    rng = np.random.default_rng(k)
    alphas = rng.uniform(0.5, 2.0, 20)
    betas = rng.uniform(0.01, 0.9, 20)
    want = j_ritz_values(alphas, betas, k)
    got = ritz_values(alphas, betas, k)
    np.testing.assert_array_equal(got, want)
    assert eigenvalue_block(got) == j_eigenvalue_block(want)


def test_ritz_values_refuse_an_indefinite_pair():
    assert ritz_values(np.ones(3), np.ones(3), 0).size == 0
    with pytest.raises(ValueError, match="negative"):
        ritz_values(np.array([1.0, -1.0]), np.array([0.5]), 2)
    with pytest.raises(ValueError, match="non-finite"):
        ritz_values(np.array([1.0, np.nan]), np.array([0.5]), 2)


def test_cg_spectrum_matches_jax(systems):
    """``cg(spectrum=True)``: the same (maxiter,) alphas and betas, to
    rtol 1e-10 over the iterations run, zeros past them."""
    (jop, jb, jm), (op, b, m) = systems
    want, (jal, jbe) = j_cg(jop.mv, jb, rtol=1e-8, maxiter=80, m_mv=jm, spectrum=True)
    got, (al, be) = cg(op.mv, b, rtol=1e-8, maxiter=80, m_mv=m, spectrum=True)
    assert got.iters == int(want.iters) and 0 < got.iters < 80
    assert al.shape == be.shape == (80,) and al.dtype == be.dtype == np.float64
    np.testing.assert_allclose(al, np.asarray(jal), rtol=1e-10, atol=0)
    np.testing.assert_allclose(be, np.asarray(jbe), rtol=1e-10, atol=0)
    assert not al[got.iters:].any() and al[got.iters - 1] > 0


@pytest.mark.parametrize("name", list(SOLVERS))
def test_history_matches_jax(systems, name):
    """Each method's ``history``: the (maxiter + 1,) f32 record of the norm
    it gates on, the same length and values to rtol 1e-8 (zeros past the
    last iteration).  The records are f32: two norms 1e-13 apart in f64 can
    round to adjacent f32 values, so each entry may also differ by one f32
    spacing (pipecg at 12^3 has one such entry)."""
    (jop, jb, jm), (op, b, m) = systems
    j_solve, solve = SOLVERS[name]
    kw = dict(rtol=1e-8, maxiter=60, history=True)
    want, jhist = j_solve(jop.mv, jb, m_mv=jm, **kw)
    got, hist = solve(op.mv, b, m_mv=m, **kw)
    jhist = np.asarray(jhist)
    assert got.iters == int(want.iters)
    assert hist.shape == jhist.shape and hist.dtype == np.float32
    tol = np.maximum(1e-8 * np.abs(jhist), np.spacing(np.abs(jhist)))
    assert (np.abs(hist - jhist) <= tol).all(), np.abs(hist - jhist) / tol
    assert hist[0] > 0


@pytest.mark.slow
@pytest.mark.parametrize("n", [48, 64])
@pytest.mark.parametrize("pc_dtype", ["f32", "bf16"])
def test_bf16_cycle_counts_match_jax(n, pc_dtype):
    """The witness behind the bf16 cycle's extra iterations on the card:
    at 48^3 and 64^3 on the CPU the JAX package's bf16 hierarchy takes as
    many inner iterations as the port's, and as many more than the f32
    cycle, so the growth is the bf16 hierarchy's, not the port's
    rounding.  ~1-3 min a case: ``pytest -m slow -s``."""
    kw = dict(rtol=1e-8, atol=1e-12, pc_dtype=pc_dtype, warmup=False)
    want = j_solve_poisson(n, **kw)
    got = solve_poisson(n, device="cpu", layout="plain", **kw)
    print(f"{n}^3 pc_dtype={pc_dtype}: JAX {want.iters} + {want.outer_iters},"
          f" port {got.iters} + {got.outer_iters}")
    assert (got.outer_iters, got.reason) == (want.outer_iters, want.reason) and got.reason == 2
    assert abs(got.iters - want.iters) <= 1
    assert abs(got.linf_error - want.linf_error) < 1e-6


def test_incompatible_records_refuse(systems):
    """JAX's rules: one extra result at a time."""
    _, (op, b, m) = systems
    for kw in (dict(history=True, return_state=True), dict(spectrum=True, history=True),
               dict(spectrum=True, return_state=True)):
        with pytest.raises(ValueError):
            cg(op.mv, b, m_mv=m, **kw)


def test_state_resume_is_exact(systems):
    """One run of 2k iterations equals k iterations and a resume from the
    returned state, bitwise."""
    _, (op, b, m) = systems
    whole = cg(op.mv, b, rtol=1e-14, maxiter=20, m_mv=m)
    half, state = cg(op.mv, b, rtol=1e-14, maxiter=10, m_mv=m, return_state=True)
    assert (half.iters, state[6]) == (10, 10)
    rest, state = cg(op.mv, b, rtol=1e-14, maxiter=20, m_mv=m, state0=state, return_state=True)
    assert rest.iters == whole.iters == 20 and rest.reason == whole.reason
    assert torch.equal(rest.x, whole.x)
    assert rest.resnorm == whole.resnorm


def test_driver_eigenvalues_match_jax():
    """``compute_eigenvalues`` on uniform-precision CG at 12^3: the Ritz
    values of M A from the GAMG-preconditioned solve, to rtol 1e-6."""
    kw = dict(rtol=1e-8, atol=1e-12, precision="f64", compute_eigenvalues=True)
    want = j_solve_poisson(N, warmup=False, **kw)
    got = solve_poisson(N, device="cpu", warmup=False, **kw)
    assert got.iters == want.iters and len(got.eigenvalues) == got.iters
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-6)
    assert got.eigenvalues[0] > 0
    assert got.eigenvalues_block().splitlines()[0] == f"Iteratively computed eigenvalues: {got.iters}"


@pytest.mark.parametrize("ksp", ["cg", "gmres", "minres"])
def test_driver_uniform_monitor_matches_jax(ksp):
    """``monitor`` under uniform precision: one norm an iteration and the
    initial one, as the JAX driver records them."""
    kw = dict(rtol=1e-8, atol=1e-12, precision="f64", ksp=ksp, monitor=True)
    want = j_solve_poisson(N, warmup=False, **kw)
    got = solve_poisson(N, device="cpu", warmup=False, **kw)
    assert got.iters == want.iters
    assert len(got.residual_history) == got.iters + 1 == len(want.residual_history)
    np.testing.assert_allclose(got.residual_history, want.residual_history, rtol=1e-5)
    assert got.monitor_block().splitlines()[-1].startswith(f"  {got.iters} KSP Residual norm")


@pytest.fixture(scope="module")
def hierarchies():
    """One plain f32 JAX hierarchy at N^3 and the port's copy of it."""
    jop = j_poisson_stencil_device(JGrid3D(N, N, N), dtype=np.float32)[0]
    jh = j_gamg_setup(jop)
    return jh, port_copy(jh)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def test_cast_hierarchy_matches_jax(hierarchies):
    """Every field cast to bf16 bitwise as JAX's ``cast_hierarchy`` casts
    it: diagonals, coefficient stacks, transfers and the scalars."""
    jh, ph = hierarchies
    want = jax_levels(j_cast_hierarchy(jh, jnp.bfloat16))
    got = cast_hierarchy(ph, torch.bfloat16)
    assert got.damping == float(np.asarray(j_cast_hierarchy(jh, jnp.bfloat16).damping, np.float32))
    jlevels = j_cast_hierarchy(jh, jnp.bfloat16).levels
    for lev, jlev, w in zip(got.levels, jlevels, want):
        assert lev.dinv.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(lev.dinv), np.asarray(jlev.dinv).view(np.uint16))
        if hasattr(lev.op, "coef"):
            np.testing.assert_array_equal(_bits(lev.op.coef), np.asarray(jlev.op.coef).view(np.uint16))
        else:
            np.testing.assert_array_equal(_bits(lev.op.diag), np.asarray(jlev.op.diag).view(np.uint16))
            for leg in ("cx", "cy", "cz"):
                assert getattr(lev.op, leg) == float(np.asarray(getattr(jlev.op, leg), np.float32))
        assert lev.rho == float(np.asarray(jlev.rho, np.float32))
        if lev.transfer is not None:
            assert lev.transfer.omega == float(np.asarray(jlev.transfer.omega, np.float32))
            for f in ("tnorm", "sz", "sy", "sx"):
                np.testing.assert_array_equal(
                    _bits(getattr(lev.transfer, f)), np.asarray(getattr(jlev.transfer, f)).view(np.uint16),
                )
        assert w["op"] is not None


def test_bf16_vcycle_matches_jax(hierarchies):
    """One bf16 V-cycle on the same f32 residual, to rtol 2e-2 of the JAX
    package's, and within 2e-2 of the f32 cycle."""
    jh, ph = hierarchies
    r = np.random.default_rng(3).standard_normal((N, N, N)).astype(np.float32)
    want = np.asarray(j_vcycle(j_cast_hierarchy(jh, jnp.bfloat16), jnp.asarray(r).astype(jnp.bfloat16)),
                      np.float32)
    got = vcycle(cast_hierarchy(ph, torch.bfloat16), torch.tensor(r).to(torch.bfloat16)).float().numpy()
    f32 = vcycle(ph, torch.tensor(r)).numpy()
    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)
    assert np.linalg.norm(got - f32) <= 2e-2 * np.linalg.norm(f32)


@pytest.mark.parametrize("argv", [["-layout", "plain"], ["-precision", "f32"]])
def test_bf16_driver_matches_jax(argv):
    """``pc_dtype="bf16"`` on the plain layout and under uniform f32 at
    12^3: the same reason and sweeps as the JAX driver, inner within 1,
    Linf to 2e-5."""
    kw = dict(rtol=1e-6 if argv[0] == "-precision" else 1e-8, atol=1e-12, pc_dtype="bf16",
              **({"layout": "plain"} if argv[0] == "-layout" else {"precision": "f32"}))
    want = j_solve_poisson(N, warmup=False, **kw)
    got = solve_poisson(N, device="cpu", warmup=False, view=True, **kw)
    assert got.reason == want.reason == 2 and got.outer_iters == want.outer_iters
    assert abs(got.iters - want.iters) <= 1
    assert abs(got.linf_error - want.linf_error) < 2e-5
    assert "pc_dtype: bf16" in got.solver_view


def test_headline_prints_one_json_line(capsys):
    """The bench entry on a CPU grid: one JSON line on stdout with
    ``bench.py``'s four keys; the report goes to stderr."""
    assert headline.main(["8"], device="cpu") == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "poisson8_cg_gamg_solve_s" and line["unit"] == "s"
    assert line["vs_baseline"] == pytest.approx(30.0 / line["value"])
    assert "[Nx, Ny, Nz]: [8, 8, 8]" in err


def test_headline_run_returns_the_report():
    rep, line = headline.run(8, device="cpu")
    assert rep.reason == 2 and line["value"] == rep.t_solve

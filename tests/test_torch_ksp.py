"""The non-CG Krylov methods against the JAX package's: each of
``solve/{pipelined, gmres, fgmres, bcgs, minres, chebyshev, simple}.py`` on
the same small systems, and the refined solve with a non-CG inner method
over the dot-free fused V-cycle on a shared hierarchy."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.amg.fused_cycle import vcycle_fused as j_vcycle_fused
from tpusparse.amg.fused_cycle import vcycle_fused_dots as j_vcycle_fused_dots
from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.amg.hierarchy import cast_coarse_coefs as j_cast_coarse_coefs
from tpusparse.amg.hierarchy import gamg_setup as j_gamg_setup
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import poisson_stencil_device as j_poisson_stencil_device
from tpusparse.solve.bcgs import bicgstab as j_bicgstab
from tpusparse.solve.cg import cg as j_cg
from tpusparse.solve.chebyshev import chebyshev as j_chebyshev
from tpusparse.solve.fgmres import fgmres as j_fgmres
from tpusparse.solve.gmres import gmres as j_gmres
from tpusparse.solve.minres import minres as j_minres
from tpusparse.solve.pipelined import cg_pipelined as j_cg_pipelined
from tpusparse.solve.refine import cg_refined as j_cg_refined
from tpusparse.solve.simple import preonly as j_preonly
from tpusparse.solve.simple import richardson as j_richardson
from tpusparse.sparse.padded import PaddedStar as JPaddedStar
from tpusparse.sparse.padded import crop_field as j_crop_field
from tpusparse.sparse.padded import pad_field as j_pad_field
from tpusparse_torch import kernels
from tpusparse_torch.amg.fused_cycle import vcycle_fused, vcycle_fused_dots
from tpusparse_torch.amg.hierarchy import cast_coarse_coefs
from tpusparse_torch.bench.driver import _pick_ksp
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil_device
from tpusparse_torch.solve.bcgs import bicgstab
from tpusparse_torch.solve.cg import ConvergedReason, cg
from tpusparse_torch.solve.chebyshev import chebyshev
from tpusparse_torch.solve.fgmres import fgmres
from tpusparse_torch.solve.gmres import gmres
from tpusparse_torch.solve.minres import minres
from tpusparse_torch.solve.pipelined import cg_pipelined
from tpusparse_torch.solve.refine import cg_refined
from tpusparse_torch.solve.simple import preonly, richardson
from tpusparse_torch.sparse.padded import crop_field, pad_field
from test_torch_amg import port_copy

N = 10
P = functools.partial
# name -> (JAX solver, port solver); restart 8 makes GMRES restart
SOLVERS = {
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
    """The pinned f64 Poisson system at N^3 in both packages, with Jacobi
    as the preconditioner (negative definite, as A: MINRES negates it)."""
    jop, jb, _ = j_poisson_stencil_device(JGrid3D(N, N, N))
    op, b, _ = poisson_stencil_device(Grid3D(N, N, N), device="cpu")
    return (jop, jb, lambda r: r / jop.diag), (op, b, lambda r: r / op.diag)


@pytest.mark.parametrize("name", list(SOLVERS))
def test_ksp_matches_jax(systems, name):
    """Same reason, same iterations and the same iterate: in f64 the two
    packages differ only in summation order (x to 1e-9 of its range; the
    final residual, ~1e-8 of ||b|| and formed by cancellation, to 1e-12 of
    ||b||)."""
    (jop, jb, jm), (op, b, m) = systems
    j_solve, solve = SOLVERS[name]
    kw = dict(rtol=1e-8, maxiter=60)
    want = j_solve(jop.mv, jb, m_mv=jm, **kw)
    got = solve(op.mv, b, m_mv=m, **kw)
    assert got.reason == int(want.reason)
    assert got.iters == int(want.iters)
    x_want = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), x_want, rtol=0, atol=1e-9 * np.abs(x_want).max())
    assert abs(got.resnorm - float(want.resnorm)) <= 1e-12 * got.bnorm
    assert got.bnorm == pytest.approx(float(want.bnorm), rel=1e-12)


def test_reasons_cover_rtol_and_its(systems):
    """The fixture's cases end on both sides, converged (bcgs, preonly) and
    out of iterations (the Jacobi-preconditioned rest at 60), so
    test_ksp_matches_jax holds both branches."""
    (jop, jb, jm), _ = systems
    reasons = {
        name: int(j(jop.mv, jb, m_mv=jm, rtol=1e-8, maxiter=60).reason)
        for name, (j, _p) in SOLVERS.items()
    }
    assert reasons["bcgs"] == reasons["preonly"] == ConvergedReason.CONVERGED_RTOL
    assert reasons["gmres"] == reasons["richardson"] == ConvergedReason.DIVERGED_ITS


@pytest.mark.parametrize(
    "name, kw",
    [("bcgs", dict(atol=1e3, rtol=0.0)), ("gmres", dict(maxiter=3)),
     ("chebyshev", dict(maxiter=2)), ("minres", dict(divtol=1e-3))],
)
def test_ksp_reasons_match_jax(systems, name, kw):
    (jop, jb, jm), (op, b, m) = systems
    j_solve, solve = SOLVERS[name]
    want = j_solve(jop.mv, jb, m_mv=jm, **kw)
    got = solve(op.mv, b, m_mv=m, **kw)
    assert got.reason == int(want.reason) != ConvergedReason.ITERATING
    assert got.iters == int(want.iters)


def test_pipecg_f64_scalars_on_f32_system():
    """The mixed-precision configuration of ``_pick_ksp``: f32 vectors and
    dots, f64 recurrence scalars, replacement every 5.  In f32 the last
    iterate carries the dots' summation order: iterations within 1; at
    rtol 1e-5 the error of x is ~1e-2 of its range (the condition number
    times rtol), so x is held to 3e-2 of its range."""
    jop, jb, _ = j_poisson_stencil_device(JGrid3D(N, N, N), dtype=np.float32)
    op, b, _ = poisson_stencil_device(Grid3D(N, N, N), dtype=torch.float32, device="cpu")
    want = j_cg_pipelined(
        jop.mv, jb, rtol=1e-5, m_mv=lambda r: r / jop.diag,
        scalar_dtype=jnp.float64, replace_every=5,
    )
    got = _pick_ksp("pipecg")(op.mv, b, rtol=1e-5, m_mv=lambda r: r / op.diag)
    assert got.reason == int(want.reason) == ConvergedReason.CONVERGED_RTOL
    assert abs(got.iters - int(want.iters)) <= 1
    x_want = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), x_want, rtol=0, atol=3e-2 * np.abs(x_want).max())


def test_minres_reports_an_indefinite_preconditioner(systems):
    _, (op, b, _m) = systems
    flip = torch.ones_like(b)
    flip[: N // 2] = -1.0
    res = minres(op.mv, b, m_mv=lambda r: flip * r, maxiter=50)
    assert res.reason == ConvergedReason.DIVERGED_NANORINF


def test_pick_ksp_names_every_method():
    for name in ("cg", *SOLVERS):
        assert callable(_pick_ksp(name))
    with pytest.raises(ValueError):
        _pick_ksp("lsqr")


def _shared_hierarchy(n, smoother, degree):
    """The f64 system, f32 padded operator and a GAMG hierarchy at n^3 in
    both packages: the JAX setup copied into the port, coarse stacks cast
    to bf16 by each package."""
    jop, jb, jexact = j_poisson_stencil_device(JGrid3D(n, n, n))
    jop32 = JPaddedStar.from_star(j_poisson_stencil_device(JGrid3D(n, n, n), dtype=np.float32)[0])
    jh = j_gamg_setup(jop32, JAMGParams(smoother=smoother, degree=degree))
    ph = cast_coarse_coefs(port_copy(jh))
    op, b, exact = poisson_stencil_device(Grid3D(n, n, n), device="cpu")
    return (jop, jb, jexact, jop32, j_cast_coarse_coefs(jh)), (op, b, exact, ph)


@pytest.mark.parametrize("dots", [True, False])
@pytest.mark.parametrize("smoother", ["richardson", "chebyshev"])
def test_degree1_cycle_cg_counts_match_jax(smoother, dots):
    """One inner CG solve preconditioned by the degree-1 fused cycle (K6/K7
    with their dots, or K6'/K7' without) on a shared hierarchy: the same
    iteration count as the JAX package's at three tolerances.  A swapped
    scalar slot still converges, only more slowly: the counts catch it."""
    (_, jb, _, jop32, jh), (_, b, _, ph) = _shared_hierarchy(12, smoother, 1)
    r = np.asarray(jb, np.float32) / np.float32(np.linalg.norm(np.asarray(jb)))
    jr, pr = j_pad_field(jnp.asarray(r)), pad_field(torch.tensor(r))
    if dots:
        jkw = dict(m_mv_dots=lambda v: j_vcycle_fused_dots(jh, v), a_mv_dot=jop32.mv_dot)
        kw = dict(m_mv_dots=lambda v: vcycle_fused_dots(ph, v), a_mv_dot=ph.levels[0].op.mv_dot)
    else:
        jkw = dict(m_mv=lambda v: j_vcycle_fused(jh, v))
        kw = dict(m_mv=lambda v: vcycle_fused(ph, v))
    for rtol in (1e-5, 1e-6, 1e-7):
        want = j_cg(jop32.mv, jr, rtol=rtol, maxiter=200, **jkw)
        got = cg(ph.levels[0].op.mv, pr, rtol=rtol, maxiter=200, **kw)
        assert got.reason == int(want.reason) == ConvergedReason.CONVERGED_RTOL
        assert got.iters == int(want.iters)


@pytest.mark.parametrize("name", list(SOLVERS))
def test_refined_non_cg_over_dot_free_cycle_matches_jax(name):
    """cg_refined with each non-CG inner method over the dot-free fused
    cycle (Chebyshev(2): K3'/K4' on the card) on a shared hierarchy at 12^3
    and rtol 1e-8: the same reason and outer count, inner within 1 (f32
    dots in another order move the last inner solve), the history's
    ||b|| to 1e-6 and each later sweep within a factor 2 (a sweep's true
    residual is whatever the inner solve left below its tolerance, and
    moves with its rounding by up to 50% here), x to 1e-6 of its range."""
    n, shape = 12, (12, 12, 12)
    j_solve, solve = SOLVERS[name]
    if name == "pipecg":  # the mixed-precision configuration of _pick_ksp
        j_solve = P(j_cg_pipelined, scalar_dtype=jnp.float64, replace_every=5)
        solve = _pick_ksp("pipecg")
    (jop, jb, jexact, jop32, jh), (op, b, exact, ph) = _shared_hierarchy(n, "chebyshev", 2)
    want, whist = j_cg_refined(
        jop.mv, jop32.mv, jb, rtol=1e-8, atol=1e-12,
        m_lo_mv=lambda r: j_vcycle_fused(jh, r), solver=j_solve, history=True,
        encode=j_pad_field, decode=functools.partial(j_crop_field, shape=shape),
    )
    kernels.reset_launches()
    got, hist = cg_refined(
        op.mv, ph.levels[0].op.mv, b, rtol=1e-8, atol=1e-12,
        m_lo_mv=lambda r: vcycle_fused(ph, r), solver=solve, history=True,
        encode=pad_field, decode=functools.partial(crop_field, shape=shape),
    )
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # CPU: twins only
    assert (got.outer_iters, got.reason) == (int(want.outer_iters), int(want.reason))
    assert abs(got.iters - int(want.iters)) <= 1
    assert len(hist) == got.outer_iters + 1
    whist = np.asarray(whist)[: len(hist)]
    assert hist[0] == pytest.approx(float(whist[0]), rel=1e-6)
    assert np.all((0.5 < hist / whist) & (hist / whist < 2.0))
    x_want = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), x_want, rtol=0, atol=1e-6 * np.abs(x_want).max())

"""Krylov parity at 24^3: the port's ``cg`` and ``cg_refined`` against the
JAX package's, on the same systems and (for the refined solve) the same
AMG hierarchy."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.amg.fused_cycle import vcycle_fused_dots as j_vcycle_fused_dots
from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.amg.hierarchy import cast_coarse_coefs as j_cast_coarse_coefs
from tpusparse.amg.hierarchy import gamg_setup as j_gamg_setup
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import poisson_stencil_device as j_poisson_stencil_device
from tpusparse.solve.cg import cg as j_cg
from tpusparse.solve.refine import cg_refined as j_cg_refined
from tpusparse.sparse.padded import PaddedStar as JPaddedStar
from tpusparse.sparse.padded import crop_field as j_crop_field
from tpusparse.sparse.padded import pad_field as j_pad_field
from tpusparse_torch.amg.fused_cycle import vcycle_fused_dots
from tpusparse_torch.amg.hierarchy import cast_coarse_coefs
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil_device
from tpusparse_torch.solve.cg import ConvergedReason, cg
from tpusparse_torch.solve.refine import cg_refined
from tpusparse_torch.sparse.padded import PaddedStar, crop_field, pad_field
from test_torch_amg import port_copy

N = 24
SHAPE = (N, N, N)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def systems():
    jop, jb, _ = j_poisson_stencil_device(JGrid3D(N, N, N))
    op, b, _ = poisson_stencil_device(Grid3D(N, N, N), device="cpu")
    return (jop, jb), (op, b)


@pytest.mark.parametrize("pc", ["none", "jacobi"])
def test_cg_matches_jax(systems, pc):
    (jop, jb), (op, b) = systems
    jm = (lambda r: r / jop.diag) if pc == "jacobi" else None
    m = (lambda r: r / op.diag) if pc == "jacobi" else None
    want = j_cg(jop.mv, jb, rtol=1e-8, m_mv=jm, maxiter=2000)
    got = cg(op.mv, b, rtol=1e-8, m_mv=m, maxiter=2000)
    assert got.reason == int(want.reason) == ConvergedReason.CONVERGED_RTOL
    assert got.iters == int(want.iters)
    # the last recurrence residuals carry the dots' summation order
    assert got.resnorm <= 1e-8 * got.bnorm and float(want.resnorm) <= 1e-8 * got.bnorm
    x_want = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), x_want, atol=1e-7 * np.abs(x_want).max())


@pytest.mark.parametrize(
    "kw, reason",
    [({"maxiter": 3}, ConvergedReason.DIVERGED_ITS),
     ({"atol": 1e3, "rtol": 0.0}, ConvergedReason.CONVERGED_ATOL)],
)
def test_cg_reasons_match_jax(systems, kw, reason):
    (jop, jb), (op, b) = systems
    want = j_cg(jop.mv, jb, **kw)
    got = cg(op.mv, b, **kw)
    assert got.reason == int(want.reason) == reason
    assert got.iters == int(want.iters)


def test_cg_reports_nan(systems):
    _, (op, b) = systems
    bad = b.clone()
    bad[3, 4, 5] = float("nan")
    assert cg(op.mv, bad).reason == ConvergedReason.DIVERGED_NANORINF


def test_cg_fused_mv_dot_matches_plain():
    op = PaddedStar.from_star(
        poisson_stencil_device(Grid3D(N, N, N), dtype=torch.float32, device="cpu")[0]
    )
    b = pad_field(torch.tensor(np.random.default_rng(4).standard_normal(SHAPE, dtype=np.float32)))
    plain = cg(op.mv, b, rtol=1e-6, maxiter=500)
    fused = cg(op.mv, b, rtol=1e-6, maxiter=500, a_mv_dot=op.mv_dot)
    assert plain.converged() and fused.converged()
    assert abs(plain.iters - fused.iters) <= 1


def test_cg_refined_with_fused_cycle_matches_jax():
    """Same hierarchy in both packages (copied from JAX, coarse stacks cast
    to bf16 by each package): same inner and outer counts and reason."""
    jop, jb, jexact = j_poisson_stencil_device(JGrid3D(N, N, N))
    jop32 = JPaddedStar.from_star(j_poisson_stencil_device(JGrid3D(N, N, N), dtype=np.float32)[0])
    jh = j_gamg_setup(jop32, JAMGParams())
    ph = cast_coarse_coefs(port_copy(jh))
    jh = j_cast_coarse_coefs(jh)
    want = j_cg_refined(
        jop.mv, jop32.mv, jb, rtol=1e-8, atol=1e-12,
        m_lo_mv_dots=lambda r: j_vcycle_fused_dots(jh, r),
        a_lo_mv_dot=jop32.mv_dot, encode=j_pad_field,
        decode=functools.partial(j_crop_field, shape=SHAPE),
    )
    op, b, exact = poisson_stencil_device(Grid3D(N, N, N), device="cpu")
    op32 = ph.levels[0].op
    got = cg_refined(
        op.mv, op32.mv, b, rtol=1e-8, atol=1e-12,
        m_lo_mv_dots=lambda r: vcycle_fused_dots(ph, r),
        a_lo_mv_dot=op32.mv_dot, encode=pad_field,
        decode=functools.partial(crop_field, shape=SHAPE),
    )
    assert (got.iters, got.outer_iters, got.reason) == (
        int(want.iters), int(want.outer_iters), int(want.reason)
    )
    assert got.x.dtype == torch.float64
    linf = (got.x - exact).abs().max().item()
    assert linf == pytest.approx(float(jnp.abs(want.x - jexact).max()), abs=1e-6)


@pytest.mark.parametrize(
    "kw, reason",
    [({"max_outer": 1, "rtol": 1e-14}, ConvergedReason.DIVERGED_ITS),
     ({"atol": 1e6}, ConvergedReason.CONVERGED_ATOL)],
)
def test_cg_refined_reasons_match_jax(systems, kw, reason):
    (jop, jb), (op, b) = systems
    want = j_cg_refined(jop.mv, lambda v: jop.mv(v.astype(jnp.float64)).astype(jnp.float32), jb,
                        inner_maxiter=5, **kw)
    got = cg_refined(op.mv, lambda v: op.mv(v.double()).float(), b, inner_maxiter=5, **kw)
    assert got.reason == int(want.reason) == reason
    assert (got.iters, got.outer_iters) == (int(want.iters), int(want.outer_iters))


@pytest.mark.parametrize("norm_type", ["unpreconditioned", "preconditioned", "none"])
def test_cg_norm_type_matches_jax(systems, norm_type):
    """-ksp_norm_type in cg (f64, Jacobi): the preconditioned norm
    sqrt(|<r, z>|) gated at rtol ||b||_2, and "none" running maxiter
    iterations to CONVERGED_ITS; counts, reasons and norms JAX's."""
    (jop, jb), (op, b) = systems
    maxiter = 7 if norm_type == "none" else 2000
    want = j_cg(jop.mv, jb, rtol=1e-8, m_mv=lambda r: r / jop.diag, maxiter=maxiter, norm_type=norm_type)
    got = cg(op.mv, b, rtol=1e-8, m_mv=lambda r: r / op.diag, maxiter=maxiter, norm_type=norm_type)
    assert (got.iters, got.reason) == (int(want.iters), int(want.reason))
    assert got.resnorm == pytest.approx(float(want.resnorm), rel=1e-6)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-8 * np.abs(got.x.numpy()).max())
    if norm_type == "none":
        assert (got.iters, got.reason) == (7, ConvergedReason.CONVERGED_ITS)
    else:
        assert got.reason == ConvergedReason.CONVERGED_RTOL
    with pytest.raises(ValueError, match="norm_type"):
        cg(op.mv, b, norm_type="natural")


def test_cg_norm_none_reports_nan(systems):
    """Under "none" a non-finite norm still ends the solve."""
    _, (op, b) = systems
    got = cg(lambda x: op.mv(x) * float("nan"), b, maxiter=5, norm_type="none")
    assert got.reason == ConvergedReason.DIVERGED_NANORINF


@pytest.mark.parametrize("norm_type, kw", [
    ("preconditioned", dict(precision="f64")),
    ("none", dict(precision="f64", maxiter=9)),
    ("preconditioned", dict(layout="padded")),
])
def test_solve_poisson_ksp_norm_type_matches_jax(norm_type, kw):
    """solve_poisson's ksp_norm_type (CG's norm_type on the stencil route,
    JAX's driver:317/:369): uniform f64 and the padded mixed route, where
    CG keeps the fused <p, Ap> and the dot-fused cycle."""
    from tpusparse.bench.driver import solve_poisson as j_solve_poisson
    from tpusparse_torch.bench.driver import _pick_ksp, solve_poisson

    common = dict(rtol=1e-8, atol=1e-12, warmup=False, ksp_norm_type=norm_type, **kw)
    want = j_solve_poisson(16, **common)
    got = solve_poisson(16, device="cpu", **common)
    assert (got.reason, got.outer_iters) == (want.reason, want.outer_iters)
    assert got.reason > 0
    assert abs(got.iters - want.iters) <= (0 if kw.get("precision") == "f64" else 1)
    assert abs(got.linf_error - want.linf_error) < 1e-6
    if norm_type == "none":
        assert (got.iters, got.reason) == (9, ConvergedReason.CONVERGED_ITS)
    assert _pick_ksp("cg", ksp_norm_type=norm_type).keywords == {"norm_type": norm_type}
    assert _pick_ksp("cg", ksp_norm_type="unpreconditioned") is cg

"""Block multi-RHS solves: the port's ``solve/multi.py`` (masked per-column
CG and defect correction) and ``KSP.mat_solve`` against the JAX package's
on the same inputs, the batched K1p's twin against ``jax.vmap`` of the
star, and the plain levels' stack forms (``VarStencil27.mv``, the
transfers, the V-cycle with every smoother and coarse solve, block
Jacobi) against their single-field forms column by column."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse import KSP as JKSP
from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.amg.hierarchy import gamg_setup as j_gamg_setup
from tpusparse.amg.hierarchy import vcycle as j_vcycle
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import poisson_dia_device as j_poisson_dia_device
from tpusparse.grid.poisson import poisson_stencil_device as j_poisson_stencil_device
from tpusparse.solve.multi import cg_multi as j_cg_multi
from tpusparse.solve.multi import refined_multi as j_refined_multi
from tpusparse_torch import KSP, Grid3D, kernels
from tpusparse_torch.amg.hierarchy import AMGParams, gamg_setup, vcycle
from tpusparse_torch.grid.poisson import poisson_dia_device, poisson_stencil_device
from tpusparse_torch.kernels.stencil7 import star7_mv, star7_mv_batched, star7_mv_torch
from tpusparse_torch.solve import cg, cg_multi, cg_refined, refined_multi
from tpusparse_torch.solve.bjacobi import BlockJacobi, PCRLineJacobi
from tpusparse_torch.solve.cg import ConvergedReason
from tpusparse_torch.sparse.stencil import StarStencil3D
from tpusparse_torch.sparse.varstencil import VarStencil27
from torch_parity import port_copy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _systems(n, dtype=torch.float64):
    """The pinned Poisson system at n^3 in both packages: (JAX op, b), (op, b)."""
    jop, jb, _ = j_poisson_stencil_device(JGrid3D(n, n, n))
    op, b, _ = poisson_stencil_device(Grid3D(n, n, n), device="cpu", dtype=dtype)
    return (jop, jb), (op, b)


def _cols(b, lib):
    """Columns of different difficulty: b, 3b and b + 0.1 sin(7b)."""
    return lib.stack([b, 3.0 * b, b + 0.1 * lib.sin(7.0 * b)])


@pytest.mark.parametrize("batched", [True, False])
def test_cg_multi_matches_jax_and_single_columns(batched):
    """Uniform f64 block CG with Jacobi: per-column iterations and reasons
    equal to JAX's and to the port's own single-column cg, x to 1e-10."""
    (jop, jb), (op, b) = _systems(12)
    jcols, cols = _cols(jb, jnp), _cols(b, torch)
    want = j_cg_multi(jop.mv, jcols, rtol=1e-9, m_mv=lambda r: r / jop.diag, maxiter=2000)
    got = cg_multi(op.mv, cols, rtol=1e-9, m_mv=lambda r: r / op.diag, maxiter=2000, batched_ops=batched)
    assert got.iters.tolist() == np.asarray(want.iters).tolist()
    assert got.reason.tolist() == np.asarray(want.reason).tolist() == [2, 2, 2]
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-10)
    for i in range(3):
        single = cg(op.mv, cols[i], rtol=1e-9, m_mv=lambda r: r / op.diag, maxiter=2000)
        assert int(got.iters[i]) == single.iters and int(got.reason[i]) == single.reason
        assert (got.x[i] - single.x).abs().max().item() < 1e-10


def test_cg_multi_frozen_columns_do_not_drift():
    """A zero column converges at iteration 0 and stays frozen (exactly
    zero, no NaN) while the other iterates, in both packages."""
    (jop, jb), (op, b) = _systems(12)
    want = j_cg_multi(jop.mv, jnp.stack([jnp.zeros_like(jb), jb]), rtol=1e-9, maxiter=2000)
    got = cg_multi(op.mv, torch.stack([torch.zeros_like(b), b]), rtol=1e-9, maxiter=2000, batched_ops=True)
    assert got.iters.tolist() == np.asarray(want.iters).tolist()
    assert got.reason.tolist() == np.asarray(want.reason).tolist()
    assert int(got.iters[0]) == 0 and got.x[0].abs().max().item() == 0.0
    assert bool(torch.isfinite(got.x).all()) and got.reason[1] > 0 and got.iters[1] > 0


def test_cg_multi_per_column_tolerances_and_iteration_limit():
    """Per-column rtol and the iteration limit, as JAX classifies them."""
    (jop, jb), (op, b) = _systems(12)
    rtol = [1e-3, 1e-9]
    want = j_cg_multi(jop.mv, jnp.stack([jb, jb]), rtol=jnp.asarray(rtol), maxiter=25)
    got = cg_multi(op.mv, torch.stack([b, b]), rtol=rtol, maxiter=25, batched_ops=True)
    assert got.iters.tolist() == np.asarray(want.iters).tolist()
    assert got.reason.tolist() == np.asarray(want.reason).tolist()
    assert got.reason.tolist() == [ConvergedReason.CONVERGED_RTOL, ConvergedReason.DIVERGED_ITS]


def _f32(op):
    return StarStencil3D(diag=op.diag.float(), cx=op.cx, cy=op.cy, cz=op.cz, pinned=op.pinned)


def _j_f32(jop):
    return jax.tree.map(
        lambda v: v.astype(jnp.float32) if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.floating) else v,
        jop,
    )


def test_refined_multi_matches_jax_and_single():
    """Mixed-precision block defect correction with Jacobi: outer count and
    reason equal to JAX's and to the port's cg_refined per column, inner
    within 1 (f32 summation order), x to 1e-6 relative."""
    (jop, jb), (op, b) = _systems(12)
    jlo, lo = _j_f32(jop), _f32(op)
    want = j_refined_multi(jop.mv, jlo.mv, jnp.stack([jb, -2.0 * jb]), rtol=1e-9, atol=1e-30,
                           m_lo_mv=lambda r: r / jlo.diag)
    cols = torch.stack([b, -2.0 * b])
    got = refined_multi(op.mv, lo.mv, cols, rtol=1e-9, atol=1e-30, m_lo_mv=lambda r: r / lo.diag,
                        batched_ops=True)
    assert got.outer_iters.tolist() == np.asarray(want.outer_iters).tolist()
    assert got.reason.tolist() == np.asarray(want.reason).tolist()
    assert all(r > 0 for r in got.reason.tolist())
    assert np.abs(got.iters.numpy() - np.asarray(want.iters)).max() <= 1
    wx = np.asarray(want.x)
    assert np.abs(got.x.numpy() - wx).max() <= 1e-6 * np.abs(wx).max()
    for i in range(2):
        single = cg_refined(op.mv, lo.mv, cols[i], rtol=1e-9, atol=1e-30, m_lo_mv=lambda r: r / lo.diag)
        assert int(got.outer_iters[i]) == single.outer_iters and int(got.reason[i]) == single.reason
        assert (got.x[i] - single.x).abs().max().item() <= 1e-8 * single.x.abs().max().item()


def test_refined_multi_blowup_reports_dtol():
    """A diverging column reports DIVERGED_DTOL (dtol outranks the stall),
    the other converges, as in the JAX package, in as many sweeps.  The
    converged column's reason is not compared: its f32 inner CG on the
    unpreconditioned 32 x 32 system takes 32 iterations in JAX and 37 in
    the port (summation order), so its last sweep ends below atol in one
    (CONVERGED_ATOL) and between atol and rtol ||b|| in the other."""
    n = 32
    rng = np.random.default_rng(1)
    s = rng.standard_normal((n, n))
    a_bad = np.eye(n) + 5.0 * (s - s.T)  # nonsymmetric: CG blows up
    lap = np.diag(2.0 * np.ones(n)) - np.diag(np.ones(n - 1), 1) - np.diag(np.ones(n - 1), -1) + 0.1 * np.eye(n)
    a_hi = np.stack([lap, a_bad])
    b = np.stack([lap @ np.ones(n), rng.standard_normal(n)])
    ja, jb = jnp.asarray(a_hi), jnp.asarray(b)
    want = j_refined_multi(
        lambda v: jnp.einsum("kij,kj->ki", ja, v), lambda v: jnp.einsum("kij,kj->ki", ja.astype(jnp.float32), v),
        jb, rtol=1e-10, atol=1e-12, max_outer=40, batched_ops=True,
    )
    ta = torch.tensor(a_hi)
    got = refined_multi(
        lambda v: torch.einsum("kij,kj->ki", ta, v), lambda v: torch.einsum("kij,kj->ki", ta.float(), v),
        torch.tensor(b), rtol=1e-10, atol=1e-12, max_outer=40, batched_ops=True,
    )
    reasons, want_reasons = got.reason.tolist(), np.asarray(want.reason).tolist()
    assert reasons[0] > 0 and want_reasons[0] > 0
    assert reasons[1] in (ConvergedReason.DIVERGED_DTOL, ConvergedReason.DIVERGED_NANORINF)
    assert reasons[1] == want_reasons[1]
    assert got.outer_iters.tolist() == np.asarray(want.outer_iters).tolist()


@pytest.mark.parametrize("pinned", [True, False])
def test_batched_twin_matches_jax_vmap(pinned):
    """star7_mv_batched's twin (star7_mv_torch on a stack) against the JAX
    star's apply vmapped over the columns; k = 1 bit for bit K1p's twin on
    its one field."""
    shape, k = (7, 5, 9), 3
    jop = j_poisson_stencil_device(JGrid3D(shape[2], shape[1], shape[0]), pin=pinned, dtype=jnp.float32)[0]
    op = poisson_stencil_device(Grid3D(shape[2], shape[1], shape[0]), pin=pinned, dtype=torch.float32,
                                device="cpu")[0]
    x = np.random.default_rng(3).standard_normal((k, *shape), dtype=np.float32)
    want = np.asarray(jax.vmap(dataclasses.replace(jop, backend="xla").mv)(jnp.asarray(x)))
    kernels.reset_launches()
    got = star7_mv_batched(op.diag, op.cx, op.cy, op.cz, torch.tensor(x), pinned)
    assert kernels.LAUNCHES["star7_mv_batched"] == 0  # CPU tensors run the twin
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    one = star7_mv_torch(op.diag, op.cx, op.cy, op.cz, torch.tensor(x[:1]), pinned)
    assert torch.equal(one[0], star7_mv(op.diag, op.cx, op.cy, op.cz, torch.tensor(x[0]), pinned))
    # StarStencil3D.mv takes the stack (f32: the batched K1p) and refuses a wrong grid
    assert torch.equal(op.mv(torch.tensor(x)), got)
    with pytest.raises(ValueError, match="stack"):
        op.mv(torch.tensor(x)[:, :-1])


def test_batched_wrapper_refuses_bad_operands():
    diag = torch.ones(4, 3, 5)
    with pytest.raises(ValueError):
        star7_mv_batched(diag, 1.0, 1.0, 1.0, torch.ones(4, 3, 5), True)   # no column axis
    with pytest.raises(ValueError):
        star7_mv_batched(diag, 1.0, 1.0, 1.0, torch.ones(0, 4, 3, 5), True)   # no column
    with pytest.raises(TypeError):
        star7_mv_batched(diag.double(), 1.0, 1.0, 1.0, torch.ones(2, 4, 3, 5).double(), True)
    with pytest.raises(ValueError, match="contiguous"):
        star7_mv_batched(diag, 1.0, 1.0, 1.0, torch.ones(4, 3, 5, 2).permute(3, 0, 1, 2), True)


def test_varstencil_and_transfer_take_stacks():
    """The 27-point coarse apply and the transfers on a stack equal their
    single-field forms column by column, bit for bit."""
    rng = np.random.default_rng(5)
    shape = (7, 6, 8)
    vs = VarStencil27(coef=torch.tensor(rng.standard_normal((27, *shape), dtype=np.float32)))
    x = torch.tensor(rng.standard_normal((3, *shape), dtype=np.float32))
    y = vs.mv(x)
    assert all(torch.equal(y[c], vs.mv(x[c])) for c in range(3))
    _, (op, _) = _systems(12, torch.float32)
    tr = gamma_free_transfer(op)
    e = torch.tensor(rng.standard_normal((3, *tr.c_shape), dtype=np.float32))
    r = torch.tensor(rng.standard_normal((3, 12, 12, 12), dtype=np.float32))
    up, down = tr.t_apply(e), tr.tT_apply(r)
    assert all(torch.equal(up[c], tr.t_apply(e[c])) and torch.equal(down[c], tr.tT_apply(r[c])) for c in range(3))


def gamma_free_transfer(op):
    """The fine level's transfer of the port's hierarchy on ``op``."""
    return gamg_setup(op, AMGParams()).levels[0].transfer


# the plain cycle's smoother and coarse-solve options (test_torch_smoothers'
# set): each cycled on a stack against the single-field cycle, and against
# JAX's cycle vmapped over the stack on the same hierarchy
CYCLES = {
    "chebyshev": AMGParams(),
    "richardson": AMGParams(smoother="richardson", degree=3),
    "sor": AMGParams(smoother="sor"),
    "lu": AMGParams(coarse_solve="lu"),
    "bjacobi": AMGParams(bjacobi_bs=4),
    "xline": AMGParams(bjacobi_bs=12),
}


@pytest.mark.parametrize("name", list(CYCLES))
@pytest.mark.parametrize("gamma", [1, 2])
def test_vcycle_takes_a_stack(name, gamma):
    params = CYCLES[name]
    (jop, _), (op, _) = _systems(12, torch.float32)
    jp = JAMGParams(**{f: getattr(params, f) for f in ("smoother", "degree", "coarse_solve", "bjacobi_bs")})
    jh = j_gamg_setup(_j_f32(jop), jp)
    hier = port_copy(jh)
    r = np.random.default_rng(2).standard_normal((3, 12, 12, 12), dtype=np.float32)
    got = vcycle(hier, torch.tensor(r), gamma=gamma)
    for c in range(3):
        one = vcycle(hier, torch.tensor(r[c]), gamma=gamma)
        torch.testing.assert_close(got[c], one, rtol=1e-5, atol=1e-6 * one.abs().max().item())
    want = np.asarray(jax.vmap(lambda v: j_vcycle(jh, v, gamma=gamma))(jnp.asarray(r)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bs", [4, 12])
def test_block_jacobi_applies_take_stacks(bs, monkeypatch):
    """BlockJacobi (dense blocks) and PCRLineJacobi (the x-line solve past
    the dense cap) on a stack equal their single-field applies."""
    _, (op, _) = _systems(12, torch.float32)
    bands = {o: f for o, f in op.flat_band_fields(bs).items() if abs(o) == 1}
    dense = BlockJacobi.from_bands(op.diag, bands, bs)
    monkeypatch.setattr(BlockJacobi, "DENSE_ENTRY_CAP", 0)
    pcr = BlockJacobi.from_bands(op.diag, bands, bs)
    assert isinstance(dense, BlockJacobi) and isinstance(pcr, PCRLineJacobi)
    r = torch.tensor(np.random.default_rng(4).standard_normal((3, 12, 12, 12), dtype=np.float32))
    for pc in (dense, pcr):
        z = pc.apply(r)
        assert z.shape == r.shape
        for c in range(3):
            torch.testing.assert_close(z[c], pc.apply(r[c]), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def mat_solves():
    """KSP.mat_solve at 16^3 in both packages: the port's default (padded)
    KSP against JAX's KSP(layout="padded"); both run the plain twin
    hierarchy."""
    (jop, jb), (op, b) = _systems(16)
    jk = JKSP(rtol=1e-8, layout="padded").set_operators(jop)
    want = jk.mat_solve(jnp.stack([jb, 5.0 * jb, -jb]))
    ksp = KSP(rtol=1e-8).set_operators(op)
    got = ksp.mat_solve(torch.stack([b, 5.0 * b, -b]))
    return want, got, ksp, b


def test_ksp_mat_solve_matches_jax(mat_solves):
    want, got, _, _ = mat_solves
    assert got.all_converged() and want.all_converged()
    assert got.outer_iters.tolist() == np.asarray(want.outer_iters).tolist()
    assert got.reason.tolist() == np.asarray(want.reason).tolist()
    assert np.abs(got.iters.numpy() - np.asarray(want.iters)).max() <= 1
    wx = np.asarray(want.x)
    assert np.abs(got.x.numpy() - wx).max() <= 1e-6 * np.abs(wx).max()


def test_ksp_mat_solve_structured(mat_solves):
    """Manufactured-solution accuracy on column 0, column 1 = 5 x column 0,
    a column = the plain route's solve of it (outer count and x; at 16^3
    the plain route's inner count follows the first sweep's rounding, 15
    or 19: ROADMAP section 3), and flat blocks in -> flat blocks out."""
    _, got, ksp, b = mat_solves
    exact = poisson_stencil_device(Grid3D(16, 16, 16), device="cpu")[2]
    assert (got.x[0] - exact).abs().max().item() < 2e-1
    assert (got.x[1] - 5.0 * got.x[0]).abs().max().item() <= 1e-5 * got.x[1].abs().max().item()
    single = KSP(rtol=1e-8, layout="plain").set_operators(ksp._op).solve(b)
    assert int(got.outer_iters[0]) == single.outer_iters
    assert (got.x[0] - single.x).abs().max().item() <= 1e-6 * single.x.abs().max().item()
    flat = ksp.mat_solve(torch.stack([b, 5.0 * b]).reshape(2, -1))
    assert flat.x.shape == (2, 16**3)
    assert torch.equal(flat.x[0].reshape(b.shape), ksp.mat_solve(b[None]).x[0])


@pytest.mark.parametrize("pc", ["jacobi", "none"])
def test_ksp_mat_solve_uniform_matches_jax(pc):
    """Uniform f64 mat_solve with a standalone PC: cg_multi's counts equal
    JAX's."""
    (jop, jb), (op, b) = _systems(12)
    want = JKSP(rtol=1e-8, precision="f64", pc_type=pc).set_operators(jop).mat_solve(jnp.stack([jb, -jb]))
    got = KSP(rtol=1e-8, precision="f64", pc_type=pc).set_operators(op).mat_solve(torch.stack([b, -b]))
    assert got.iters.tolist() == np.asarray(want.iters).tolist()
    assert got.reason.tolist() == np.asarray(want.reason).tolist() == [2, 2]
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-10)


def test_ksp_mat_solve_requires_cg():
    (jop, jb), (op, b) = _systems(12)
    with pytest.raises(ValueError, match="mat_solve"):
        JKSP(ksp_type="gmres", rtol=1e-6).set_operators(jop).mat_solve(jnp.stack([jb]))
    with pytest.raises(ValueError, match="mat_solve"):
        KSP(ksp_type="gmres", rtol=1e-6).set_operators(op).mat_solve(torch.stack([b]))


def test_ksp_mat_solve_on_dia_needs_a_batched_k5():
    """mat_solve on the DIA family (the f32 level applies on the batched
    K5's twin, dia_mv_torch over the stack): JAX's outer counts and
    reasons, inner within 1, x to 1e-6, and each column the single solve
    of it (same counts, x to 1e-6)."""
    jhi, jlo, jb, _ = j_poisson_dia_device(JGrid3D(12, 12, 12))
    want = JKSP(rtol=1e-8).set_operators(jhi, jlo).mat_solve(jnp.stack([jb, -2.0 * jb]))
    op_hi, op_lo, b, _ = poisson_dia_device(Grid3D(12, 12, 12), device="cpu")
    ksp = KSP(rtol=1e-8).set_operators(op_hi, op_lo)
    got = ksp.mat_solve(torch.stack([b, -2.0 * b]))
    assert got.outer_iters.tolist() == np.asarray(want.outer_iters).tolist()
    assert got.reason.tolist() == np.asarray(want.reason).tolist() == [2, 2]
    assert np.abs(got.iters.numpy() - np.asarray(want.iters)).max() <= 1
    wx = np.asarray(want.x)
    assert np.abs(got.x.numpy() - wx).max() <= 1e-6 * np.abs(wx).max()
    single = ksp.solve(b)
    assert (int(got.iters[0]), int(got.outer_iters[0])) == (single.iters, single.outer_iters)
    assert (got.x[0] - single.x).abs().max().item() <= 1e-6 * single.x.abs().max().item()

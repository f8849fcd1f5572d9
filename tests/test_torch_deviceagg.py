"""The banded device-resident GAMG setup, ``tpusparse_torch/amg/deviceagg.py``,
against the JAX package's ``amg/deviceagg.py`` on the same numpy inputs,
and against an explicit scipy P^T A P over the same segments, on the CPU.
The matrices defeat ``infer_grid3d``: the pinned periodic-wrap chain (its
wrap bands are zero after the pin, so it is numerically a pinned chain;
tests/test_deviceagg.py's matrix), a fourth-order 1-D stencil, and the
61-diagonal band."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse.amg.deviceagg import SegTransfer as JSegTransfer
from tpusparse.amg.deviceagg import _coarsen_once as j_coarsen_once
from tpusparse.amg.deviceagg import _deltas as j_deltas
from tpusparse.amg.deviceagg import coarse_offsets as j_coarse_offsets
from tpusparse.amg.deviceagg import gamg_setup_banded_device as j_setup_banded
from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.amg.hierarchy import vcycle as j_vcycle
from tpusparse.amg.unstructured import gamg_setup_unstructured as j_setup
from tpusparse.solve.refine import cg_refined as j_cg_refined
from tpusparse.sparse.csr import HostCSR as JHostCSR
from tpusparse.sparse.dia import DIA as JDIA
from tpusparse_torch.amg.deviceagg import (
    SegTransfer,
    _coarsen_once,
    _deltas,
    _segsum,
    _upsample,
    coarse_offsets,
    gamg_setup_banded_device,
)
from tpusparse_torch.amg.hierarchy import AMGParams, vcycle
from tpusparse_torch.amg.unstructured import gamg_setup_unstructured
from tpusparse_torch.interop import host_csr_from_numpy
from tpusparse_torch.solve.refine import cg_refined
from tpusparse_torch.sparse.dia import DIA
from torch_parity import port_copy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _periodic_lap1d(n):
    a = sp.diags([2.0, -1.0, -1.0, -1.0, -1.0], [0, 1, -1, n - 1, -(n - 1)], shape=(n, n)).tolil()
    a[0, :] = 0.0
    a[:, 0] = 0.0
    a[0, 0] = 2.0
    return a.tocsr()


def _high_order_1d(n):
    return sp.diags([2.5, -4.0 / 3, -4.0 / 3, 1.0 / 12, 1.0 / 12], [0, 1, -1, 2, -2], shape=(n, n)).tocsr()


def _dias(a, dtype=np.float32):
    """The matrix as a JAX DIA and a port DIA holding the same bands."""
    j = JDIA.from_csr(JHostCSR.from_scipy(a), dtype=dtype)
    return j, DIA(bands=torch.tensor(np.asarray(j.bands)), offsets=j.offsets, shape=j.shape)


def _explicit_p(a, s, omega, nsmooths):
    n = a.shape[0]
    agg = np.arange(n) // s
    t = sp.csr_matrix((np.full(n, 1.0 / np.sqrt(s)), (np.arange(n), agg)), shape=(n, -(-n // s)))
    if nsmooths == 0:
        return t
    return (t - omega * sp.diags(1.0 / a.diagonal()) @ (a @ t)).tocsr()


def test_static_offset_algebra_matches_jax():
    for o in (-7, -1, 0, 1, 2, 5, 13):
        for s in (2, 3, 8):
            assert _deltas(o, s) == j_deltas(o, s)
    offs = (-(2999), -2, -1, 0, 1, 2, 2999)
    for s in (2, 3):
        for k in (0, 1):
            assert coarse_offsets(offs, s, k) == j_coarse_offsets(offs, s, k)


@pytest.mark.parametrize("nsmooths", [0, 1])
@pytest.mark.parametrize("s", [3, 8])
def test_coarsen_once_matches_jax_and_scipy(nsmooths, s):
    n = 500
    a = _periodic_lap1d(n)
    jd, td = _dias(a)
    dinv = (1.0 / a.diagonal()).astype(np.float32)
    omega = np.float32(0.7)
    jcb, jcoffs = j_coarsen_once(jd.bands, jd.offsets, jnp.asarray(dinv), jnp.asarray(omega), s=s, n=n,
                                 nsmooths=nsmooths)
    cb, coffs = _coarsen_once(td.bands, td.offsets, torch.tensor(dinv), float(omega), s=s, n=n,
                              nsmooths=nsmooths)
    assert coffs == jcoffs
    np.testing.assert_allclose(cb.numpy(), np.asarray(jcb), rtol=1e-6, atol=1e-6 * np.abs(np.asarray(jcb)).max())
    p = _explicit_p(a.astype(np.float64), s, float(omega), nsmooths)
    ref = (p.T @ a @ p).toarray()
    n_c = -(-n // s)
    ac = np.zeros((n_c, n_c))
    for i, e in enumerate(coffs):
        r = np.arange(max(0, -e), min(n_c, n_c - e))
        ac[r, r + e] = cb.numpy()[i, r]
    np.testing.assert_allclose(ac, ref, rtol=1e-4, atol=1e-5)


def test_seg_transfer_matches_jax_and_the_explicit_p():
    n, s = 300, 4
    a = _high_order_1d(n)
    jd, td = _dias(a)
    dinv = (1.0 / a.diagonal()).astype(np.float32)
    omega = np.float32(0.65)
    n_c = -(-n // s)
    jt = JSegTransfer(w=jnp.asarray(1.0 / np.sqrt(s), jnp.float32), omega=jnp.asarray(omega), s=s,
                      n_fine=n, n_coarse=n_c)
    tt = SegTransfer(w=float(np.float32(1.0 / np.sqrt(s))), omega=float(omega), s=s, n_fine=n, n_coarse=n_c)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n).astype(np.float32)
    e = rng.standard_normal(n_c).astype(np.float32)
    got_r = tt.restrict(td, torch.tensor(dinv), torch.tensor(v)).numpy()
    got_p = tt.prolong(td, torch.tensor(dinv), torch.tensor(e)).numpy()
    want_r = np.asarray(jt.restrict(jd, jnp.asarray(dinv), jnp.asarray(v)))
    want_p = np.asarray(jt.prolong(jd, jnp.asarray(dinv), jnp.asarray(e)))
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=1e-6 * np.abs(want_r).max())
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-6 * np.abs(want_p).max())
    p = _explicit_p(a, s, float(omega), 1)
    np.testing.assert_allclose(got_r, p.T @ v, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_p, p @ e, rtol=1e-4, atol=1e-4)
    # a tentative transfer (omega 0) skips the smoothing mv: the same values
    t0 = SegTransfer(w=tt.w, omega=0.0, s=s, n_fine=n, n_coarse=n_c)
    j0 = JSegTransfer(w=jt.w, omega=jnp.zeros((), jnp.float32), s=s, n_fine=n, n_coarse=n_c)
    np.testing.assert_array_equal(t0.restrict(td, torch.tensor(dinv), torch.tensor(v)).numpy(),
                                  np.asarray(j0.restrict(jd, jnp.asarray(dinv), jnp.asarray(v))))
    stack = torch.tensor(np.stack([v, 3 * v]))
    assert torch.equal(tt.restrict(td, torch.tensor(dinv), stack)[1],
                       tt.restrict(td, torch.tensor(dinv), stack[1]))


def test_segsum_and_upsample_take_stacks():
    e = torch.arange(6.0).reshape(2, 3)
    up = _upsample(e, 3, 8)
    assert up.shape == (2, 8) and up[1].tolist() == [3, 3, 3, 4, 4, 4, 5, 5]
    assert _segsum(up, 3, 3).tolist() == [[0, 3, 4], [9, 12, 10]]


@pytest.mark.parametrize(
    "case, params",
    [("wrap", {}), ("wrap", dict(nsmooths=0)), ("high", {}), ("band61", {}), ("wrap", dict(coarse_solve="lu"))],
    ids=["wrap", "wrap-tentative", "high-order", "band61", "wrap-lu"],
)
@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_banded_hierarchy_matches_jax_level_by_level(case, params, f64):
    """Sizes, offsets and (f64) rho at rtol 1e-5 and bands at 1e-10; f32
    rho within 1e-3 (the f32 power iteration's rounding on a 1-D chain)."""
    a = {"wrap": _periodic_lap1d(3000), "high": _high_order_1d(3000), "band61": _sp61()}[case]
    dt = np.float64 if f64 else np.float32
    jd, td = _dias(a, dt)
    jh = j_setup_banded(jd, JAMGParams(**params))
    tm = {}
    th = gamg_setup_banded_device(td, AMGParams(**params), timings=tm)
    assert set(tm) == {"rho", "galerkin", "device_put"}
    assert len(th.levels) == len(jh.levels)
    for jl, tl in zip(jh.levels, th.levels):
        assert tl.op.offsets == jl.op.offsets and tl.op.shape == tuple(jl.op.shape)
        if f64:
            assert tl.rho == pytest.approx(float(jl.rho), rel=1e-5)
            np.testing.assert_allclose(tl.op.bands.numpy(), np.asarray(jl.op.bands), rtol=1e-10,
                                       atol=1e-10 * np.abs(np.asarray(jl.op.bands)).max())
        else:
            assert tl.rho == pytest.approx(float(jl.rho), rel=1e-3)
        if jl.transfer is not None:
            assert (tl.transfer.s, tl.transfer.n_coarse) == (jl.transfer.s, jl.transfer.n_coarse)
            assert (tl.transfer.omega == 0.0) == (float(jl.transfer.omega) == 0.0)
    assert (th.levels[-1].coarse_inv is not None) == (params.get("coarse_solve") == "lu")


def _sp61(n=2000):
    offs = list(range(-30, 31))
    return sp.diags([np.full(n - abs(o), 10.0 if o == 0 else -1.0 / (1 + abs(o))) for o in offs], offs,
                    shape=(n, n), format="csr")


def test_one_vcycle_on_a_copy_of_jax_banded_hierarchy():
    a = _periodic_lap1d(3000)
    jd, _ = _dias(a)
    jh = j_setup_banded(jd, JAMGParams())
    th = port_copy(jh)
    r = np.random.default_rng(0).standard_normal(3000).astype(np.float32)
    want = np.asarray(j_vcycle(jh, jnp.asarray(r)))
    got = vcycle(th, torch.tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", ["wrap", "high-order", "explicit-banded"])
def test_banded_solves_match_jax(case):
    """Mixed-precision solves (cg_refined, f64 outer operator) on each
    package's own banded hierarchy: reason and outer count equal, inner
    within 1, the true relative residual within 1e-8, and on the chain x
    within 1e-6 of JAX's; explicit aggregation='banded' from a host CSR
    through gamg_setup_unstructured."""
    n = 3000
    a = _high_order_1d(n) if case != "wrap" else _periodic_lap1d(n)
    x = np.random.default_rng(1).standard_normal(n)
    b = a @ x
    jd, td = _dias(a)
    if case == "explicit-banded":
        ja = JHostCSR.from_scipy(a)
        jh = j_setup(ja, JAMGParams(), dtype=np.float32, aggregation="banded")
        th = gamg_setup_unstructured(host_csr_from_numpy(ja.indptr, ja.indices, ja.data, ja.shape), AMGParams(),
                                     dtype=np.float32, aggregation="banded", device="cpu")
        assert type(th.levels[0].transfer).__name__ == "SegTransfer"
    else:
        jh = j_setup_banded(jd, JAMGParams())
        th = gamg_setup_banded_device(td, AMGParams())
    j64, t64 = _dias(a, np.float64)
    tol = dict(rtol=1e-8, atol=0.0)
    want = j_cg_refined(j64.mv, jh.levels[0].op.mv, jnp.asarray(b), m_lo_mv=lambda r: j_vcycle(jh, r),
                        inner_maxiter=600, **tol)
    got = cg_refined(t64.mv, th.levels[0].op.mv, torch.tensor(b), m_lo_mv=lambda r: vcycle(th, r),
                     inner_maxiter=600, **tol)
    assert (got.outer_iters, got.reason) == (int(want.outer_iters), int(want.reason))
    assert got.reason > 0 and abs(got.iters - int(want.iters)) <= 1
    xs = got.x.numpy()
    assert np.linalg.norm(b - a @ xs) <= 1e-8 * np.linalg.norm(b)
    if case == "wrap":
        # the fourth-order stencil's condition number (~n^4) leaves x itself
        # determined to ~1e-4 by a 1e-8 residual, so only the chain's x is
        # held to JAX's
        np.testing.assert_allclose(xs, np.asarray(want.x), rtol=0, atol=1e-6 * np.abs(x).max())


def test_validation_errors():
    a = _high_order_1d(100)
    _, td = _dias(a)
    with pytest.raises(ValueError, match="DIA fine operator"):
        gamg_setup_banded_device(object())
    with pytest.raises(ValueError, match="bjacobi"):
        gamg_setup_banded_device(td, AMGParams(bjacobi_bs=4))
    with pytest.raises(ValueError, match="nsmooths"):
        gamg_setup_banded_device(td, AMGParams(nsmooths=2))
    nodiag = DIA(bands=td.bands[:1], offsets=(td.offsets[1],), shape=td.shape)
    with pytest.raises(ValueError, match="main diagonal"):
        gamg_setup_banded_device(nodiag, AMGParams())


def test_deviceaggbench_record_on_the_cpu(capsys):
    """The at-scale record's driver at n = 3000 on the CPU: JAX's matrix
    (its bands equal to the JAX bench's), the banded hierarchy's level rows
    and bands as JAX builds them, a converged solve whose true relative
    residual in f64 is within rtol, and the greedy oracle."""
    import json

    from tpusparse.bench.deviceaggbench import _periodic_bands as j_periodic_bands
    from tpusparse_torch.bench.deviceaggbench import main, periodic_bands

    n = 3000
    jd = j_periodic_bands(n, np.float32)
    td = periodic_bands(n, torch.float32, "cpu")
    assert td.offsets == tuple(jd.offsets)
    np.testing.assert_array_equal(td.bands.numpy(), np.asarray(jd.bands))
    rec = main([str(n), "--device", "cpu", "--oracle", "2000"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    jh = j_setup_banded(jd, JAMGParams())
    assert rec["level_rows"] == [int(lev.op.shape[0]) for lev in jh.levels][:12]
    assert rec["level_bands"] == [int(lev.op.bands.shape[0]) for lev in jh.levels][:12]
    assert rec["reason"] > 0 and rec["true_rel_residual"] <= 1e-8
    assert set(rec["setup_breakdown"]) == {"rho", "galerkin", "device_put"}
    assert rec["oracle"]["banded_iters"] > 0 and rec["oracle"]["greedy_iters"] > 0

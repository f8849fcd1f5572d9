"""The full-fusion CG body against the JAX package's: the K8 (``cgmv``) and
K9 (``descentu``) twins against ``fused7_xla``, ``PaddedStar.cgmv``,
``vcycle_fused_rupdate`` on a shared hierarchy, ``cg``'s ``ab_fused`` /
``m_fused`` body, and ``solve_poisson(..., cg_fusion=True)`` against the
JAX driver under ``TPUSPARSE_CG_FUSION``.

On the CPU every wrapper runs its plain twin; ``test_torch_cuda.py`` holds
the CUDA kernels against the twins on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.amg.fused_cycle import vcycle_fused_rupdate as j_vcycle_fused_rupdate
from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.amg.hierarchy import gamg_setup as j_gamg_setup
from tpusparse.bench.driver import solve_poisson as j_solve_poisson
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import poisson_stencil_device as j_poisson_stencil_device
from tpusparse.kernels.fused7 import fused7_xla
from tpusparse.solve.cg import cg as j_cg
from tpusparse.sparse.padded import PaddedStar as JPaddedStar
from tpusparse.sparse.padded import crop_field as j_crop_field
from tpusparse.sparse.padded import pad_field as j_pad_field
from tpusparse_torch import kernels
from tpusparse_torch.amg.fused_cycle import (
    cg_fusion_supported,
    vcycle_fused_dots,
    vcycle_fused_rupdate,
)
from tpusparse_torch.amg.hierarchy import AMGParams
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.kernels.fused7 import fused7_cgmv, fused7_descentu
from tpusparse_torch.solve.cg import ConvergedReason, cg
from tpusparse_torch.sparse.padded import crop_field, pad_field
from test_torch_amg import port_copy
from test_torch_kernels import AD, G, GW, S0, _check_dot, _check_field, _jax_padded, _port_padded, _system

SHAPES = [(40, 11, 13), (7, 5, 9)]   # (nz, ny, nx), both ragged
BETA, ALPHA_PREV, ALPHA = 0.61, 0.37, 0.519


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _crop(t, shape):
    return crop_field(t, shape).numpy()


def _jcrop(a, shape):
    return np.asarray(j_crop_field(a, shape))


@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_k8_cgmv_twin_matches_fused7_xla(shape, pinned):
    """(A p', p', x', <p', A p'>) with p' = z + beta p, x' = x + alpha_prev p."""
    jpop, pop, f = _system(shape, pinned)
    jf, pf = _jax_padded(f), _port_padded(f)
    want = fused7_xla("cgmv", jpop, jf["x"], jf["d"], jf["b"], BETA, ALPHA_PREV, S0)
    got = fused7_cgmv(pop.diag, pop.cx, pop.cy, pop.cz, pf["x"], pf["d"], pf["b"],
                      torch.tensor(BETA), torch.tensor(ALPHA_PREV), shape, pinned)
    assert kernels.LAUNCHES["fused7_cgmv"] == 0   # CPU tensors: the twin
    for g_, w_ in zip(got[:3], want[:3]):
        _check_field(_crop(g_, shape), _jcrop(w_, shape))
    _check_dot(got[3], want[3])


@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_k9_descentu_twin_matches_fused7_xla(shape, pinned):
    """(x1, s, r', <r', r'>) with r' = r - alpha ap and the degree-2
    downstroke on r'."""
    jpop, pop, f = _system(shape, pinned)
    jf, pf = _jax_padded(f), _port_padded(f)
    want = fused7_xla("descentu", jpop, jf["b"], jf["x"], jf["b"], G, AD, S0, gw=GW, g2=ALPHA)
    got = fused7_descentu(pop.diag, pop.cx, pop.cy, pop.cz, pf["b"], pf["x"],
                          S0, AD, G, GW, ALPHA, shape, pinned)
    for g_, w_ in zip(got[:3], want[:3]):
        _check_field(_crop(g_, shape), _jcrop(w_, shape))
    _check_dot(got[3], want[3])
    # r' feeds the next iteration's halo reads: its pads stay zero
    inner = torch.zeros_like(got[2], dtype=torch.bool)
    inner[3:3 + shape[0], :, :shape[2]] = True
    assert torch.all(got[2][~inner] == 0)


def test_padded_star_cgmv_matches_jax():
    shape = (12, 12, 12)
    jpop, pop, f = _system(shape)
    jf, pf = _jax_padded(f), _port_padded(f)
    want = jpop.cgmv(jf["x"], jf["d"], jf["b"], ALPHA_PREV, BETA)
    got = pop.cgmv(pf["x"], pf["d"], pf["b"], ALPHA_PREV, BETA)
    for g_, w_ in zip(got[:3], want[:3]):
        _check_field(_crop(g_, shape), _jcrop(w_, shape))
    _check_dot(got[3], want[3])


def _shared(n, smoother="chebyshev", degree=2):
    """The f32 padded operator and a GAMG hierarchy at n^3 in both packages
    (the JAX setup copied into the port), and a normalized right-hand side."""
    jop = JPaddedStar.from_star(j_poisson_stencil_device(JGrid3D(n, n, n), dtype=np.float32)[0])
    jh = j_gamg_setup(jop, JAMGParams(smoother=smoother, degree=degree))
    b = np.random.default_rng(4).standard_normal((n, n, n), dtype=np.float32)
    b /= np.float32(np.linalg.norm(b))
    return (jop, jh, j_pad_field(jnp.asarray(b))), (port_copy(jh), pad_field(torch.tensor(b)))


@pytest.mark.parametrize(
    "smoother, degree",
    # degree 2: K9 + coarse cycle + K4; degree 1: the torch r-update and
    # vcycle_fused_dots (K6/K7), the JAX semantics
    [("chebyshev", 2), ("richardson", 1)],
)
def test_vcycle_fused_rupdate_on_shared_hierarchy(smoother, degree):
    n, shape = 12, (12, 12, 12)
    (_, jh, jb), (ph, pb) = _shared(n, smoother, degree)
    assert cg_fusion_supported(ph) == (degree == 2)
    rng = np.random.default_rng(8)
    ap = rng.standard_normal(shape, dtype=np.float32) * np.float32(1e-2)
    jz, jr, jrz, jrr = j_vcycle_fused_rupdate(jh, jb, j_pad_field(jnp.asarray(ap)), jnp.float32(ALPHA))
    z, r, rz, rr = vcycle_fused_rupdate(ph, pb, pad_field(torch.tensor(ap)), torch.tensor(ALPHA))
    for g_, w_ in ((z, jz), (r, jr)):
        _check_field(_crop(g_, shape), _jcrop(w_, shape))
    assert rz.item() == pytest.approx(float(jrz), rel=1e-5)
    assert rr.item() == pytest.approx(float(jrr), rel=1e-5)


def _fused_kw(pop, ph):
    return dict(
        ab_fused=pop.cgmv,
        m_fused=lambda r, ap, alpha: vcycle_fused_rupdate(ph, r, ap, alpha),
    )


def test_full_fusion_cg_matches_jax():
    """cg's full-fusion body on a shared hierarchy against the JAX
    package's (tests/test_fused_cycle.py:183-211): iterations within 1, x
    to rtol 1e-4; and against the port's production body (K2 + K3/K4) the
    same way."""
    (jop, jh, jb), (ph, pb) = _shared(12)
    pop = ph.levels[0].op
    kw = dict(rtol=1e-6, maxiter=100)
    want = j_cg(jop.mv, jb, ab_fused=jop.cgmv,
                m_fused=lambda r, ap, al: j_vcycle_fused_rupdate(jh, r, ap, al), **kw)
    got = cg(pop.mv, pb, **_fused_kw(pop, ph), **kw)
    prod = cg(pop.mv, pb, a_mv_dot=pop.mv_dot, m_mv_dots=lambda r: vcycle_fused_dots(ph, r), **kw)
    assert got.reason == int(want.reason) == prod.reason == ConvergedReason.CONVERGED_RTOL
    assert abs(got.iters - int(want.iters)) <= 1 and abs(got.iters - prod.iters) <= 1
    ref = _jcrop(want.x, (12, 12, 12))
    for x in (got.x, prod.x):
        np.testing.assert_allclose(_crop(x, (12, 12, 12)), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max() + 1e-6)


def test_full_fusion_cg_zero_trip_and_argument_checks():
    """A solve that is converged at the start leaves x at zero; the pair is
    given together, from a zero guess, without the dot-fused forms."""
    _, (ph, pb) = _shared(6)
    pop = ph.levels[0].op
    res = cg(pop.mv, pb, rtol=10.0, **_fused_kw(pop, ph))
    assert res.iters == 0 and res.reason == ConvergedReason.CONVERGED_RTOL
    assert torch.all(res.x == 0)
    kw = _fused_kw(pop, ph)
    with pytest.raises(ValueError, match="together"):
        cg(pop.mv, pb, ab_fused=kw["ab_fused"])
    with pytest.raises(ValueError, match="zero initial guess"):
        cg(pop.mv, pb, torch.zeros_like(pb), **kw)
    with pytest.raises(ValueError, match="zero initial guess"):
        cg(pop.mv, pb, a_mv_dot=pop.mv_dot, **kw)


def test_cg_fusion_solve_matches_jax_driver(monkeypatch):
    """solve_poisson(24, cg_fusion=True) against the JAX driver's padded
    route with TPUSPARSE_CG_FUSION set: the same reason and sweeps, inner
    within 1, Linf to 1e-6 (tests/test_padded.py:102)."""
    monkeypatch.setenv("TPUSPARSE_CG_FUSION", "1")
    kw = dict(rtol=1e-8, atol=1e-12, pc="gamg", warmup=False)
    want = j_solve_poisson(24, layout="padded", **kw)
    got = solve_poisson(24, device="cpu", cg_fusion=True, **kw)
    assert (got.reason, got.outer_iters) == (want.reason, want.outer_iters) == (2, 2)
    assert abs(got.iters - want.iters) <= 1
    assert abs(got.linf_error - want.linf_error) < 1e-6


@pytest.mark.parametrize(
    "kw, match",
    [
        # Richardson(1): descentu has no degree-1 form in either package
        (dict(amg_params=AMGParams(smoother="richardson", degree=1)), "degree-2"),
        (dict(ksp="gmres"), "ksp='cg'"),
        (dict(layout="plain"), "layout='padded'"),
        (dict(precision="f64"), "precision='mixed'"),
    ],
)
def test_cg_fusion_refuses_what_it_cannot_run(kw, match):
    """Where the JAX driver silently runs the unfused body, the port raises:
    it never reports a fused solve that did not run."""
    with pytest.raises(ValueError, match=match):
        solve_poisson(8, device="cpu", rtol=1e-8, warmup=False, cg_fusion=True, **kw)

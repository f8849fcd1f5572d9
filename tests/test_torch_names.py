"""The JAX package's public names that the port took last, each against the
JAX package on the CPU: ``fmg`` and ``wcycle`` on a shared hierarchy,
``cg(check_every=)`` and ``cg_refined(check_every=)``,
``solve_poisson(dtype=, check_error=)``, the diffusion CLI with
``-devices p``, ``@`` and the introspection members of the operators, the
geometric transfer's helpers, the host oracles (``ptap_scipy``,
``explicit_p_scipy``), the setups' ``timings``, ``RefinedResult.stalled``
and the native engine's ``spmv`` and ``assemble_poisson7``.

The hierarchies are the JAX package's, carried over with
``tests/torch_parity.py::port_copy``; the cycles are held to the
tolerances of ``tests/test_torch_amg.py`` (rtol 1e-4, atol 1e-5 of the
largest value).
"""

import contextlib
import functools
import io
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpusparse.amg.hierarchy as jh_mod
import tpusparse.native as j_native
from tpusparse.__main__ import main as j_main
from tpusparse.amg import geo as j_geo
from tpusparse.amg.fused_cycle import vcycle_fused_dots as j_vcycle_fused_dots
from tpusparse.amg.fused_cycle import vcycle_fused_rupdate as j_vcycle_fused_rupdate
from tpusparse.amg.galerkin import ptap_scipy as j_ptap_scipy
from tpusparse.amg.transfer import StructuredTransfer as JStructuredTransfer
from tpusparse.bench.driver import solve_poisson as j_solve_poisson
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import assemble_poisson as j_assemble_poisson
from tpusparse.grid.poisson import poisson_stencil_device as j_poisson_stencil_device
from tpusparse.solve.cg import cg as j_cg
from tpusparse.solve.refine import RefinedResult as JRefinedResult
from tpusparse.solve.refine import cg_refined as j_cg_refined
from tpusparse.sparse.dia import DFDIA as JDFDIA
from tpusparse.sparse.dia import DIA as JDIA
from tpusparse.sparse.dia import HybridDIA as JHybridDIA
from tpusparse.sparse.ell import ELL as JELL
from tpusparse.sparse.padded import PaddedStar as JPaddedStar
from tpusparse.sparse.padded import crop_field as j_crop_field
from tpusparse.sparse.padded import pad_field as j_pad_field
from tpusparse.sparse.varstencil import VarStencil27 as JVarStencil27
from tpusparse_torch import native
from tpusparse_torch.amg import AMGParams, Hierarchy, cast_hierarchy, gamg_setup, vcycle, wcycle
from tpusparse_torch.amg import geo
from tpusparse_torch.amg.fused_cycle import vcycle_fused_dots, vcycle_fused_rupdate
from tpusparse_torch.amg.galerkin import ptap_scipy
from tpusparse_torch.amg.hierarchy import fmg
from tpusparse_torch.amg.transfer import StructuredTransfer
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.grid import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil_device
from tpusparse_torch.interop import dfdia_from_numpy
from tpusparse_torch.solve.cg import ConvergedReason, cg
from tpusparse_torch.solve.refine import RefinedResult, cg_refined
from tpusparse_torch.sparse.csr import HostCSR
from tpusparse_torch.sparse.dia import DIA, HybridDIA
from tpusparse_torch.sparse.ell import ELL
from tpusparse_torch.sparse.padded import PaddedStar, crop_field, pad_field
from tpusparse_torch.sparse.varstencil import VarStencil27
from torch_parity import port_copy

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_package_exports_are_jax_s():
    import tpusparse.amg as j_amg
    import tpusparse.grid as j_grid
    import tpusparse_torch.amg as amg
    import tpusparse_torch.grid as grid

    assert amg.__all__ == j_amg.__all__ and grid.__all__ == j_grid.__all__
    assert all(callable(f) for f in (AMGParams, Hierarchy, cast_hierarchy, gamg_setup, vcycle, wcycle))
    assert Grid3D(4, 5, 6).shape == JGrid3D(4, 5, 6).shape


# --- fmg and wcycle on a shared hierarchy -----------------------------------

N = 12
SHAPE = (N, N, N)


@functools.lru_cache(maxsize=None)
def _hierarchies(padded: bool):
    """The JAX f32 hierarchy at 12^3 on the padded or the plain layout, and
    its copy in the port."""
    jop = j_poisson_stencil_device(JGrid3D(N, N, N), dtype=np.float32)[0]
    jh = jh_mod.gamg_setup(JPaddedStar.from_star(jop) if padded else jop, jh_mod.AMGParams())
    return jh, port_copy(jh)


def _rhs(padded: bool, seed: int = 3):
    b = np.random.default_rng(seed).standard_normal(SHAPE, dtype=np.float32)
    if padded:
        return j_pad_field(jnp.asarray(b)), pad_field(torch.tensor(b))
    return jnp.asarray(b), torch.tensor(b)


def _field(x, padded):
    return np.asarray(j_crop_field(x, SHAPE)) if padded else np.asarray(x)


def _port_field(x, padded):
    return crop_field(x, SHAPE) if padded else x


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "plain"])
@pytest.mark.parametrize("n_v", [1, 2])
def test_fmg_matches_jax(padded, n_v):
    jh, ph = _hierarchies(padded)
    jb, b = _rhs(padded)
    want = _field(jh_mod.fmg(jh, jb, n_v=n_v), padded)
    got = fmg(ph, b, n_v=n_v)
    _close(_port_field(got, padded), want)
    if padded:  # the pads stay zero
        assert torch.all(pad_field(crop_field(got, SHAPE)) == got)


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "plain"])
def test_wcycle_matches_jax(padded):
    jh, ph = _hierarchies(padded)
    jb, b = _rhs(padded, seed=4)
    got = wcycle(ph, b)
    _close(_port_field(got, padded), _field(jh_mod.wcycle(jh, jb), padded))
    assert torch.equal(got, vcycle(ph, b, gamma=2))


# --- cg(check_every=) and cg_refined(check_every=) --------------------------


@functools.lru_cache(maxsize=None)
def _f64_system(n=16):
    jop, jb, _ = j_poisson_stencil_device(JGrid3D(n, n, n))
    op, b, _ = poisson_stencil_device(Grid3D(n, n, n), device="cpu")
    return (jop, jb), (op, b)


@pytest.mark.parametrize("check_every", [2, 3])
def test_cg_check_every_matches_jax(check_every):
    """The unfused body in f64 under Jacobi: JAX's count exactly, a
    multiple of check_every, and x to the tolerance of
    tests/test_torch_krylov.py::test_cg_matches_jax."""
    (jop, jb), (op, b) = _f64_system()
    kw = dict(rtol=1e-8, maxiter=2000, check_every=check_every)
    want = j_cg(jop.mv, jb, m_mv=lambda r: r / jop.diag, **kw)
    got = cg(op.mv, b, m_mv=lambda r: r / op.diag, **kw)
    once = cg(op.mv, b, m_mv=lambda r: r / op.diag, rtol=1e-8, maxiter=2000)
    assert got.reason == int(want.reason) == ConvergedReason.CONVERGED_RTOL
    assert got.iters == int(want.iters) and got.iters % check_every == 0
    assert once.iters <= got.iters < once.iters + check_every
    x_want = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), x_want, atol=1e-7 * np.abs(x_want).max())


@functools.lru_cache(maxsize=None)
def _shared_padded(n=12):
    """The f32 padded operator and GAMG hierarchy at n^3 in both packages
    and a normalized right-hand side (tests/test_torch_fusion.py's)."""
    jop = JPaddedStar.from_star(j_poisson_stencil_device(JGrid3D(n, n, n), dtype=np.float32)[0])
    jh = jh_mod.gamg_setup(jop, jh_mod.AMGParams())
    b = np.random.default_rng(4).standard_normal((n, n, n), dtype=np.float32)
    b /= np.float32(np.linalg.norm(b))
    return (jop, jh, j_pad_field(jnp.asarray(b))), (port_copy(jh), pad_field(torch.tensor(b)))


@pytest.mark.parametrize("check_every", [2, 3])
@pytest.mark.parametrize("body", ["production", "full_fusion"])
def test_cg_check_every_fused_bodies_match_jax(body, check_every):
    """The production body (fused <p, Ap> and the dot-fused cycle) and the
    full-fusion body on a shared hierarchy: JAX's count exactly and x to
    tests/test_torch_fusion.py's rtol 1e-4."""
    (jop, jh, jb), (ph, pb) = _shared_padded()
    pop = ph.levels[0].op
    kw = dict(rtol=1e-6, maxiter=100, check_every=check_every)
    if body == "production":
        want = j_cg(jop.mv, jb, a_mv_dot=jop.mv_dot, m_mv_dots=lambda r: j_vcycle_fused_dots(jh, r), **kw)
        got = cg(pop.mv, pb, a_mv_dot=pop.mv_dot, m_mv_dots=lambda r: vcycle_fused_dots(ph, r), **kw)
    else:
        want = j_cg(jop.mv, jb, ab_fused=jop.cgmv,
                    m_fused=lambda r, ap, al: j_vcycle_fused_rupdate(jh, r, ap, al), **kw)
        got = cg(pop.mv, pb, ab_fused=pop.cgmv,
                 m_fused=lambda r, ap, al: vcycle_fused_rupdate(ph, r, ap, al), **kw)
    assert got.reason == int(want.reason) == ConvergedReason.CONVERGED_RTOL
    assert got.iters == int(want.iters) and got.iters % check_every == 0
    ref = np.asarray(j_crop_field(want.x, (12, 12, 12)))
    np.testing.assert_allclose(crop_field(got.x, (12, 12, 12)).numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max() + 1e-6)


@pytest.mark.parametrize(
    "kw, match",
    [(dict(check_every=0), "check_every must be >= 1"),
     (dict(check_every=2, history=True), "incompatible with history/spectrum"),
     (dict(check_every=2, spectrum=True), "incompatible with history/spectrum")],
)
def test_cg_check_every_refusals_are_jax_s(kw, match):
    (jop, jb), (op, b) = _f64_system(6)
    with pytest.raises(ValueError, match=match):
        j_cg(jop.mv, jb, **kw)
    with pytest.raises(ValueError, match=match):
        cg(op.mv, b, **kw)


def test_cg_refined_check_every_matches_jax():
    """cg_refined forwards check_every to the inner CG: every inner solve
    runs an even count, and the inner and outer totals are JAX's."""
    n, shape = 16, (16, 16, 16)
    jop, jb, _ = j_poisson_stencil_device(JGrid3D(n, n, n))
    jop32 = JPaddedStar.from_star(j_poisson_stencil_device(JGrid3D(n, n, n), dtype=np.float32)[0])
    jh = jh_mod.gamg_setup(jop32, jh_mod.AMGParams())
    ph = port_copy(jh)
    op, b, _ = poisson_stencil_device(Grid3D(n, n, n), device="cpu")
    op32 = ph.levels[0].op
    want = j_cg_refined(
        jop.mv, jop32.mv, jb, rtol=1e-8, atol=1e-12, check_every=2,
        m_lo_mv_dots=lambda r: j_vcycle_fused_dots(jh, r), a_lo_mv_dot=jop32.mv_dot,
        encode=j_pad_field, decode=functools.partial(j_crop_field, shape=shape),
    )
    inner = []

    def counted(*args, **kw):
        res = cg(*args, **kw)
        inner.append((res.iters, kw.get("check_every")))
        return res

    got = cg_refined(
        op.mv, op32.mv, b, rtol=1e-8, atol=1e-12, check_every=2, solver=counted,
        m_lo_mv_dots=lambda r: vcycle_fused_dots(ph, r), a_lo_mv_dot=op32.mv_dot,
        encode=pad_field, decode=functools.partial(crop_field, shape=shape),
    )
    assert (got.iters, got.outer_iters, got.reason) == (int(want.iters), int(want.outer_iters), int(want.reason))
    assert got.reason == ConvergedReason.CONVERGED_RTOL
    assert all(its % 2 == 0 and ce == 2 for its, ce in inner) and len(inner) == got.outer_iters


def test_refined_result_stalled_is_jax_s():
    for reason in (ConvergedReason.CONVERGED_STALLED, ConvergedReason.CONVERGED_RTOL):
        got = RefinedResult(x=torch.zeros(1), iters=1, outer_iters=1, resnorm=0.0, reason=int(reason), bnorm=1.0)
        want = JRefinedResult(x=jnp.zeros(1), iters=1, outer_iters=1, resnorm=0.0, reason=int(reason), bnorm=1.0)
        assert got.stalled() == want.stalled() == (reason == ConvergedReason.CONVERGED_STALLED)
        assert got.converged() == want.converged()


# --- solve_poisson(dtype=, check_error=) ------------------------------------


def _report(rep):
    return rep.iters, rep.outer_iters, rep.reason


def test_solve_poisson_f32_outer_matches_jax():
    """dtype=float32: the outer operator, b and the exact solution in f32
    under mixed precision.  The counts are JAX's; Linf, which the f32
    system's own rounding sets, to the 2e-5 of the uniform-f32 parity
    tests (tests/test_torch_plain.py)."""
    kw = dict(rtol=1e-6, atol=1e-12, warmup=False)
    want = j_solve_poisson(16, dtype=jnp.float32, layout="padded", **kw)
    got = solve_poisson(16, device="cpu", dtype=torch.float32, **kw)
    assert _report(got) == _report(want)
    assert got.reason > 0
    assert got.linf_error == pytest.approx(want.linf_error, abs=2e-5)


@pytest.mark.parametrize(
    "kw",
    [dict(layout="padded"), dict(layout="plain"), dict(precision="f64"),
     dict(mat_type="aij", structure_detect=False)],
    ids=["padded", "plain", "f64", "aij"],
)
def test_solve_poisson_check_error_false_reports_nan_as_jax(kw):
    """check_error=False on each route: NaN for Linf in both packages; the
    counts JAX's, the aij route's inner count within 1, as
    tests/test_torch_aij.py holds it (its f32 dots sum in another order)."""
    common = dict(rtol=1e-8, atol=1e-12, warmup=False, check_error=False, **kw)
    want = j_solve_poisson(12, **common)
    got = solve_poisson(12, device="cpu", **common)
    slack = 1 if kw.get("mat_type") == "aij" else 0
    assert (got.outer_iters, got.reason) == (want.outer_iters, want.reason)
    assert abs(got.iters - want.iters) <= slack
    assert np.isnan(got.linf_error) and np.isnan(want.linf_error)


# --- the diffusion CLI with -devices p --------------------------------------


def test_diffusion_cli_ignores_devices_as_jax():
    """-problem diffusion -devices 2: the port's CLI (a process of its own)
    prints the JAX CLI's stdout, timing lines aside, and warns on stderr
    that -devices is ignored."""
    argv = ["-problem", "diffusion", "-da_grid_x", "16", "-da_grid_y", "16", "-da_grid_z", "16",
            "-devices", "2", "-ksp_rtol", "1e-8", "-ksp_converged_reason"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert j_main(argv) == 0
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-m", "tpusparse_torch", *argv, "-device", "cpu"],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "-devices 2 is ignored for -problem diffusion" in proc.stderr
    timed = ("L2 norm", "Maximum", "Time", "JSON")

    def head(text):
        return [line for line in text.splitlines() if not line.startswith(timed)]

    assert head(proc.stdout) == head(out.getvalue())
    side = {}
    for text, key in ((proc.stdout, "port"), (out.getvalue(), "jax")):
        side[key] = json.loads(next(ln for ln in text.splitlines() if ln.startswith("JSON: "))[6:])
    got, want = side["port"], side["jax"]
    assert (got["iters"], got["outer_iters"], got["reason"]) == (want["iters"], want["outer_iters"], want["reason"])
    assert got["linf_error"] == pytest.approx(want["linf_error"], abs=1e-6)


# --- the operators' members -------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_star_stencil_members_match_jax(dtype):
    grid = (6, 5, 7)
    jop = j_poisson_stencil_device(JGrid3D(*grid[::-1]), dtype=dtype)[0]
    op = poisson_stencil_device(Grid3D(*grid[::-1]), dtype=torch.float64 if dtype == np.float64 else torch.float32,
                                device="cpu")[0]
    assert op.shape == jop.shape == (210, 210)
    np.testing.assert_array_equal(op.diagonal().numpy(), np.asarray(jop.diagonal()))
    x = np.random.default_rng(1).standard_normal(op.grid_shape).astype(dtype)
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    for xv in (x, x.reshape(-1)):
        want = np.asarray(jop @ jnp.asarray(xv))
        got = op @ torch.tensor(xv)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())
    np.testing.assert_array_equal(op.mv_flat(torch.tensor(x.reshape(-1))).numpy(),
                                  (op @ torch.tensor(x)).numpy().reshape(-1))


def test_padded_star_members_match_jax():
    _, ph = _hierarchies(True)
    jh, _ = _hierarchies(True)
    pop, jpop = ph.levels[0].op, jh.levels[0].op
    assert pop.shape == jpop.shape == (N ** 3, N ** 3)
    jb, b = _rhs(True, seed=7)
    _close(crop_field(pop @ b, SHAPE), np.asarray(j_crop_field(jpop @ jb, SHAPE)))
    tr, jtr = ph.levels[0].transfer, jh.levels[0].transfer
    np.testing.assert_array_equal(tr.tnorm.numpy(), np.asarray(jtr.tnorm))


def _host_matrix():
    """A 7-point Poisson matrix on 5 x 4 x 6 in both packages' HostCSR."""
    ja = j_assemble_poisson(JGrid3D(6, 4, 5))[0]
    return ja, HostCSR.from_scipy(ja.to_scipy())


def test_general_containers_matmul_matches_jax():
    ja, a = _host_matrix()
    x = np.random.default_rng(2).standard_normal(a.shape[0])
    for dtype in (np.float32, np.float64):
        xv = x.astype(dtype)
        pairs = [
            (DIA.from_csr(a, dtype=dtype, device="cpu"), JDIA.from_csr(ja, dtype=dtype)),
            (HybridDIA.from_csr(a, max_bands=3, dtype=dtype, device="cpu"),
             JHybridDIA.from_csr(ja, max_bands=3, dtype=dtype)),
            (ELL.from_csr(a, dtype=dtype, device="cpu"), JELL.from_csr(ja, dtype=dtype)),
        ]
        assert pairs[1][0].rem is not None
        for op, jop in pairs:
            got = op @ torch.tensor(xv)
            assert torch.equal(got, op.mv(torch.tensor(xv)))
            np.testing.assert_allclose(got.numpy(), np.asarray(jop @ jnp.asarray(xv)),
                                       rtol=1e-6, atol=1e-6 * np.abs(x).max())
    bands = DIA.host_bands(a)
    hi = bands[0].astype(np.float32)
    lo = (bands[0] - hi).astype(np.float32)
    df = dfdia_from_numpy(hi, lo, bands[1], a.shape, device="cpu")
    jdf = JDFDIA(hi=jnp.asarray(hi), lo=jnp.asarray(lo), offsets=tuple(bands[1]), shape=a.shape)
    np.testing.assert_allclose((df @ torch.tensor(x)).numpy(), np.asarray(jdf @ jnp.asarray(x)), rtol=1e-14)


def test_varstencil_from_csr_matches_jax():
    """The Galerkin 27-point level 1 of the plain hierarchy, binned from
    its CSR by both packages; a 7-point matrix past one cell of reach is
    refused by both."""
    jh, _ = _hierarchies(False)
    jcsr = jh.levels[1].op.to_csr()
    csr = HostCSR.from_scipy(jcsr.to_scipy())
    g = tuple(jh.levels[1].op.grid_shape)
    got = VarStencil27.from_csr(csr, g, device="cpu")
    want = JVarStencil27.from_csr(jcsr, g)
    np.testing.assert_array_equal(got.coef.numpy(), np.asarray(want.coef))
    ja, a = _host_matrix()
    with pytest.raises(ValueError, match="27-point"):
        JVarStencil27.from_csr(ja, (2, 12, 5))
    with pytest.raises(ValueError, match="27-point"):
        VarStencil27.from_csr(a, (2, 12, 5), device="cpu")


# --- geometric transfers, host oracles, timings -------------------------------


@pytest.mark.parametrize("shape, bs", [((7, 5, 8), (3, 3, 3)), ((4, 9, 5), (1, 3, 2))])
def test_geo_helpers_match_jax(shape, bs):
    rng = np.random.default_rng(5)
    c = geo.coarse_dims(shape, bs)
    e_c = rng.standard_normal(int(np.prod(c)))
    v = rng.standard_normal(int(np.prod(shape)))
    np.testing.assert_array_equal(geo.up3(torch.tensor(e_c), shape, bs).numpy(),
                                  np.asarray(j_geo.up3(jnp.asarray(e_c), shape, bs)))
    np.testing.assert_allclose(geo.down3(torch.tensor(v), shape, bs).numpy(),
                               np.asarray(j_geo.down3(jnp.asarray(v), shape, bs)), rtol=1e-14)
    for dtype in (np.float32, np.float64):
        got, want = geo.block_weight_field(shape, bs, dtype), j_geo.block_weight_field(shape, bs, dtype)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    t = geo.GeoTransfer.build(0.5, shape, bs, device="cpu")
    jt = j_geo.GeoTransfer.build(jnp.zeros(int(np.prod(shape))), 0.5, shape, bs)
    assert t.n_coarse == jt.n_coarse == int(np.prod(c))
    # the oracles are the transfer's contractions T0 and T0^T
    e32, v32 = torch.tensor(e_c, dtype=torch.float32), torch.tensor(v, dtype=torch.float32)
    torch.testing.assert_close(t._up(e32), geo.up3(e32, shape, bs))
    torch.testing.assert_close(t._down(v32), geo.down3(v32, shape, bs))


def test_host_oracles_match_jax():
    """explicit_p_scipy and ptap_scipy on the 7-point matrix of a 6 x 7 x 8
    grid with the 3^3 smoothed aggregation."""
    ja = j_assemble_poisson(JGrid3D(8, 7, 6))[0]
    a = HostCSR.from_scipy(ja.to_scipy())
    dinv = 1.0 / ja.diagonal()
    t = StructuredTransfer.build((6, 7, 8), 0.6, torch.float64, device="cpu")
    jt = JStructuredTransfer.build((6, 7, 8), 0.6, np.float64)
    p, jp = t.explicit_p_scipy(a, dinv), jt.explicit_p_scipy(ja, dinv)
    assert p.shape == jp.shape == (336, 18)
    assert abs(p - jp).max() == 0.0
    got, want = ptap_scipy(a, p), j_ptap_scipy(ja, jp)
    assert np.array_equal(got.indptr, want.indptr) and np.array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


def test_setup_timings_keys_are_jax_s():
    jop = j_poisson_stencil_device(JGrid3D(9, 9, 9), dtype=np.float32)[0]
    op = poisson_stencil_device(Grid3D(9, 9, 9), dtype=torch.float32, device="cpu")[0]
    want, got = {}, {}
    jh_mod.gamg_setup(jop, jh_mod.AMGParams(), timings=want)
    hier = gamg_setup(op, AMGParams(), got)
    assert set(got) == set(want) == {"rho", "galerkin"}
    assert all(v >= 0.0 for v in got.values()) and hier.n_levels >= 2
    ja = j_assemble_poisson(JGrid3D(9, 9, 9), dtype=np.float64)[0]
    a = HostCSR.from_scipy(ja.to_scipy())
    want, got = {"device_put": 1.0}, {"device_put": 1.0}   # both add to what is there
    j_geo.gamg_setup_geo(JDIA.from_csr(ja, dtype=np.float32), (9, 9, 9), jh_mod.AMGParams(), timings=want)
    geo.gamg_setup_geo(DIA.from_csr(a, dtype=np.float32, device="cpu"), (9, 9, 9), AMGParams(), timings=got)
    assert set(got) == set(want) == {"aggregate", "galerkin", "rho", "device_put"}
    assert got["device_put"] == want["device_put"] == 1.0


# --- the native engine --------------------------------------------------------


def test_native_spmv_and_assembly_match_jax():
    assert native.available() and j_native.available()
    got = native.assemble_poisson7(5, 4, 3, 0.2, 0.25, 1 / 3)
    want = j_native.assemble_poisson7(5, 4, 3, 0.2, 0.25, 1 / 3)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.shape == want.shape == (60, 60)
    x = np.random.default_rng(9).standard_normal(60)
    np.testing.assert_array_equal(native.spmv(got, x), j_native.spmv(want, x))
    assert sp.issparse(got.to_scipy())
    with pytest.raises(ValueError, match="x shape"):
        native.spmv(got, x[:-1])

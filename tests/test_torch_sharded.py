"""The z-sharded fine level against the JAX package's: the stacked layout and
its halo exchange, the K3z/K4z twins (``fused7_descent_slab`` /
``fused7_ascent_slab``) on each slab, one slab a call and all slabs
stacked, against ``fused7_call``'s z-slab form in the Pallas interpreter,
one wrapper call a stroke, the slab twins over all shards against the
unsharded twin, ``vcycle_fused_sharded`` against the JAX package's plain
``vcycle`` on one hierarchy, ``solve_poisson(..., n_devices=4)`` and
``-devices 4`` against the JAX package, and every other ``n_devices > 1``
option set: run on the (z, y) route, or refused as the JAX driver refuses
it.

On the CPU every wrapper runs its plain twin; ``test_torch_cuda.py`` holds
the CUDA kernels against the twins on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.amg.hierarchy import gamg_setup as j_gamg_setup
from tpusparse.amg.hierarchy import vcycle as j_vcycle
from tpusparse.bench.driver import solve_poisson as j_solve_poisson
from tpusparse.dist.fused_sharded import FusedSharded as JFusedSharded
from tpusparse.dist.fused_sharded import make_z_mesh as j_make_z_mesh
from tpusparse.dist.mesh import field_sharding
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import poisson_stencil as j_poisson_stencil
from tpusparse.kernels.fused7 import fused7_call
from tpusparse.kernels.stencil7 import padded_shape as j_padded_shape
from tpusparse.sparse.padded import PaddedStar as JPaddedStar
from tpusparse_torch import kernels
from tpusparse_torch.__main__ import main
from tpusparse_torch.amg.fused_cycle import vcycle_fused
from tpusparse_torch.amg.hierarchy import AMGParams, vcycle
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.config.options import load_options
from tpusparse_torch.dist import (
    FusedSharded,
    ShardedTransfer,
    check_divisible,
    fused_sharded_supported,
    make_z_mesh,
    vcycle_fused_sharded,
)
from tpusparse_torch.interop import star_from_numpy
from tpusparse_torch.kernels.fused7 import (
    fused7_ascent,
    fused7_ascent_slab,
    fused7_descent,
    fused7_descent_slab,
)
from tpusparse_torch.kernels.stencil7 import FACE
from tpusparse_torch.sparse.padded import PaddedStar, crop_field, pad_field
from test_torch_cli import _grid, _run
from test_torch_kernels import AD, G, G2, GW, S0, _check_field
from torch_parity import port_copy

# (global (nz, ny, nx), z-shards): nz_l = 3, the least a shard holds (its
# neighbours read FACE planes), and 4; x ragged against the port's 4-float
# rows and the JAX package's 128-lane ones
SLABS = [((12, 6, 7), 4), ((8, 6, 7), 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fields(shape, seed=7):
    """The f32 Poisson diagonal and legs from the JAX package, and b, t,
    x1 from a fixed numpy seed, all (nz, ny, nx)."""
    nz, ny, nx = shape
    jop = j_poisson_stencil(JGrid3D(nx, ny, nz), dtype=np.float32)[0]
    rng = np.random.default_rng(seed)
    f = {k: rng.standard_normal(shape, dtype=np.float32) for k in ("b", "t", "x1")}
    return np.asarray(jop.diag), (float(jop.cx), float(jop.cy), float(jop.cz)), f


def _slab(field, i, nz_l, fill=0.0):
    """Shard i's slab of a numpy field with FACE halo planes holding the
    neighbours' planes (``fill`` beyond the global faces): what the
    stacked layout holds after an exchange."""
    nz = field.shape[0]
    out = np.full((nz_l + 2 * FACE, *field.shape[1:]), fill, np.float32)
    lo, hi = i * nz_l - FACE, (i + 1) * nz_l + FACE
    a, b = max(lo, 0), min(hi, nz)
    out[a - lo:b - lo] = field[a:b]
    return out


def _jax_padded(slab, fill=0.0):
    """A slab in the JAX package's layout: y padded to 8, x to 128."""
    nzp, ny, nx = slab.shape
    _, nyp, nxp = j_padded_shape((nzp - 2 * FACE, ny, nx))
    return jnp.asarray(np.pad(slab, ((0, 0), (0, nyp - ny), (0, nxp - nx)), constant_values=fill))


def _port_padded(slab, fill=0.0):
    nx = slab.shape[2]
    return torch.from_numpy(np.pad(slab, ((0, 0), (0, 0), (0, -nx % 4)), constant_values=fill))


# --- the stacked layout --------------------------------------------------

def test_stacked_layout_roundtrip_and_halo():
    """tests/test_fused_sharded.py::test_stacked_layout_roundtrip_and_halo on
    the port, and its exchange against the JAX package's on the domain
    columns."""
    shape, p = (16, 8, 8), 4
    diag, legs, _ = _fields(shape)
    fs = FusedSharded.build(star_from_numpy(diag, *legs, True, device="cpu"), make_z_mesh(p, "cpu"))
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    st = fs.to_stacked(torch.from_numpy(x))
    assert st.shape == (p, 16 // p + 2 * FACE, 8, 8)
    assert torch.equal(fs.from_stacked(st), torch.from_numpy(x))
    ex = fs.exchange_(st.clone()).numpy()
    stn, nzl = st.numpy(), 16 // p
    for i in range(1, p):
        np.testing.assert_array_equal(ex[i, :FACE], stn[i - 1, nzl:nzl + FACE])
        np.testing.assert_array_equal(ex[i - 1, FACE + nzl:], stn[i, FACE:2 * FACE])
    assert (ex[0, :FACE] == 0).all() and (ex[-1, -FACE:] == 0).all()
    np.testing.assert_array_equal(ex[:, FACE:FACE + nzl], stn[:, FACE:FACE + nzl])
    # the JAX package's exchange on its 4 virtual devices
    mesh = j_make_z_mesh(p)
    jst = JFusedSharded.build(j_poisson_stencil(JGrid3D(8, 8, 16), dtype=np.float32)[0], mesh, interpret=True)
    jex = np.asarray(jst._exchange_all(jst.to_stacked(jax.device_put(jnp.asarray(x), field_sharding(mesh)))))
    np.testing.assert_array_equal(ex, jex[:, :, :8, :8])


def test_stacked_diag_matches_jax():
    """The built diagonal: refreshed halos, then 1.0 at every remaining zero
    (the x pads and the global faces), on the domain columns as JAX's."""
    shape, p = (12, 6, 7), 4
    diag, legs, _ = _fields(shape)
    fs = FusedSharded.build(star_from_numpy(diag, *legs, True, device="cpu"), make_z_mesh(p, "cpu"))
    jfs = JFusedSharded.build(j_poisson_stencil(JGrid3D(7, 6, 12), dtype=np.float32)[0], j_make_z_mesh(p),
                              interpret=True)
    got = fs.diag_st.numpy()
    np.testing.assert_array_equal(got[..., :7], np.asarray(jfs.diag_st)[:, :, :6, :7])
    assert (got[..., 7:] == 1.0).all()
    for i in range(p):
        np.testing.assert_array_equal(got[i, :, :, :7], _slab(diag, i, 3, fill=1.0))


# --- K3z / K4z twins against fused7_call's z-slab form ---------------------

SLAB_CASES = [
    pytest.param(shape, p, i, pinned, id=f"{shape}-p{p}-shard{i}-{'pinned' if pinned else 'free'}")
    for shape, p in SLABS for i in range(p) for pinned in (True, False)
]


def _jax_slab(mode, shape, p, i, pinned, diag, legs, f):
    """Shard i's outputs of ``fused7_call(mode, ..., interpret=True, z0=i
    nz_l, nzg=nz)`` (a tuple, JAX's layout).  nz_l = 3 takes the JAX
    kernel's one slab of 3 planes (``tz_override``: its slab-depth ladder
    starts at 4)."""
    nz, ny, nx = shape
    nz_l = nz // p
    jd = _jax_padded(_slab(diag, i, nz_l, fill=1.0), 1.0)
    jb, jt, jx1 = (_jax_padded(_slab(f[k], i, nz_l)) for k in ("b", "t", "x1"))
    kw = dict(shape=(nz_l, ny, nx), pinned=pinned, interpret=True, gw=GW, tz_override=nz_l, z0=i * nz_l, nzg=nz)
    if mode == "descent":
        return tuple(fused7_call("descent", jd, *legs, jb, jb, jb, G, AD, S0, **kw))
    return (fused7_call("ascent", jd, *legs, jt, jb, jx1, G, AD, S0, g2=G2, **kw),)


def _port_slab(mode, shape, pinned, z0, nzg, legs, d, fields):
    """The port's K3z (K4z) wrapper on slab fields (one slab, or stacked)
    of a grid of ``nzg`` planes, its outputs as a tuple."""
    b, t, x1 = fields
    if mode == "descent":
        return fused7_descent_slab(d, *legs, b, S0, AD, G, GW, shape, pinned, z0, nzg)
    return (fused7_ascent_slab(d, *legs, t, b, x1, G, AD, G2, GW, shape, pinned, z0, nzg),)


def _check_slab_against_jax(got, want, nz_l, nx, ny):
    """A slab's outputs against JAX's: the domain planes at
    tests/test_fused7.py:53-69's tolerances (``_check_field``), every face
    plane 0 in both, and the port's x pads 0."""
    for g_, w_ in zip(got, want):
        w_ = np.asarray(w_)
        _check_field(g_[FACE:FACE + nz_l, :, :nx].numpy(), w_[FACE:FACE + nz_l, :ny, :nx])
        assert (g_[:FACE] == 0).all() and (g_[FACE + nz_l:] == 0).all() and (g_[..., nx:] == 0).all()
        assert (w_[:FACE] == 0).all() and (w_[FACE + nz_l:] == 0).all()


@pytest.mark.parametrize("mode", ["descent", "ascent"])
@pytest.mark.parametrize("shape, p, i, pinned", SLAB_CASES)
def test_slab_twin_matches_pallas_interpreter(mode, shape, p, i, pinned):
    """Shard i's K3z (K4z) twin on its one slab (q = 1) against
    ``fused7_call(mode, ..., interpret=True, z0=i nz_l, nzg=nz)`` on the
    same slab (``_check_slab_against_jax``)."""
    nz, ny, nx = shape
    nz_l = nz // p
    diag, legs, f = _fields(shape)
    local = (nz_l, ny, nx)
    pd = _port_padded(_slab(diag, i, nz_l, fill=1.0), 1.0)
    fields = [_port_padded(_slab(f[k], i, nz_l)) for k in ("b", "t", "x1")]
    got = _port_slab(mode, local, pinned, i * nz_l, nz, legs, pd, fields)
    assert kernels.LAUNCHES[f"fused7_{mode}_slab"] == 0   # CPU tensors: the twin
    _check_slab_against_jax(got, _jax_slab(mode, shape, p, i, pinned, diag, legs, f), nz_l, nx, ny)


@pytest.mark.parametrize("mode", ["descent", "ascent"])
@pytest.mark.parametrize("pinned", [True, False], ids=["pinned", "free"])
@pytest.mark.parametrize("shape, p", SLABS)
def test_stacked_slab_twin_matches_pallas_interpreter(mode, shape, p, pinned):
    """The K3z (K4z) twin on all p slabs stacked (q = p, one wrapper call)
    against ``fused7_call``'s z-slab form on each shard, as the q = 1
    case."""
    nz, ny, nx = shape
    nz_l = nz // p
    diag, legs, f = _fields(shape)
    pd = torch.stack([_port_padded(_slab(diag, i, nz_l, fill=1.0), 1.0) for i in range(p)])
    fields = [torch.stack([_port_padded(_slab(f[k], i, nz_l)) for i in range(p)]) for k in ("b", "t", "x1")]
    got = _port_slab(mode, (nz_l, ny, nx), pinned, 0, nz, legs, pd, fields)
    assert all(g_.shape == pd.shape for g_ in got)
    for i in range(p):
        _check_slab_against_jax([g_[i] for g_ in got], _jax_slab(mode, shape, p, i, pinned, diag, legs, f),
                                nz_l, nx, ny)


def test_fused_sharded_makes_one_wrapper_call_a_stroke(monkeypatch):
    """``FusedSharded.descent`` / ``ascent`` call K3z / K4z's wrapper once a
    stroke, on the whole (p, ...) stack from global plane 0: on the card,
    one launch a stroke."""
    import tpusparse_torch.dist.fused_sharded as fsm

    calls = []

    def counted(name, fn):
        def wrapper(diag_p, *args, **kw):
            calls.append((name, tuple(diag_p.shape), kw["z0"], kw["nzg"]))
            return fn(diag_p, *args, **kw)
        return wrapper

    monkeypatch.setattr(fsm, "fused7_descent_slab", counted("descent", fused7_descent_slab))
    monkeypatch.setattr(fsm, "fused7_ascent_slab", counted("ascent", fused7_ascent_slab))
    shape, p = (12, 6, 7), 4
    diag, legs, f = _fields(shape)
    fs = FusedSharded.build(star_from_numpy(diag, *legs, True, device="cpu"), make_z_mesh(p, "cpu"))
    b_st, t_st, x1_st = (fs.to_stacked(torch.from_numpy(f[k])) for k in ("b", "t", "x1"))
    fs.descent(b_st, S0, AD, G, GW)
    fs.ascent(t_st, b_st, x1_st, G, AD, G2, GW)
    stack = tuple(fs.diag_st.shape)
    assert stack == (p, 3 + 2 * FACE, 6, 8)
    assert calls == [("descent", stack, 0, 12), ("ascent", stack, 0, 12)]


@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("shape, p", SLABS + [((20, 5, 9), 5)])
def test_slab_twins_over_all_shards_equal_the_unsharded_twin(shape, p, pinned):
    """K3z/K4z's twins on every slab of the exchanged stacked fields against
    K3'/K4''s on the whole field: bit-equal on the domain (the same
    operations on the same values), every face and pad cell 0."""
    nz, ny, nx = shape
    diag, legs, f = _fields(shape)
    star = star_from_numpy(diag, *legs, pinned, device="cpu")
    fs = FusedSharded.build(star, make_z_mesh(p, "cpu"))
    b_st, t_st, x1_st = (fs.to_stacked(torch.from_numpy(f[k])) for k in ("b", "t", "x1"))
    x1s, s = fs.descent(b_st, S0, AD, G, GW)
    x4 = fs.ascent(t_st, b_st, x1_st, G, AD, G2, GW)
    op = PaddedStar.from_star(star)
    pl = (op.diag, op.cx, op.cy, op.cz)
    want_x1, want_s = fused7_descent(*pl, pad_field(torch.from_numpy(f["b"])), S0, AD, G, GW, shape, pinned)
    want_x4 = fused7_ascent(*pl, *(pad_field(torch.from_numpy(f[k])) for k in ("t", "b", "x1")),
                            G, AD, G2, GW, shape, pinned)
    for got, want in ((x1s, want_x1), (s, want_s), (x4, want_x4)):
        assert torch.equal(fs.from_stacked(got), crop_field(want, shape))
        assert (got[:, :FACE] == 0).all() and (got[:, FACE + nz // p:] == 0).all()
        assert (got[..., nx:] == 0).all()


def test_slab_wrappers_refuse_a_slab_outside_the_grid():
    diag, legs, f = _fields((8, 6, 7))
    pd = _port_padded(_slab(diag, 0, 4, 1.0), 1.0)
    pb = _port_padded(_slab(f["b"], 0, 4))
    with pytest.raises(ValueError, match="not inside"):
        fused7_descent_slab(pd, *legs, pb, S0, AD, G, GW, (4, 6, 7), True, 6, 8)
    with pytest.raises(ValueError, match="not inside"):
        fused7_ascent_slab(pd, *legs, pb, pb, pb, G, AD, G2, GW, (4, 6, 7), True, -1, 8)
    # two stacked slabs of 4 planes: from plane 0 they fill the grid of 8,
    # from plane 4 the last one leaves it
    sd, sb = torch.stack([pd, pd]), torch.stack([pb, pb])
    assert fused7_descent_slab(sd, *legs, sb, S0, AD, G, GW, (4, 6, 7), True, 0, 8)[0].shape == sb.shape
    with pytest.raises(ValueError, match="not inside"):
        fused7_descent_slab(sd, *legs, sb, S0, AD, G, GW, (4, 6, 7), True, 4, 8)
    with pytest.raises(ValueError, match="not inside"):
        fused7_ascent_slab(sd, *legs, sb, sb, sb, G, AD, G2, GW, (4, 6, 7), True, 4, 8)
    # stacked and unstacked fields mixed, or a stack that is not contiguous
    with pytest.raises(ValueError, match="padded_shape"):
        fused7_descent_slab(sd, *legs, pb, S0, AD, G, GW, (4, 6, 7), True, 0, 8)
    with pytest.raises(ValueError, match="contiguous"):
        fused7_ascent_slab(sd, *legs, sb, sb, sb.transpose(2, 3).contiguous().transpose(2, 3), G, AD, G2, GW,
                           (4, 6, 7), True, 0, 8)


# --- the sharded V-cycle --------------------------------------------------

@pytest.fixture(scope="module")
def cycle48():
    """tests/test_fused_sharded.py's 12 x 12 x 48 system: the JAX package's
    plain f32 hierarchy (coarse_eq_limit 30) and the port's copy of it, the
    port's ``FusedSharded`` over 4 shards, and b."""
    jop, jb, _ = j_poisson_stencil(JGrid3D(12, 12, 48), dtype=np.float32)
    jh = j_gamg_setup(jop, JAMGParams(coarse_eq_limit=30))
    hier = port_copy(jh)
    fs = FusedSharded.build(hier.levels[0].op, make_z_mesh(4, "cpu"))
    return jh, jb, hier, fs, torch.tensor(np.asarray(jb))


def test_sharded_cycle_matches_jax_plain_vcycle(cycle48):
    """test_sharded_fused_cycle_matches_plain_cycle's gate: within 2e-5 of
    max|z| of the JAX package's plain cycle on the same hierarchy."""
    jh, jb, hier, fs, b = cycle48
    assert fused_sharded_supported(hier)
    want = np.asarray(j_vcycle(jh, jb), np.float64)
    got = vcycle_fused_sharded(fs, hier, b).numpy().astype(np.float64)
    assert np.abs(got - want).max() < 2e-5 * np.abs(want).max()


def test_sharded_cycle_matches_the_fused_cycle(cycle48):
    """Against the port's single-device ``vcycle_fused`` (K3'/K4''s twins)
    on the padded copy of the same hierarchy."""
    jh, jb, hier, fs, b = cycle48
    jph = j_gamg_setup(JPaddedStar.from_star(j_poisson_stencil(JGrid3D(12, 12, 48), dtype=np.float32)[0]),
                       JAMGParams(coarse_eq_limit=30))
    want = crop_field(vcycle_fused(port_copy(jph), pad_field(b)), (48, 12, 12)).double()
    got = vcycle_fused_sharded(fs, hier, b).double()
    assert (got - want).abs().max() < 2e-5 * want.abs().max()


def test_sharded_w_cycle_passes_gamma(cycle48):
    """gamma 2 re-enters the coarse cycle as ``coarse_cycle`` does: against
    the port's plain W-cycle on the same hierarchy."""
    _, _, hier, fs, b = cycle48
    want = vcycle(hier, b, gamma=2).double()
    got = vcycle_fused_sharded(fs, hier, b, gamma=2).double()
    assert (got - want).abs().max() < 2e-5 * want.abs().max()
    assert (got - vcycle(hier, b).double()).abs().max() > 1e-3 * want.abs().max()


def test_seam_transfer_matches_structured(cycle48):
    """The shard-by-shard T^T and T, and restrict / prolong on them, against
    the whole-field contractions: the same sums in another order (T is a
    copy: exact)."""
    _, _, hier, fs, b = cycle48
    tr = hier.levels[0].transfer
    st = ShardedTransfer(tr, fs.mesh)
    rc = st.tT_apply(b)
    torch.testing.assert_close(rc, tr.tT_apply(b), rtol=1e-6, atol=1e-6 * rc.abs().max().item())
    assert torch.equal(st.t_apply(rc), tr.t_apply(rc))
    assert st.c_shape == tr.c_shape and st.omega == tr.omega and st.fop is None
    lev = hier.levels[0]
    for got, want in ((st.restrict(lev.op, lev.dinv, b), tr.restrict(lev.op, lev.dinv, b)),
                      (st.prolong(lev.op, lev.dinv, rc), tr.prolong(lev.op, lev.dinv, rc))):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * want.abs().max().item())


# --- the driver and the CLI --------------------------------------------------

def test_sharded_solve_matches_jax():
    """test_driver_fused_sharded_end_to_end's gate against the JAX
    package's one-device plain solve: counts within 2, Linf within 1e-6 +
    1e-3 of it (rtol 1e-6: at 1e-7 the f32 floor makes counts noise)."""
    kernels.reset_launches()
    got = solve_poisson(12, 12, 48, rtol=1e-6, layout="padded", n_devices=4, device="cpu", view=True)
    want = j_solve_poisson(12, 12, 48, rtol=1e-6, layout="plain")
    assert got.reason > 0 and want.reason > 0
    assert abs(got.iters - want.iters) <= 2
    assert abs(got.linf_error - want.linf_error) < 1e-6 + 1e-3 * abs(want.linf_error)
    assert got.z_shards == 4 and "4 z-shards of 12 planes on one device" in got.solver_view
    assert not any(kernels.LAUNCHES.values())   # CPU tensors: the twins


@pytest.mark.slow
def test_sharded_solve_matches_jax_sharded_solve():
    """Against the JAX package's own sharded route: 8 z-shards (its 8
    virtual devices, interpret-mode kernels) at 12 x 12 x 48."""
    got = solve_poisson(12, 12, 48, rtol=1e-6, layout="padded", n_devices=8, device="cpu")
    want = j_solve_poisson(12, 12, 48, rtol=1e-6, layout="padded", n_devices=8)
    assert got.reason > 0 and want.reason > 0
    assert abs(got.iters - want.iters) <= 2
    assert abs(got.linf_error - want.linf_error) < 1e-6 + 1e-3 * abs(want.linf_error)


def test_devices_through_both_clis():
    """``-devices 4`` at 24^3 through both CLIs (the JAX CLI runs its GSPMD
    route on 4 of its virtual devices): the same outcome, inner within 2."""
    argv = [*_grid(24), "-devices", "4", "-ksp_rtol", "1e-8", "-ksp_atol", "1e-12", "-ksp_converged_reason"]
    from tpusparse.__main__ import main as j_main

    _, want = _run(j_main, argv)
    text, got = _run(main, [*argv, "-device", "cpu"])
    assert (got["reason"], got["outer_iters"]) == (want["reason"], want["outer_iters"]) == (2, 2)
    assert abs(got["iters"] - want["iters"]) <= 2
    assert got["linf_error"] == pytest.approx(want["linf_error"], abs=1e-6)
    assert got["z_shards"] == 4


# --- the other n_devices > 1 routes and the refusals -----------------------------

def test_indivisible_or_thin_shards_raise_value_error():
    """The z mesh refuses shards that do not divide nz or hold fewer than
    FACE planes.  The driver sends such grids to the (z, y) plain route
    (JAX's GSPMD route, which takes them), and refuses a grid that the
    (z, y) mesh does not divide, with JAX's message."""
    diag, legs, _ = _fields((18, 6, 7))
    with pytest.raises(ValueError, match="divisible"):
        FusedSharded.build(star_from_numpy(diag, *legs, True, device="cpu"), make_z_mesh(4, "cpu"))
    with pytest.raises(ValueError, match="divisible"):
        solve_poisson(8, 9, 18, n_devices=4, device="cpu")
    with pytest.raises(ValueError, match="fewer"):
        check_divisible((8, 6, 7), make_z_mesh(4, "cpu"))
    diag, legs, _ = _fields((8, 6, 7))
    with pytest.raises(ValueError, match="fewer"):
        FusedSharded.build(star_from_numpy(diag, *legs, True, device="cpu"), make_z_mesh(4, "cpu"))
    for nz in (18, 8):
        rep = solve_poisson(8, 8, nz, n_devices=4, device="cpu", rtol=1e-6)
        assert rep.reason == 2 and (rep.sharded_route, rep.mesh) == ("(z, y) plain", [2, 2])


QUEUE12 = [
    dict(layout="plain"),
    dict(amg_params=AMGParams(degree=1)),
    dict(amg_params=AMGParams(smoother="richardson", degree=1)),
    dict(amg_params=AMGParams(degree=3)),                       # Chebyshev(3)
    dict(mat_type="aij"),
    dict(mat_type="aij", structure_detect=False),
    dict(precision="f64"),
    dict(precision="f32"),
    dict(pc="jacobi"),
    dict(pc="none"),
    dict(pc="sor"),
    dict(pc_dtype="bf16"),
    dict(amg_params=AMGParams(bjacobi_bs=4)),
    dict(amg_params=AMGParams(coarse_solve="lu")),
    dict(amg_params=AMGParams(smoother="sor", degree=2)),
    # a threshold schedule that filters level 0: (1, 3, 3) on this box
    dict(extent=(1.0, 1.0, 3.0), amg_params=AMGParams(threshold=0.05)),
]
# the JAX driver refuses these with n_devices > 1, in these words
JAX_REFUSED = {"pc=sor": "pc_type='sor' is single-device", "mat_type=aij-structure_detect=False":
               "requires structure_detect"}


def _id(kw):
    return "-".join(f"{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("kw", QUEUE12, ids=_id)
def test_other_routes_raise_naming_queue_12(kw):
    """Every route that raised naming queue 12 before the split solve was
    ported: the two the JAX driver refuses raise its words; the others run
    (the fused z route for the lifted aij matrix, the (z, y) plain route
    for the rest) to the outcome of the same options on one device: the
    same reason, inner within 2, Linf within 1e-6 + 1e-3 |Linf|."""
    if _id(kw) in JAX_REFUSED:
        with pytest.raises(NotImplementedError, match=JAX_REFUSED[_id(kw)]):
            solve_poisson(12, n_devices=4, device="cpu", rtol=1e-6, **kw)
        return
    got = solve_poisson(12, n_devices=4, device="cpu", rtol=1e-6, **kw)
    one = solve_poisson(12, device="cpu", rtol=1e-6, **kw)
    assert got.reason == one.reason > 0 and got.outer_iters == one.outer_iters
    assert abs(got.iters - one.iters) <= 2
    assert abs(got.linf_error - one.linf_error) < 1e-6 + 1e-3 * abs(one.linf_error)
    route = ("fused z", [4, 1]) if kw == {"mat_type": "aij"} else ("(z, y) plain", [2, 2])
    assert (got.sharded_route, got.mesh, got.ranks) == (*route, 1)


def test_multi_device_mesh_and_cg_fusion_are_refused():
    """A mesh takes this rank's one device (its ranks come from the process
    group); the full-fusion body is single-device."""
    with pytest.raises(ValueError, match="one device"):
        make_z_mesh(2, ["cpu", "cpu"])
    with pytest.raises(ValueError, match="single-device"):
        solve_poisson(12, n_devices=4, device="cpu", cg_fusion=True)


@pytest.mark.parametrize(
    "argv, refused",
    [
        (["-devices", "4"], None),
        (["-devices", "4", "-pc_mg_cycle_type", "w"], None),
        (["-devices", "4", "-layout", "plain"], None),
        (["-devices", "4", "-mg_levels_ksp_max_it", "3"], None),
        (["-devices", "4", "-mat_type", "aij"], None),
        (["-devices", "4", "-pc_type", "jacobi"], None),
        (["-devices", "4", "-pc_type", "sor"], "pc_type='sor' is single-device"),
        (["-devices", "4", "-mat_type", "aij", "-mat_structure_detect", "0"], "requires structure_detect"),
    ],
)
def test_devices_option_refused_off_the_sharded_route(argv, refused):
    """The options database takes every -devices option set the JAX driver
    runs, and refuses what it refuses, in its words."""
    if refused:
        with pytest.raises(NotImplementedError, match=refused):
            load_options(argv)
    else:
        assert load_options(argv).devices == 4


def test_sharded_cycle_refuses_a_filtered_level0(cycle48):
    """The threshold schedule's filtered P smoother at level 0 has no sharded
    form (JAX's sharded route passes no filtered legs: ROADMAP §3)."""
    import dataclasses

    _, _, hier, fs, b = cycle48
    lev = hier.levels[0]
    tr = dataclasses.replace(lev.transfer, fop=dataclasses.replace(lev.op, cz=0.0))
    filtered = dataclasses.replace(hier, levels=[dataclasses.replace(lev, transfer=tr), *hier.levels[1:]])
    assert not fused_sharded_supported(filtered)
    with pytest.raises(ValueError, match="unfiltered"):
        vcycle_fused_sharded(fs, filtered, b)


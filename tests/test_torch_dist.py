"""The split solve's pieces against the JAX package's ``dist``: the (z, y)
mesh and its validation (``make_mesh``, ``check_divisible``), K1h's twin
(``star7_mv_halo``) block by block and ``halo_mv`` against JAX's
``halo_mv`` on its 8 virtual devices, the (z, y) ``ShardedTransfer``
against JAX's seam, and ``shard_hierarchy`` / ``shard_system``, all in one
process (W = 1: every block here).

On the CPU every wrapper runs its twin; ``test_torch_cuda.py`` holds K1h
against its twin and K1p on the card, ``test_torch_multihost.py`` runs the
blocks on gloo ranks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.amg.hierarchy import gamg_setup as j_gamg_setup
from tpusparse.dist import make_mesh as j_make_mesh
from tpusparse.dist import shard_hierarchy as j_shard_hierarchy
from tpusparse.dist import shard_system as j_shard_system
from tpusparse.dist.halo import halo_mv as j_halo_mv
from tpusparse.dist.mesh import _factor2 as j_factor2
from tpusparse.dist.mesh import check_divisible as j_check_divisible
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import poisson_stencil as j_poisson_stencil
from tpusparse_torch import kernels
from tpusparse_torch.amg.hierarchy import AMGParams, gamg_setup, vcycle
from tpusparse_torch.dist import (
    HaloStar,
    ShardedTransfer,
    check_divisible,
    halo_mv,
    make_mesh,
    make_z_mesh,
    shard_hierarchy,
    shard_system,
)
from tpusparse_torch.dist.halo import block_ghosts
from tpusparse_torch.dist.mesh import _factor2
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil_device
from tpusparse_torch.interop import star_from_numpy
from tpusparse_torch.kernels.stencil7 import star7_mv_halo, star7_mv_halo_torch, star7_mv_torch
from torch_parity import port_copy

# (nz, ny, nx) = (8, 4, 6): the (8, 1) mesh has one-plane blocks in z, the
# (2, 4) mesh one-plane blocks in y
HALO_SHAPE = (8, 4, 6)
MESHES = [(8, 1), (4, 2), (2, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _systems(shape, pin=True, dtype=np.float32):
    """The JAX package's Poisson operator on ``shape`` and the port's copy,
    and a seeded field x (numpy)."""
    nz, ny, nx = shape
    jop = j_poisson_stencil(JGrid3D(nx, ny, nz), dtype=dtype, pin=pin)[0]
    op = star_from_numpy(np.asarray(jop.diag), float(jop.cx), float(jop.cy), float(jop.cz), bool(jop.pinned),
                         device="cpu")
    x = np.random.default_rng(3).standard_normal(shape).astype(dtype)
    return jop, op, x


# --- the mesh ---------------------------------------------------------------

def test_factor2_and_mesh_shapes_match_jax():
    for n in range(1, 17):
        assert _factor2(n) == j_factor2(n)
        mesh, jmesh = make_mesh(n), j_make_mesh(n) if n <= 8 else None
        assert (mesh.pz, mesh.py, mesh.world, mesh.rank, mesh.group) == (*_factor2(n), 1, 0, None)
        if jmesh is not None:
            assert {"z": mesh.pz, "y": mesh.py} == dict(jmesh.shape)
    assert (make_mesh(8, (2, 4)).pz, make_mesh(8, (2, 4)).py) == (2, 4)
    assert (make_z_mesh(4).pz, make_z_mesh(4).py) == (4, 1)


@pytest.mark.parametrize("shape, mesh", [((12, 9, 5), (4, 2)), ((10, 8, 5), (4, 2)), ((16, 8, 8), (2, 3))])
def test_check_divisible_raises_jax_message(shape, mesh):
    n = mesh[0] * mesh[1]
    with pytest.raises(ValueError) as want:
        j_check_divisible(shape, j_make_mesh(n, shape=mesh))
    with pytest.raises(ValueError) as got:
        check_divisible(shape, make_mesh(n, mesh))
    assert str(got.value) == str(want.value)


def test_mesh_blocks_and_refusals():
    mesh = make_mesh(8, (4, 2))
    blocks = mesh.blocks((12, 6, 5))
    assert [(b.z0, b.gz0, b.y0, b.nz, b.ny) for b in blocks[:3]] == [(0, 0, 0, 3, 3), (0, 0, 3, 3, 3),
                                                                     (3, 3, 0, 3, 3)]
    assert len(blocks) == 8 and mesh.rows(12) == slice(0, 12) and mesh.local_shape((12, 6, 5)) == (12, 6, 5)
    assert mesh.exchange(torch.zeros(2), torch.zeros(2)) == (None, None)
    t = torch.ones(())
    assert mesh.allreduce(t) is t
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh(8, (3, 2))
    with pytest.raises(ValueError, match="one device"):
        make_mesh(2, device=["cpu", "cpu"])
    with pytest.raises(ValueError, match="fewer"):
        check_divisible((8, 6, 7), make_z_mesh(4))
    check_divisible((8, 6, 7), make_mesh(8, (8, 1)))   # one-plane blocks: the (z, y) route takes them


# --- K1h's twin and the halo apply ---------------------------------------------

@pytest.mark.parametrize("pin", [True, False])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_halo_apply_matches_jax_halo_mv(mesh_shape, pin):
    """K1h's twin on each block with its ghost planes, put together, against
    JAX's ``halo_mv`` over ``make_mesh(8, shape)`` (f32 rounding), and bit
    for bit ``star7_mv_torch`` on the global field."""
    jop, op, x = _systems(HALO_SHAPE, pin)
    jmesh = j_make_mesh(8, shape=mesh_shape)
    jop_s, jx_s, _ = j_shard_system(jop, jnp.asarray(x), jnp.asarray(x), jmesh)
    want = np.asarray(j_halo_mv(jop_s, jx_s, jmesh))
    mesh = make_mesh(8, mesh_shape)
    xt = torch.from_numpy(x)
    kernels.reset_launches()
    got = halo_mv(HaloStar.build(op, mesh), xt, mesh)
    assert not any(kernels.LAUNCHES.values())   # CPU tensors: the twin
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    assert torch.equal(got, star7_mv_torch(op.diag, op.cx, op.cy, op.cz, xt, op.pinned))
    # block by block: the wrapper on each block's views and ghosts
    for blk in mesh.blocks(HALO_SHAPE):
        zs, ys = slice(blk.z0, blk.z0 + blk.nz), slice(blk.y0, blk.y0 + blk.ny)
        origin = 0 if pin and blk.z0 == blk.y0 == 0 else -1
        y = star7_mv_halo(op.diag[zs, ys], op.cx, op.cy, op.cz, xt[zs, ys], *block_ghosts(xt, None, None, blk, pin),
                          origin)
        assert torch.equal(y, got[zs, ys])


def test_halo_apply_of_f64_and_bf16_is_the_torch_apply():
    """Off f32 the rank's slab is one block through the torch arithmetic:
    bit for bit ``star7_mv_torch`` (the single-device apply of those
    dtypes)."""
    for dtype in (torch.float64, torch.bfloat16):
        op = poisson_stencil_device(Grid3D(6, 4, 8), dtype=dtype, device="cpu")[0]
        x = torch.from_numpy(np.random.default_rng(4).standard_normal((8, 4, 6))).to(dtype)
        mesh = make_mesh(4, (2, 2))
        assert torch.equal(HaloStar.build(op, mesh).mv(x), star7_mv_torch(op.diag, op.cx, op.cy, op.cz, x, True))


def test_halo_twin_ghosts_and_origin():
    """The twin reads its ghosts in place of the neighbours past its
    faces, None as zero, and keeps only diag x in the origin's row."""
    nz, ny, nx = 3, 2, 4
    rng = np.random.default_rng(1)
    diag, x = (torch.from_numpy(rng.standard_normal((nz, ny, nx))) for _ in range(2))
    zlo, zhi = (torch.from_numpy(rng.standard_normal((ny, nx))) for _ in range(2))
    ylo, yhi = (torch.from_numpy(rng.standard_normal((nz, nx))) for _ in range(2))
    big = torch.zeros((nz + 2, ny + 2, nx))
    big = big.double()
    big[1:-1, 1:-1], big[0, 1:-1], big[-1, 1:-1], big[1:-1, 0], big[1:-1, -1] = x, zlo, zhi, ylo, yhi
    bdiag = torch.ones_like(big)
    bdiag[1:-1, 1:-1] = diag
    want = star7_mv_torch(bdiag, 0.5, 0.25, 0.125, big, False)[1:-1, 1:-1]
    assert torch.equal(star7_mv_halo_torch(diag, 0.5, 0.25, 0.125, x, zlo, zhi, ylo, yhi), want)
    got = star7_mv_halo_torch(diag, 0.5, 0.25, 0.125, x, None, None, None, None, origin=0)
    assert torch.equal(got, star7_mv_torch(diag, 0.5, 0.25, 0.125, x, True))


def test_halo_wrapper_checks():
    x = torch.ones((4, 3, 5))
    with pytest.raises(ValueError, match="ghost zlo"):
        star7_mv_halo(x, 1.0, 1.0, 1.0, x, torch.ones((4, 5)), None, None, None)
    with pytest.raises(TypeError, match="float32"):
        star7_mv_halo(x.double(), 1.0, 1.0, 1.0, x.double(), None, None, None, None)
    with pytest.raises(ValueError, match="out"):
        star7_mv_halo(x, 1.0, 1.0, 1.0, x, None, None, None, None, out=torch.ones((4, 3, 6)))
    with pytest.raises(ValueError, match="diag"):
        star7_mv_halo(torch.ones((4, 4, 5))[:, :3], 1.0, 1.0, 1.0, x, None, None, None, None)
    with pytest.raises(ValueError, match="one \\(nz, ny, nx\\) block"):
        star7_mv_halo(x[0], 1.0, 1.0, 1.0, x[0], None, None, None, None)
    op = poisson_stencil_device(Grid3D(5, 3, 4), dtype=torch.float32, device="cpu")[0]
    with pytest.raises(ValueError, match="slab"):
        HaloStar.build(op, make_mesh(2)).mv(torch.ones((2, 3, 5)))


def test_gs_color_masks_are_the_global_ones_on_the_slab():
    op = poisson_stencil_device(Grid3D(5, 4, 6), dtype=torch.float64, device="cpu")[0]
    hs = HaloStar.build(op, make_mesh(2))
    for got, want in zip(hs.gs_color_masks(), op.gs_color_masks()):
        assert torch.equal(got, want.expand(op.grid_shape))


# --- the seam and the placement ------------------------------------------------

@pytest.fixture(scope="module")
def seam_system():
    """tests/test_seam.py's 16 x 16 x 24 f32 system (coarse_eq_limit 30):
    the JAX hierarchy and the port's copy, and a seeded residual."""
    jop, jb, jexact = j_poisson_stencil(JGrid3D(16, 16, 24), dtype=np.float32)
    jh = j_gamg_setup(jop, JAMGParams(coarse_eq_limit=30))
    r = np.random.default_rng(7).standard_normal((24, 16, 16)).astype(np.float32)
    return jop, jb, jexact, jh, port_copy(jh), r


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_transfer_matches_jax_seam(seam_system, mesh_shape):
    """T^T and T block by block (the JAX package's seam, ``shard_map``
    over the same mesh) within 1e-6; restrict / prolong through the
    sharded operator against the unsharded transfer."""
    jop, jb, jexact, jh, hier, r = seam_system
    jmesh = j_make_mesh(8, shape=mesh_shape)
    jtr = j_shard_hierarchy(jh, jmesh).levels[0].transfer
    _, jr, _ = j_shard_system(jop, jnp.asarray(r), jexact, jmesh)
    hs = shard_hierarchy(hier, make_mesh(8, mesh_shape))
    st = hs.levels[0].transfer
    assert isinstance(st, ShardedTransfer) and st.fop is None
    rt = torch.from_numpy(r)
    rc = st.tT_apply(rt)
    want = np.asarray(jtr.tT_apply(jr))
    np.testing.assert_allclose(rc.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    ec = np.array(want)
    want_t = np.asarray(jtr.t_apply(jnp.asarray(ec)))
    np.testing.assert_allclose(st.t_apply(torch.from_numpy(ec)).numpy(), want_t, rtol=1e-6,
                               atol=1e-6 * np.abs(want_t).max())
    tr, lev, slev = hier.levels[0].transfer, hier.levels[0], hs.levels[0]
    for got, want in ((st.restrict(slev.op, slev.dinv, rt), tr.restrict(lev.op, lev.dinv, rt)),
                      (st.prolong(slev.op, slev.dinv, rc), tr.prolong(lev.op, lev.dinv, rc))):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * want.abs().max().item())


def test_shard_hierarchy_places_level0_only(seam_system):
    """Level 0's operator a ``HaloStar``, its transfer seam-wrapped, the
    coarse levels the very objects built; the sharded V-cycle equals the
    unsharded one to f32 rounding (the seam sums in block order)."""
    _, _, _, _, hier, r = seam_system
    hs = shard_hierarchy(hier, make_mesh(8))
    lev0 = hs.levels[0]
    assert isinstance(lev0.op, HaloStar) and lev0.op.grid_shape == (24, 16, 16) and lev0.bjac is None
    assert all(a is b for a, b in zip(hs.levels[1:], hier.levels[1:]))
    rt = torch.from_numpy(r)
    want = vcycle(hier, rt)
    torch.testing.assert_close(vcycle(hs, rt), want, rtol=1e-5, atol=2e-6 * want.abs().max().item())


def test_shard_hierarchy_shards_the_filtered_p_smoother_and_drops_bjac():
    """A threshold schedule's filtered ``fop`` is sharded like the operator
    (``tpusparse/dist/mesh.py:132-144``); level 0's block-Jacobi sub-PC is
    dropped, as JAX's rebuild of level 0 from four fields drops it."""
    op = poisson_stencil_device(Grid3D(12, 12, 12), dtype=torch.float32, device="cpu")[0]
    hier = gamg_setup(op, AMGParams(bjacobi_bs=4))
    assert hier.levels[0].bjac is not None
    lev = hier.levels[0]
    tr = dataclasses.replace(lev.transfer, fop=dataclasses.replace(lev.op, cz=0.0))
    hier = dataclasses.replace(hier, levels=[dataclasses.replace(lev, transfer=tr), *hier.levels[1:]])
    hs = shard_hierarchy(hier, make_mesh(4))
    fop = hs.levels[0].transfer.fop
    assert isinstance(fop, HaloStar) and fop.cz == 0.0 and hs.levels[0].bjac is None
    assert hs.levels[1].bjac is hier.levels[1].bjac
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((12, 12, 12)).astype(np.float32))
    assert torch.equal(fop.mv(x), tr.fop.mv(x))


def test_shard_system_slices_and_refuses():
    op, b, exact = poisson_stencil_device(Grid3D(6, 4, 8), device="cpu")
    hs, bs, es = shard_system(op, b, exact, make_mesh(4))
    assert bs is b and es is exact and hs.local_shape == (8, 4, 6)
    with pytest.raises(ValueError, match="divisible"):
        shard_system(op, b, exact, make_mesh(3))
    with pytest.raises(TypeError, match="StarStencil3D"):
        HaloStar.build(gamg_setup(poisson_stencil_device(Grid3D(9, 9, 9), dtype=torch.float32, device="cpu")[0])
                       .levels[1].op, make_mesh(1))

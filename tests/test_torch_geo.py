"""Geometric GAMG parity for the general-matrix path: the port's
``amg/geo.py`` and ``amg/unstructured.py`` against the JAX package's on
the same numpy inputs — grid inference, the transfers, the Galerkin probe,
the whole device-resident setup at 24^3, and one V-cycle on a copy of the
JAX hierarchy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.amg.geo import GeoTransfer as JGeoTransfer
from tpusparse.amg.geo import block_weight_field_dev as j_block_weight_field_dev
from tpusparse.amg.geo import galerkin_probe_geo as j_galerkin_probe_geo
from tpusparse.amg.geo import gamg_setup_geo as j_gamg_setup_geo
from tpusparse.amg.geo import grid_reach as j_grid_reach
from tpusparse.amg.geo import infer_grid3d as j_infer_grid3d
from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.amg.hierarchy import vcycle as j_vcycle
from tpusparse.amg.unstructured import gamg_setup_unstructured as j_gamg_setup_unstructured
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import poisson_dia_device as j_poisson_dia_device
from tpusparse.sparse.dia import DIA as JDIA
from tpusparse_torch.amg.geo import (
    GeoTransfer,
    block_weight_field_dev,
    galerkin_probe_geo,
    gamg_setup_geo,
    geo_block_sizes,
    grid_reach,
    infer_grid3d,
)
from tpusparse_torch.amg.hierarchy import AMGParams, vcycle
from tpusparse_torch.amg.unstructured import gamg_setup_unstructured
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_dia_device, poisson_stencil_device
from tpusparse_torch.interop import dia_from_numpy, hierarchy_from_numpy
from tpusparse_torch.sparse.dia import DIA

N = 24
SHAPE = (6, 5, 7)          # (nz, ny, nx): ragged against the 3^3 blocks


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _star(shape):
    nz, ny, nx = shape
    offs = {0}
    if nx > 1:
        offs |= {1, -1}
    if ny > 1:
        offs |= {nx, -nx}
    if nz > 1:
        offs |= {nx * ny, -(nx * ny)}
    return tuple(sorted(offs)), nz * ny * nx


def _box27(shape):
    nz, ny, nx = shape
    offs = {dz * nx * ny + dy * nx + dx
            for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)}
    return tuple(sorted(offs)), nz * ny * nx


# the cases of tests/test_geo.py:27-72, refusals included
GRID_CASES = [
    _star((30, 30, 30)), _star((4, 4, 4)), _star((5, 7, 11)), _star((1, 12, 9)),
    _star((16, 1, 8)), _box27((6, 5, 7)),
    (tuple(range(-150, 151)), 2744),   # a solid band (RCM-reordered 14^3)
    ((-1, 0, 1), 100),                 # tridiagonal
    ((0, 5, -5, 1, -1), 99),           # 99 % 5 != 0
    ((0, 7, 1), 49),                   # nonsymmetric
]


@pytest.mark.parametrize("offsets, n", GRID_CASES)
def test_infer_grid3d_matches_jax(offsets, n):
    assert infer_grid3d(offsets, n) == j_infer_grid3d(offsets, n)


def test_infer_grid3d_finds_the_grids():
    assert infer_grid3d(*_box27(SHAPE)) == SHAPE
    assert infer_grid3d(*_star((24, 24, 24))) == (24, 24, 24)
    assert infer_grid3d((-1, 0, 1), 100) is None


@pytest.mark.parametrize("offsets", [_star(SHAPE)[0], _box27(SHAPE)[0], (-71, -3, 0, 2, 70)])
def test_grid_reach_matches_jax(offsets):
    assert grid_reach(offsets, SHAPE) == j_grid_reach(offsets, SHAPE)


def test_block_weights_match_jax():
    bs = geo_block_sizes(SHAPE, 3)
    got = block_weight_field_dev(SHAPE, bs, torch.float32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_block_weight_field_dev(SHAPE, bs)))


def _operator(shape, nonsymmetric: bool, seed=0):
    """f32 bands on the 7-point offsets of ``shape``: the pinned Poisson, or
    random nonsymmetric couplings on its pattern with a dominant diagonal."""
    nz, ny, nx = shape
    _, jop, _, _ = j_poisson_dia_device(JGrid3D(nx, ny, nz))
    bands = np.asarray(jop.bands).copy()
    if nonsymmetric:
        rng = np.random.default_rng(seed)
        bands = np.where(bands != 0, rng.uniform(0.5, 1.5, bands.shape), 0).astype(np.float32)
        bands[3] = -8.0 - rng.uniform(0.0, 1.0, bands.shape[1]).astype(np.float32)
    return bands, jop.offsets


def _transfers(shape, bands, offsets, omega=0.71):
    """(port DIA, JAX DIA, port dinv, JAX dinv, port transfer, JAX transfer)."""
    n = int(np.prod(shape))
    bs = geo_block_sizes(shape, 3)
    dinv = (1.0 / bands[offsets.index(0)]).astype(np.float32)
    w_c = np.asarray(j_block_weight_field_dev(shape, bs)).reshape(-1)
    jtr = JGeoTransfer.build(w=jnp.asarray(w_c), omega=jnp.asarray(omega, jnp.float32),
                             fine_shape=shape, bs=bs)
    w = np.asarray(jtr._up(jnp.asarray(w_c)))
    jtr = JGeoTransfer.build(w=jnp.asarray(w), omega=jnp.asarray(omega, jnp.float32),
                             fine_shape=shape, bs=bs)
    tr = GeoTransfer.build(omega=float(np.float32(omega)), fine_shape=shape, bs=bs, device="cpu")
    return (
        dia_from_numpy(bands, offsets, (n, n), device="cpu"),
        JDIA(bands=jnp.asarray(bands), offsets=offsets, shape=(n, n)),
        torch.tensor(dinv), jnp.asarray(dinv), tr, jtr,
    )


def test_geo_transfer_matches_jax():
    bands, offsets = _operator(SHAPE, nonsymmetric=False)
    op, jop, dinv, jdinv, tr, jtr = _transfers(SHAPE, bands, offsets)
    for name in ("sz", "sy", "sx", "w"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(), np.asarray(getattr(jtr, name)))
    assert tr.coarse_shape == tuple(jtr.coarse_shape) == (2, 2, 3)
    rng = np.random.default_rng(3)
    e_c = rng.standard_normal(int(np.prod(tr.coarse_shape)), dtype=np.float32)
    x = rng.standard_normal(int(np.prod(SHAPE)), dtype=np.float32)
    want = np.asarray(jtr.prolong(jop, jdinv, jnp.asarray(e_c)))
    got = tr.prolong(op, dinv, torch.tensor(e_c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    want = np.asarray(jtr.restrict(jop, jdinv, jnp.asarray(x)))
    got = tr.restrict(op, dinv, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("nonsymmetric", [False, True])
def test_galerkin_probe_matches_jax(nonsymmetric):
    """The probe writes band k of row r where column r + d3 is a comb
    member; the nonsymmetric case fails if rows and columns are swapped."""
    bands, offsets = _operator(SHAPE, nonsymmetric)
    op, jop, dinv, jdinv, tr, jtr = _transfers(SHAPE, bands, offsets)
    want = j_galerkin_probe_geo(jop, jdinv, jtr)
    got = galerkin_probe_geo(op, dinv, tr)
    assert got.offsets == want.offsets and got.shape == tuple(want.shape) == (12, 12)
    wb = np.asarray(want.bands)
    np.testing.assert_allclose(got.bands.numpy(), wb, rtol=1e-5, atol=1e-6 * np.abs(wb).max())


@pytest.fixture(scope="module")
def jax_hier():
    """The JAX geometric setup evaluated op by op (compiled, XLA fuses the
    rho start vector's multiply-add; see tests/test_torch_amg.py)."""
    _, jop, _, _ = j_poisson_dia_device(JGrid3D(N, N, N))
    with jax.disable_jit():
        return j_gamg_setup_geo(jop, (N, N, N), JAMGParams())


@pytest.fixture(scope="module")
def port_hier():
    _, op, _, _ = poisson_dia_device(Grid3D(N, N, N), device="cpu")
    return gamg_setup_unstructured(None, AMGParams(), fine_op=op)


def test_setup_levels_match_jax(jax_hier, port_hier):
    assert port_hier.n_levels == jax_hier.n_levels == 3
    sizes = [lev.op.n_rows for lev in port_hier.levels]
    assert sizes == [lev.op.shape[0] for lev in jax_hier.levels] == [24**3, 8**3, 3**3]
    for plev, jlev in zip(port_hier.levels, jax_hier.levels):
        assert plev.op.offsets == tuple(jlev.op.offsets)
        assert isinstance(plev.op, DIA) and plev.op.dtype == torch.float32
        assert plev.rho == pytest.approx(float(jlev.rho), rel=1e-5)
    for plev, jlev in zip(port_hier.levels[:-1], jax_hier.levels[:-1]):
        assert plev.transfer.omega == pytest.approx(float(jlev.transfer.omega), rel=1e-5)
        assert plev.transfer.bs == tuple(jlev.transfer.bs)
        np.testing.assert_array_equal(plev.transfer.w.numpy(), np.asarray(jlev.transfer.w))
    assert port_hier.levels[-1].transfer is None


def test_setup_bands_match_jax(jax_hier, port_hier):
    for plev, jlev in zip(port_hier.levels, jax_hier.levels):
        want = np.asarray(jlev.op.bands)
        np.testing.assert_allclose(
            plev.op.bands.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max(),
        )


def jax_levels(jh):
    """The JAX hierarchy as the numpy level dicts of ``hierarchy_from_numpy``."""
    out = []
    for lev in jh.levels:
        tr = lev.transfer
        out.append({
            "op": {"bands": np.asarray(lev.op.bands), "offsets": lev.op.offsets,
                   "shape": lev.op.shape},
            "dinv": np.asarray(lev.dinv),
            "rho": np.asarray(lev.rho),
            "transfer": None if tr is None else {
                "w": np.asarray(tr.w), "omega": np.asarray(tr.omega),
                "sz": np.asarray(tr.sz), "sy": np.asarray(tr.sy), "sx": np.asarray(tr.sx),
                "fine_shape": tr.fine_shape, "bs": tr.bs,
            },
        })
    return out


def test_vcycle_on_the_jax_hierarchy(jax_hier):
    ph = hierarchy_from_numpy(
        jax_levels(jax_hier), damping=np.asarray(jax_hier.damping),
        smoother=jax_hier.smoother, degree=jax_hier.degree,
        cheby_lo=jax_hier.cheby_lo, cheby_hi=jax_hier.cheby_hi, device="cpu",
    )
    r = np.random.default_rng(5).standard_normal(N**3, dtype=np.float32)
    want = np.asarray(j_vcycle(jax_hier, jnp.asarray(r)))
    got = vcycle(ph, torch.tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_gamg_setup_geo_needs_no_host_matrix():
    """A ragged grid (10, 13, 11) coarsens to 4 x 5 x 4 = 80 rows and stops."""
    _, op, _, _ = poisson_dia_device(Grid3D(11, 13, 10), device="cpu")
    hier = gamg_setup_geo(op, (10, 13, 11), AMGParams())
    assert [lev.op.n_rows for lev in hier.levels] == [1430, 80]
    assert hier.levels[0].transfer.coarse_shape == (4, 5, 4)


@pytest.mark.parametrize(
    "params, err",
    [
        # block Jacobi on the aij route leaves the geometric setup for the
        # host one, whose blocks need the host CSR: without it JAX raises
        # the same ValueError (the LU coarse solve that stood here is ported)
        (AMGParams(bjacobi_bs=4), ValueError),
        (AMGParams(bjacobi_bs=6), ValueError),
        (AMGParams(coarse_solve="cholesky"), ValueError),
        (AMGParams(smoother="sor"), ValueError),
        (AMGParams(nsmooths=-1), ValueError),
    ],
)
def test_setup_refuses_unported_routes(params, err):
    _, op, _, _ = poisson_dia_device(Grid3D(6, 6, 6), device="cpu")
    with pytest.raises(err):
        gamg_setup_unstructured(None, params, fine_op=op)


def test_setup_refuses_non_grid_patterns():
    """A non-grid pattern with no host matrix takes the banded route, as in
    JAX (it was refused before item 9.2); a fine operator that is not
    banded is still refused (the DIA family's uniform-f64 two-float
    operator is banded, and takes the geometric route)."""
    n = 1000
    bands = torch.tensor([[-1.0] * n, [2.5] * n, [-1.0] * n])
    tri = DIA(bands=bands, offsets=(-1, 0, 1), shape=(n, n))
    hier = gamg_setup_unstructured(None, AMGParams(), fine_op=tri)
    want = j_gamg_setup_unstructured(
        None, JAMGParams(), fine_op=JDIA(bands=jnp.asarray(bands.numpy()), offsets=(-1, 0, 1), shape=(n, n)),
    )
    assert [lev.op.n_rows for lev in hier.levels] == [lev.op.shape[0] for lev in want.levels]
    assert type(hier.levels[0].transfer).__name__ == type(want.levels[0].transfer).__name__ == "SegTransfer"
    star = poisson_stencil_device(Grid3D(6, 6, 6), device="cpu")[0]
    with pytest.raises(ValueError, match="StarStencil3D"):
        gamg_setup_unstructured(None, AMGParams(), fine_op=star)

"""``tpusparse_torch/sparse/griddia.py`` and the 3-D view of ``DFDIA``
against the JAX package on the CPU: ``shift3``, the offset decomposition
and the wrap check, ``GridDIA`` against JAX's and against the flat DIA bit
for bit in f64 (``test_griddia_matches_flat_dia``), ``DFDIA(grid=...)``
against JAX's and against its flat form, a JAX ``GridDIA`` carried across
by ``interop``, the GridDIA fine level's solve with JAX's counts
(``test_geo_hierarchy_with_griddia_fine_level_solves``) and its flat view
on the row mesh."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse.amg import AMGParams as JAMGParams
from tpusparse.amg import vcycle as j_vcycle
from tpusparse.amg.unstructured import gamg_setup_unstructured as j_setup
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import assemble_poisson as j_assemble_poisson
from tpusparse.solve import cg as j_cg
from tpusparse.sparse.csr import HostCSR as JHostCSR
from tpusparse.sparse.dia import DFDIA as JDFDIA
from tpusparse.sparse.dia import DIA as JDIA
from tpusparse.sparse.griddia import GridDIA as JGridDIA
from tpusparse.sparse.griddia import _decompose as j_decompose
from tpusparse.sparse.griddia import host_grid_view as j_host_grid_view
from tpusparse.sparse.griddia import shift3 as j_shift3
from tpusparse_torch.amg.hierarchy import AMGParams, vcycle
from tpusparse_torch.amg.unstructured import gamg_setup_unstructured
from tpusparse_torch.dist.general import DistDIA, make_row_mesh, shard_unstructured_hierarchy
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_dia_device
from tpusparse_torch.interop import dfdia_from_numpy, hierarchy_from_numpy, host_csr_from_numpy
from tpusparse_torch.solve.cg import cg
from tpusparse_torch.sparse.dia import DFDIA, DIA
from tpusparse_torch.sparse.griddia import GridDIA, _decompose, host_grid_view, shift3
from torch_parity import jax_levels

SHAPE = (6, 5, 7)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(m):
    j = JHostCSR.from_scipy(sp.csr_matrix(m))
    return j, host_csr_from_numpy(j.indptr, j.indices, j.data, j.shape)


def _grid_poisson(shape=SHAPE):
    a, b, exact = j_assemble_poisson(JGrid3D(shape[2], shape[1], shape[0]))
    return a, b, exact


@pytest.mark.parametrize("d3", [(0, 0, 0), (1, 0, 0), (0, -1, 0), (0, 0, 2), (-2, 1, -1), (5, 0, 0), (0, 0, -7)])
def test_shift3_matches_jax(d3):
    x = np.random.default_rng(0).standard_normal(SHAPE)
    np.testing.assert_array_equal(shift3(torch.from_numpy(x), d3).numpy(), np.asarray(j_shift3(jnp.asarray(x), d3)))


@pytest.mark.parametrize("shape", [SHAPE, (1, 4, 9), (3, 1, 4), (12, 12, 12)])
def test_decompose_matches_jax(shape):
    nz, ny, nx = shape
    for o in range(-nz * ny * nx, nz * ny * nx + 1):
        assert _decompose(o, shape) == j_decompose(o, shape), o


def test_griddia_matches_flat_dia_and_jax():
    """3-D field-shift mv == flat-shift mv, bit for bit in f64, at every
    grid edge; a wrap-violating matrix is refused by both packages."""
    a, _, _ = _grid_poisson()
    ja, ta = _pair(a.to_scipy())
    bands, offs, _ = DIA.host_bands(ta)
    d3s = host_grid_view(bands, offs, SHAPE)
    assert d3s is not None and d3s == j_host_grid_view(*JDIA.host_bands(ja)[:2], SHAPE)
    d = DIA.from_csr(ta, device="cpu")
    g = GridDIA(bands=d.bands, offsets=offs, d3s=d3s, grid_shape=SHAPE)
    jg = JGridDIA(bands=JDIA.from_csr(ja).bands, offsets=offs, d3s=d3s, grid_shape=SHAPE)
    x = np.random.default_rng(0).standard_normal(a.n_rows)
    y = g.mv(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y, d.mv(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(y, np.asarray(jg.mv(jnp.asarray(x))))
    np.testing.assert_array_equal(g.diagonal().numpy(), d.diagonal().numpy())
    assert g.shape == jg.shape == d.shape and g.n_rows == g.n_cols == a.n_rows and g.dtype == torch.float64
    assert (abs(g.to_scipy() - a.to_scipy()) > 0).nnz == 0
    bad = a.to_scipy().tolil()
    r = SHAPE[2] - 1
    bad[r, r + 1] = 99.0  # the x-edge cell (0, 0, nx-1) wraps to (0, 1, 0)
    jb, tb = _pair(bad.tocsr())
    assert host_grid_view(*DIA.host_bands(tb)[:2], SHAPE) is None
    assert j_host_grid_view(*JDIA.host_bands(jb)[:2], SHAPE) is None


@pytest.mark.parametrize("validate", [True, False])
def test_from_dia_and_to_dia(validate):
    a, _, _ = _grid_poisson()
    ja, ta = _pair(a.to_scipy())
    d = DIA.from_csr(ta, device="cpu")
    g = GridDIA.from_dia(d, SHAPE, validate=validate)
    jg = JGridDIA.from_dia(JDIA.from_csr(ja), SHAPE, validate=validate)
    assert g.d3s == jg.d3s and g.grid_shape == jg.grid_shape == SHAPE
    flat = g.to_dia()
    assert flat.offsets == d.offsets and flat.shape == d.shape and flat.bands is d.bands
    # an offset past the grid (dz = 6 on 6 planes) keeps the flat form in
    # both packages
    far = np.zeros((2, a.n_rows))
    far[1, :10] = 1.0
    assert GridDIA.from_dia(DIA(bands=torch.from_numpy(far), offsets=(0, 200), shape=d.shape), SHAPE,
                            validate=validate) is None
    assert JGridDIA.from_dia(JDIA(bands=jnp.asarray(far), offsets=(0, 200), shape=d.shape), SHAPE,
                             validate=validate) is None
    bad = a.to_scipy().tolil()
    bad[SHAPE[2] - 1, SHAPE[2]] = 99.0
    tb = DIA.from_csr(_pair(bad.tocsr())[1], device="cpu")
    assert (GridDIA.from_dia(tb, SHAPE, validate=validate) is None) == validate


def test_dfdia_grid_view_matches_flat_and_jax():
    """``DFDIA(grid=...)`` (hi + lo, each promoted to x's dtype) applies
    as its flat form and as the JAX package's grid view."""
    op_hi = poisson_dia_device(Grid3D(7, 5, 6), device="cpu")[0]
    assert op_hi.lo is not None
    d3s = host_grid_view(op_hi.hi.numpy(), op_hi.offsets, SHAPE)
    assert d3s is not None
    grid = (SHAPE, d3s)
    g = dfdia_from_numpy(op_hi.hi.numpy(), op_hi.lo.numpy(), op_hi.offsets, op_hi.shape, device="cpu", grid=grid)
    jg = JDFDIA(hi=jnp.asarray(op_hi.hi.numpy()), lo=jnp.asarray(op_hi.lo.numpy()), offsets=op_hi.offsets,
                shape=op_hi.shape, grid=grid)
    x = np.random.default_rng(1).standard_normal(op_hi.n_rows)
    y = g.mv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, op_hi.mv(torch.from_numpy(x)).numpy(), rtol=1e-14, atol=1e-12)
    np.testing.assert_array_equal(y, np.asarray(jg.mv(jnp.asarray(x))))
    np.testing.assert_array_equal(g.diagonal().numpy(), op_hi.diagonal().numpy())
    made = DFDIA.from_host_bands((op_hi.hi.double() + op_hi.lo.double()).numpy(), op_hi.offsets, op_hi.shape,
                                 device="cpu", grid=grid)
    assert made.grid == grid
    np.testing.assert_array_equal(made.mv(torch.from_numpy(x)).numpy(), y)


@pytest.fixture(scope="module")
def griddia_hierarchies():
    """JAX's and the port's f32 hierarchies over a GridDIA fine level at
    24^3 (``test_geo_hierarchy_with_griddia_fine_level_solves``)."""
    n = 24
    a, b, exact = j_assemble_poisson(JGrid3D(n, n, n))
    ja, ta = _pair(a.to_scipy())
    bands, offs, _ = JDIA.host_bands(ja, dtype=np.float32)
    d3s = j_host_grid_view(bands, offs, (n, n, n))
    jfine = JGridDIA(bands=jnp.asarray(bands), offsets=offs, d3s=d3s, grid_shape=(n, n, n))
    jh = j_setup(ja, JAMGParams(), dtype=np.float32, fine_op=jfine)
    fine = GridDIA(bands=torch.from_numpy(bands), offsets=offs, d3s=d3s, grid_shape=(n, n, n))
    th = gamg_setup_unstructured(ta, AMGParams(), dtype=np.float32, fine_op=fine, device="cpu")
    return jh, th, b


def test_geo_hierarchy_with_griddia_fine_level_solves_as_jax(griddia_hierarchies):
    """The port's setup over a GridDIA fine level keeps it as level 0 and
    solves with JAX's count (f32 summation order: within 1) and reason."""
    jh, th, b = griddia_hierarchies
    assert isinstance(th.levels[0].op, GridDIA) and isinstance(jh.levels[0].op, JGridDIA)
    assert [lev.op.shape for lev in th.levels] == [lev.op.shape for lev in jh.levels]
    want = j_cg(lambda x: jh.levels[0].op.mv(x), jnp.asarray(b, jnp.float32), rtol=1e-6, maxiter=100,
                m_mv=lambda r: j_vcycle(jh, r))
    got = cg(th.levels[0].op.mv, torch.tensor(b, dtype=torch.float32), rtol=1e-6, maxiter=100,
             m_mv=lambda r: vcycle(th, r))
    assert got.reason == int(want.reason) > 0 and abs(got.iters - int(want.iters)) <= 1 and got.iters < 40


def test_jax_griddia_hierarchy_carried_across(griddia_hierarchies):
    """JAX's hierarchy through ``interop``: its GridDIA fine level arrives
    as the port's GridDIA, and one V-cycle agrees with JAX's."""
    jh, _, b = griddia_hierarchies
    h = hierarchy_from_numpy(jax_levels(jh), damping=float(jh.damping), smoother=jh.smoother, degree=jh.degree,
                             cheby_lo=jh.cheby_lo, cheby_hi=jh.cheby_hi, device="cpu")
    assert isinstance(h.levels[0].op, GridDIA) and h.levels[0].op.d3s == jh.levels[0].op.d3s
    r = np.random.default_rng(2).standard_normal(b.shape[0]).astype(np.float32)
    want = np.asarray(j_vcycle(jh, jnp.asarray(r)))
    got = vcycle(h, torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_griddia_level_shards_through_its_flat_view(griddia_hierarchies):
    """``shard_unstructured_hierarchy`` turns a GridDIA level 0 into a
    ``DistDIA`` of its flat view, and the sharded solve is the unsharded
    one bit for bit (one process)."""
    _, th, b = griddia_hierarchies
    mesh = make_row_mesh(4, device="cpu")
    hs = shard_unstructured_hierarchy(th, mesh)
    assert isinstance(hs.levels[0].op, DistDIA) and hs.levels[0].op.bands is th.levels[0].op.bands
    bt = torch.tensor(b, dtype=torch.float32)
    flat = th.levels[0].op.to_dia()
    one = cg(flat.mv, bt, rtol=1e-6, maxiter=100, m_mv=lambda r: vcycle(th, r))
    with mesh.reductions(bt.numel()):
        got = cg(hs.levels[0].op.mv, bt, rtol=1e-6, maxiter=100, m_mv=lambda r: vcycle(hs, r))
    assert (got.iters, got.reason) == (one.iters, one.reason)
    assert torch.equal(got.x, one.x)

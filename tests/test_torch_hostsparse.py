"""The host and library sparse containers against the JAX package's on the
same numpy inputs: ``HostCSR``, ``COO`` and ``BSR`` (rtol 1e-12 in f64,
1e-6 in f32), the DIA family in every dtype and on stacks of columns (the
f64 ``DIA.mv`` at 1e-14, the batched K5's twin bit for bit its column
form), ``BlockJacobi.build`` in its dense and PCR forms (1e-12), the
diagonal count of ``KSP``'s DIA gate, and the interop constructors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse.amg.geo import GeoTransfer as JGeoTransfer
from tpusparse.amg.geo import block_weight_field_dev as j_block_weight_field_dev
from tpusparse.sparse.bsr import BSR as JBSR
from tpusparse.sparse.coo import COO as JCOO
from tpusparse.sparse.csr import HostCSR as JHostCSR
from tpusparse.sparse.dia import DIA as JDIA
from tpusparse.sparse.reorder import distinct_diagonals as j_distinct_diagonals
from tpusparse.solve.bjacobi import BlockJacobi as JBlockJacobi
from tpusparse_torch.amg.geo import GeoTransfer
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import assemble_poisson, poisson_dia_device
from tpusparse_torch.interop import block_jacobi_from_numpy, host_csr_from_numpy
from tpusparse_torch.kernels.diaband import dia_mv, dia_mv_batched, dia_mv_torch
from tpusparse_torch.solve.bjacobi import BlockJacobi, PCRLineJacobi
from tpusparse_torch.sparse import BSR, COO, DIA, HostCSR
from tpusparse_torch.sparse.dia import DFDIA
from tpusparse_torch.sparse.reorder import distinct_diagonals

RTOL = {np.float64: 1e-12, np.float32: 1e-6}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _matrix(n=36, m=36, seed=0, dtype=np.float64, dup=False):
    """A random sparse matrix with a full diagonal (scipy CSR)."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, m, density=0.15, random_state=rng, format="csr")
    a.data = rng.standard_normal(a.nnz)
    a = (a + sp.eye(n, m) * 4.0).tocsr()
    return a.astype(dtype)


def _close(got, want, dtype):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=RTOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_host_csr_matches_jax(dtype):
    a = _matrix(dtype=dtype)
    mine, theirs = HostCSR.from_scipy(a), JHostCSR.from_scipy(a)
    for prop in ("n_rows", "n_cols", "nnz", "dtype", "max_row_nnz"):
        assert getattr(mine, prop) == getattr(theirs, prop), prop
    np.testing.assert_array_equal(mine.row_nnz(), theirs.row_nnz())
    x = np.random.default_rng(1).standard_normal(36).astype(dtype)
    _close(mine.mv(x), theirs.mv(x), dtype)
    np.testing.assert_array_equal(mine.diagonal(), theirs.diagonal())
    np.testing.assert_array_equal(mine.transpose().to_dense(), theirs.transpose().to_dense())
    dense = mine.to_dense()
    np.testing.assert_array_equal(dense, theirs.to_dense())
    back = HostCSR.from_dense(dense)
    np.testing.assert_array_equal(back.indptr, JHostCSR.from_dense(dense).indptr)
    assert (back.to_scipy() != a).nnz == 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_coo_matches_jax(dtype):
    a = _matrix(36, 28, seed=2, dtype=dtype)
    mine, theirs = COO.from_csr(a, device="cpu"), JCOO.from_csr(a)
    rng = np.random.default_rng(3)
    x, y, xm = (rng.standard_normal(s).astype(dtype) for s in (28, 36, (28, 4)))
    _close(mine.mv(torch.tensor(x)), theirs.mv(jnp.asarray(x)), dtype)
    _close(mine.mm(torch.tensor(xm)), theirs.mm(jnp.asarray(xm)), dtype)
    _close(mine.rmv(torch.tensor(y)), theirs.rmv(jnp.asarray(y)), dtype)
    _close(mine.diagonal(), theirs.diagonal(), dtype)
    assert mine.nnz == theirs.nnz and torch.equal(mine @ torch.tensor(x), mine.mv(torch.tensor(x)))
    got, want = mine.to_csr(), theirs.to_csr()
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.data, want.data)


def test_coo_sums_duplicates_as_add_values():
    rows, cols, vals = np.array([0, 0, 2, 0]), np.array([1, 1, 2, 0]), np.array([1.0, 2.5, -1.0, 4.0])
    mine = COO(rows=torch.tensor(rows), cols=torch.tensor(cols), vals=torch.tensor(vals), shape=(3, 3))
    theirs = JCOO(rows=jnp.asarray(rows), cols=jnp.asarray(cols), vals=jnp.asarray(vals), shape=(3, 3))
    x = np.array([1.0, -2.0, 0.5])
    _close(mine.mv(torch.tensor(x)), theirs.mv(jnp.asarray(x)), np.float64)
    np.testing.assert_array_equal(mine.to_csr().to_dense(), theirs.to_csr().to_dense())
    np.testing.assert_array_equal(mine.to_csr().to_dense()[0], [4.0, 3.5, 0.0])


@pytest.mark.parametrize("bs", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_bsr_matches_jax(bs, dtype):
    a = _matrix(36, 36, seed=4, dtype=dtype)
    mine, theirs = BSR.from_csr(HostCSR.from_scipy(a), bs, device="cpu"), JBSR.from_csr(a, bs)
    assert (mine.nnzb, mine.nnz, mine.n_brows) == (theirs.nnzb, theirs.nnz, theirs.n_brows)
    rng = np.random.default_rng(5)
    x, xm = rng.standard_normal(36).astype(dtype), rng.standard_normal((36, 3)).astype(dtype)
    _close(mine.mv(torch.tensor(x)), theirs.mv(jnp.asarray(x)), dtype)
    _close(mine.mm(torch.tensor(xm)), theirs.mm(jnp.asarray(xm)), dtype)
    _close(mine.diagonal(), theirs.diagonal(), dtype)
    np.testing.assert_array_equal(mine.to_csr().to_dense(), theirs.to_csr().to_dense())
    _close(mine.mv(torch.tensor(x)), a @ x, dtype)


def test_bsr_from_scipy_bsr_and_its_refusals():
    a = _matrix(12, 12, seed=6).tobsr(blocksize=(2, 2))
    mine, theirs = BSR.from_scipy_bsr(a, device="cpu"), JBSR.from_scipy_bsr(a)
    assert mine.bs == theirs.bs == 2
    np.testing.assert_array_equal(mine.blocks.numpy(), np.asarray(theirs.blocks))
    with pytest.raises(TypeError):
        BSR.from_scipy_bsr(a.toarray(), device="cpu")


def _dia_pair(dtype, seed=7, n=60, offsets=(-17, -6, -1, 0, 2, 6, 40)):
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((len(offsets), n)).astype(dtype)
    return DIA(torch.tensor(bands), offsets, (n, n)), JDIA(jnp.asarray(bands), offsets, (n, n))


def test_f64_dia_matches_jax():
    """The f64 DIA applies in plain torch: mv at 1e-14, and mm, rmv,
    to_scipy and nnz as JAX's."""
    mine, theirs = _dia_pair(np.float64)
    rng = np.random.default_rng(8)
    x, xm = rng.standard_normal(60), rng.standard_normal((60, 3))
    want = np.asarray(theirs.mv(jnp.asarray(x)))
    np.testing.assert_allclose(mine.mv(torch.tensor(x)).numpy(), want, rtol=1e-14, atol=1e-14 * np.abs(want).max())
    _close(mine.mm(torch.tensor(xm)), theirs.mm(jnp.asarray(xm)), np.float64)
    _close(mine.rmv(torch.tensor(x)), theirs.rmv(jnp.asarray(x)), np.float64)
    assert (mine.to_scipy() != theirs.to_scipy()).nnz == 0
    assert mine.nnz == int(theirs.nnz) and (mine.n_rows, mine.n_cols) == (60, 60)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dia_takes_a_stack_of_columns(dtype):
    """DIA.mv on a (k, n) stack: each column its vector form, bit for bit
    (the f32 stack goes to the batched K5's twin, dia_mv_torch over the
    last axis), and JAX's vmapped DIA.mv to rtol."""
    mine, theirs = _dia_pair(dtype)
    xs = np.random.default_rng(9).standard_normal((4, 60)).astype(dtype)
    got = mine.mv(torch.tensor(xs))
    assert all(torch.equal(got[c], mine.mv(torch.tensor(xs[c]))) for c in range(4))
    _close(got, jax.vmap(theirs.mv)(jnp.asarray(xs)), dtype)


@pytest.mark.parametrize("pinned", [True, False])
def test_batched_twin_is_k5s_twin_column_by_column(pinned):
    """dia_mv_batched on the CPU (its twin) over the Poisson bands: each
    column bit-equal to dia_mv_torch of it, and to dia_mv."""
    op = poisson_dia_device(Grid3D(7, 6, 5), pin=pinned, device="cpu")[1]
    xs = torch.tensor(np.random.default_rng(10).standard_normal((3, op.n_rows), dtype=np.float32))
    got = dia_mv_batched(op.bands, xs, op.offsets)
    for c in range(3):
        assert torch.equal(got[c], dia_mv_torch(op.bands, xs[c], op.offsets))
        assert torch.equal(got[c], dia_mv(op.bands, xs[c], op.offsets))
    with pytest.raises(ValueError):
        dia_mv_batched(op.bands, xs[0], op.offsets)
    with pytest.raises(ValueError):
        dia_mv(op.bands, xs, op.offsets)
    with pytest.raises(TypeError):
        dia_mv_batched(op.bands, xs.double(), op.offsets)


def test_dfdia_takes_a_stack_of_columns():
    op_hi = poisson_dia_device(Grid3D(6, 7, 5), device="cpu")[0]
    xs = torch.tensor(np.random.default_rng(11).standard_normal((3, op_hi.n_rows)))
    got = op_hi.mv(xs)
    assert all(torch.equal(got[c], op_hi.mv(xs[c])) for c in range(3))
    assert op_hi.dtype == torch.float64


def test_host_bands_bincount_and_sort_routes_agree():
    """DIA.host_bands' bincount route equals JAX's and the sort route it
    takes for a wide offset span; distinct_diagonals equals JAX's."""
    a, _, _ = assemble_poisson(Grid3D(9, 8, 7))
    bands, offsets, shape = DIA.host_bands(a)
    jbands, joffsets, jshape = JDIA.host_bands(JHostCSR(a.indptr, a.indices, a.data, a.shape))
    np.testing.assert_array_equal(bands, jbands)
    assert (offsets, shape) == (joffsets, jshape)
    assert distinct_diagonals(a) == j_distinct_diagonals(a) == 7
    n = 8
    wide = HostCSR.from_scipy(sp.csr_matrix(
        (np.array([1.0, 2.0, 3.0]), (np.array([0, 1, n - 1]), np.array([n - 1, 1, 0]))), shape=(n, n)
    ))
    # the sort route, forced by a span past 4 nnz and 2^24 on a huge frame
    huge = HostCSR(wide.indptr, wide.indices, wide.data, (n, 2**25))
    huge.indices = huge.indices.copy()
    huge.indices[0] = 2**25 - 1
    b1, o1, _ = DIA.host_bands(huge)
    jb1, jo1, _ = JDIA.host_bands(JHostCSR(huge.indptr, huge.indices, huge.data, huge.shape))
    np.testing.assert_array_equal(b1, jb1)
    assert o1 == jo1 and distinct_diagonals(huge) == j_distinct_diagonals(huge) == 3
    with pytest.raises(ValueError, match="diagonals"):
        DIA.host_bands(a, max_offsets=6)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_geo_transfer_takes_a_stack(dtype):
    """GeoTransfer.prolong/restrict on a (k, n) stack equal their vector
    forms column by column, and JAX's transfer to rtol."""
    shape, bs = (7, 5, 8), (3, 3, 3)
    op = poisson_dia_device(Grid3D(8, 5, 7), device="cpu")[1]
    op = DIA(op.bands.to(dtype), op.offsets, op.shape)
    dinv = 1.0 / op.diagonal()
    tr = GeoTransfer.build(0.5, shape, bs, dtype, device="cpu")
    rng = np.random.default_rng(12)
    nc = int(np.prod(tr.coarse_shape))
    e = torch.tensor(rng.standard_normal((3, nc))).to(dtype)
    r = torch.tensor(rng.standard_normal((3, op.n_rows))).to(dtype)
    up, down = tr.prolong(op, dinv, e), tr.restrict(op, dinv, r)
    for c in range(3):
        assert torch.equal(up[c], tr.prolong(op, dinv, e[c]))
        assert torch.equal(down[c], tr.restrict(op, dinv, r[c]))
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jop = JDIA(jnp.asarray(op.bands.numpy()), op.offsets, op.shape)
    w = JGeoTransfer.build(None, None, shape, bs, jdt)
    w_c = j_block_weight_field_dev(shape, bs, jdt)
    jtr = JGeoTransfer.build(w._up(w_c.reshape(-1)), jnp.asarray(0.5, jdt), shape, bs, jdt)
    jdinv = jnp.asarray(dinv.numpy())
    rt = RTOL[np.float64 if dtype == torch.float64 else np.float32]
    for c in range(3):
        want = np.asarray(jtr.prolong(jop, jdinv, jnp.asarray(e[c].numpy())))
        np.testing.assert_allclose(up[c].numpy(), want, rtol=rt, atol=rt * np.abs(want).max())
        want = np.asarray(jtr.restrict(jop, jdinv, jnp.asarray(r[c].numpy())))
        np.testing.assert_allclose(down[c].numpy(), want, rtol=rt, atol=rt * np.abs(want).max())


def _bjac_system():
    """A 2-D Poisson matrix (x-lines of 10) with an empty diagonal entry
    and a row count that leaves a tail block for bs = 4 and 10."""
    n = 10
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    a = (sp.kron(sp.eye(9), t) + sp.kron(sp.diags([-1.0, -1.0], [-1, 1], shape=(9, 9)), sp.eye(n))).tolil()
    a[5, 5] = 0.0
    a = a.tocsr()
    a.eliminate_zeros()
    return a


@pytest.mark.parametrize("bs", [4, 10])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_block_jacobi_build_matches_jax(bs, dtype):
    """The dense form: the inverted blocks (identity tail, regularized
    empty diagonal) and the apply, to 1e-12 in f64."""
    a = _bjac_system()
    mine = BlockJacobi.build(HostCSR.from_scipy(a), bs, dtype=dtype, device="cpu")
    theirs = JBlockJacobi.build(JHostCSR.from_scipy(a), bs, dtype=dtype)
    assert isinstance(mine, BlockJacobi) and (mine.bs, mine.n) == (theirs.bs, theirs.n)
    _close(mine.dinv_blocks, theirs.dinv_blocks, dtype)
    r = np.random.default_rng(13).standard_normal(a.shape[0]).astype(dtype)
    _close(mine.apply(torch.tensor(r)), theirs.apply(jnp.asarray(r)), dtype)
    again = block_jacobi_from_numpy(np.asarray(theirs.dinv_blocks), theirs.bs, theirs.n, device="cpu")
    _close(again.apply(torch.tensor(r)), theirs.apply(jnp.asarray(r)), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_block_jacobi_build_pcr_form_matches_jax(dtype, monkeypatch):
    """Past the dense cap, x-line blocks (bs = nx, tridiagonal) take the PCR
    form in both packages: the same factors and apply; a block that is not
    tridiagonal raises JAX's ValueError."""
    a = _bjac_system()
    monkeypatch.setattr(BlockJacobi, "DENSE_ENTRY_CAP", 16)
    monkeypatch.setattr(JBlockJacobi, "DENSE_ENTRY_CAP", 16)
    mine = BlockJacobi.build(HostCSR.from_scipy(a), 10, dtype=dtype, device="cpu")
    theirs = JBlockJacobi.build(JHostCSR.from_scipy(a), 10, dtype=dtype)
    assert isinstance(mine, PCRLineJacobi) and mine.shifts == tuple(theirs.shifts)
    _close(mine.binv, theirs.binv, dtype)
    r = np.random.default_rng(14).standard_normal(a.shape[0]).astype(dtype)
    _close(mine.apply(torch.tensor(r)), theirs.apply(jnp.asarray(r)), dtype)
    wide = (a + sp.diags([0.1], [3], shape=a.shape)).tocsr()
    for cls, csr in ((BlockJacobi, HostCSR), (JBlockJacobi, JHostCSR)):
        with pytest.raises(ValueError, match="not tridiagonal"):
            cls.build(csr.from_scipy(wide), 10)


def test_host_csr_from_numpy_copies_the_jax_arrays():
    a = JHostCSR.from_scipy(_matrix(seed=15))
    mine = host_csr_from_numpy(a.indptr, a.indices, a.data, a.shape)
    assert isinstance(mine, HostCSR) and mine.shape == a.shape and mine.indices is not a.indices
    assert mine.indptr.dtype == np.int64 and mine.indices.dtype == np.int32
    x = np.random.default_rng(16).standard_normal(36)
    np.testing.assert_array_equal(mine.mv(x), a.mv(x))


@pytest.mark.parametrize("coarse_solve", ["jacobi", "lu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dia_vcycle_takes_a_stack(coarse_solve, dtype):
    """The geometric hierarchy's V-cycle (DIA levels, GeoTransfer, the
    Jacobi or LU coarse solve) on a (k, n) stack: each column its vector
    form (the LU coarse solve as one product over the stack, to rtol)."""
    from tpusparse_torch.amg.hierarchy import AMGParams, vcycle
    from tpusparse_torch.amg.unstructured import gamg_setup_unstructured

    op = poisson_dia_device(Grid3D(12, 12, 12), device="cpu")[1]
    op = DIA(op.bands.to(dtype), op.offsets, op.shape)
    hier = gamg_setup_unstructured(None, AMGParams(coarse_solve=coarse_solve), fine_op=op)
    assert (hier.levels[-1].coarse_inv is not None) == (coarse_solve == "lu")
    r = torch.tensor(np.random.default_rng(17).standard_normal((3, op.n_rows))).to(dtype)
    got = vcycle(hier, r)
    rt = 1e-5 if dtype == torch.float32 else 1e-12
    for c in range(3):
        one = vcycle(hier, r[c])
        torch.testing.assert_close(got[c], one, rtol=rt, atol=rt * one.abs().max().item())

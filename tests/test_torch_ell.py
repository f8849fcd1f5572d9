"""The port's ELL, HybridDIA and auto_container against the JAX package's on
the same numpy inputs (the shapes of tests/test_ell.py), and K5's twin past
48 bands (the band cap is 192, the DIA family's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse.sparse.csr import HostCSR as JHostCSR
from tpusparse.sparse.dia import DIA as JDIA
from tpusparse.sparse.dia import HybridDIA as JHybridDIA
from tpusparse.sparse.ell import ELL as JELL
from tpusparse_torch.interop import ell_from_numpy, host_csr_from_numpy
from tpusparse_torch.kernels import LAUNCHES, reset_launches
from tpusparse_torch.kernels.diaband import MAX_BANDS, dia_mv, dia_mv_batched, dia_mv_torch
from tpusparse_torch.sparse.dia import DIA, HybridDIA, auto_container
from tpusparse_torch.sparse.ell import ELL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _random_csr(n, m, density, seed):
    rng = np.random.default_rng(seed)
    a = sp.random(n, m, density=density, random_state=rng, format="csr")
    a.data = rng.standard_normal(a.nnz) + 1.0  # no zeros: zero marks padding
    a.sort_indices()
    return a


def _pair(a):
    """The matrix as a JAX HostCSR and a port HostCSR."""
    j = JHostCSR.from_scipy(a)
    return j, host_csr_from_numpy(j.indptr, j.indices, j.data, j.shape)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape,density", [((40, 40), 0.1), ((64, 17), 0.3), ((7, 90), 0.05)])
def test_roundtrip_mv_and_rmv_match_jax(shape, density, seed):
    a = _random_csr(*shape, density, seed)
    ja, ta = _pair(a)
    jell, tell = JELL.from_csr(ja), ELL.from_csr(ta, device="cpu")
    np.testing.assert_array_equal(tell.cols.numpy(), np.asarray(jell.cols))
    np.testing.assert_array_equal(tell.vals.numpy(), np.asarray(jell.vals))
    back = tell.to_csr()
    assert abs(back.to_scipy() - a).max() < 1e-14
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal(shape[1])
    y = rng.standard_normal(shape[0])
    np.testing.assert_allclose(tell.mv(torch.tensor(x)).numpy(), np.asarray(jell.mv(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tell.rmv(torch.tensor(y)).numpy(), np.asarray(jell.rmv(jnp.asarray(y))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tell.rmv(torch.tensor(y)).numpy(), a.T @ y, rtol=1e-12, atol=1e-12)
    xs = rng.standard_normal((shape[1], 3))
    np.testing.assert_allclose(tell.mm(torch.tensor(xs)).numpy(), np.asarray(jell.mm(jnp.asarray(xs))),
                               rtol=1e-12, atol=1e-12)
    assert tell.nnz == int(jell.nnz)


def test_stacks_of_columns_apply_each_column():
    a = _random_csr(30, 25, 0.2, 3)
    _, ta = _pair(a)
    ell = ELL.from_csr(ta, dtype=np.float32, device="cpu")
    rng = np.random.default_rng(4)
    xs = torch.tensor(rng.standard_normal((3, 25)), dtype=torch.float32)
    ys = torch.tensor(rng.standard_normal((3, 30)), dtype=torch.float32)
    mv, rmv = ell.mv(xs), ell.rmv(ys)
    for c in range(3):
        assert torch.equal(mv[c], ell.mv(xs[c]))
        assert torch.equal(rmv[c], ell.rmv(ys[c]))


def test_width_padding_and_diagonal():
    a = _random_csr(30, 30, 0.2, 3)
    ja, ta = _pair(a)
    x = np.linspace(-1, 1, 30)
    for w in (int(np.diff(a.indptr).max()), int(np.diff(a.indptr).max()) + 5):
        ell = ELL.from_csr(ta, width=w, device="cpu")
        assert ell.width == w
        np.testing.assert_allclose(ell.mv(torch.tensor(x)).numpy(), a @ x, rtol=1e-12)
    np.testing.assert_array_equal(
        ELL.from_csr(ta, device="cpu").diagonal().numpy(), np.asarray(JELL.from_csr(ja).diagonal()),
    )
    with pytest.raises(ValueError, match="width"):
        ELL.from_csr(ta, width=1, device="cpu")


def test_ell_from_numpy_carries_a_jax_ell():
    a = _random_csr(20, 20, 0.3, 9)
    jell = JELL.from_csr(JHostCSR.from_scipy(a))
    ell = ell_from_numpy(np.asarray(jell.cols), np.asarray(jell.vals), jell.shape, device="cpu")
    y = np.random.default_rng(1).standard_normal(20)
    np.testing.assert_allclose(ell.rmv(torch.tensor(y)).numpy(), a.T @ y, rtol=1e-12, atol=1e-12)


def _scattered(n=400, seed=0, width=6):
    """A symmetric matrix with a diagonal and ``width`` random couplings a
    row: hundreds of distinct diagonals, many with tied counts."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), width)
    cols = rng.integers(0, n, n * width)
    off = sp.csr_matrix((np.full(n * width, -0.1), (rows, cols)), shape=(n, n))
    off = off + off.T
    off.setdiag(0)
    off.eliminate_zeros()
    return (off + sp.diags(np.full(n, 4.0))).tocsr()


@pytest.mark.parametrize("max_bands", [8, 64])
def test_hybrid_dia_picks_jax_bands(max_bands):
    a = _scattered()
    ja, ta = _pair(a)
    jh = JHybridDIA.from_csr(ja, max_bands=max_bands)
    th = HybridDIA.from_csr(ta, max_bands=max_bands, device="cpu")
    assert th.dia.offsets == jh.dia.offsets
    np.testing.assert_array_equal(th.dia.bands.numpy(), np.asarray(jh.dia.bands))
    np.testing.assert_array_equal(th.rem.cols.numpy(), np.asarray(jh.rem.cols))
    x = np.random.default_rng(2).standard_normal(a.shape[0])
    np.testing.assert_allclose(th.mv(torch.tensor(x)).numpy(), a @ x, rtol=1e-12, atol=1e-12)
    assert abs(th.to_scipy() - a).max() < 1e-15
    assert th.nnz == a.nnz


def test_auto_container_is_dia_when_the_bands_cover():
    a = sp.diags([np.full(50, 2.0), np.full(49, -1.0), np.full(49, -1.0)], [0, 1, -1], format="csr")
    _, ta = _pair(a)
    op = auto_container(ta, device="cpu")
    assert isinstance(op, DIA) and op.offsets == (-1, 0, 1)
    hyb = auto_container(_pair(_scattered())[1], device="cpu")
    assert isinstance(hyb, HybridDIA) and len(hyb.dia.offsets) <= 65


@pytest.mark.parametrize("k", [49, 65, 192])
def test_k5_twin_takes_up_to_192_bands(k):
    """The twin (and so the CPU solve) takes every K the DIA family holds;
    K = 193 is refused.  Each result is JAX's DIA.mv."""
    assert MAX_BANDS == 192
    n = 1000
    rng = np.random.default_rng(k)
    offsets = tuple(sorted(rng.choice(np.arange(-400, 401), k, replace=False).tolist()))
    bands = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(JDIA(bands=jnp.asarray(bands), offsets=offsets, shape=(n, n)).mv(jnp.asarray(x)))
    reset_launches()
    got = dia_mv(torch.tensor(bands), torch.tensor(x), offsets)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5 * np.abs(want).max())
    xs = torch.tensor(rng.standard_normal((3, n)).astype(np.float32))
    stacked = dia_mv_batched(torch.tensor(bands), xs, offsets)
    assert all(torch.equal(stacked[c], dia_mv_torch(torch.tensor(bands), xs[c], offsets)) for c in range(3))
    assert LAUNCHES["dia_mv"] == LAUNCHES["dia_mv_batched"] == 0  # the twin counts nothing
    with pytest.raises(ValueError, match="192"):
        dia_mv(torch.zeros((193, 8)), torch.zeros(8), tuple(range(193)))

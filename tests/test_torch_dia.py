"""DIA containers and K5 parity: the port's ``DIA``/``DFDIA``, the plain twin
of K5 (what ``dia_mv`` runs on a CPU tensor) and ``poisson_dia_device``
against the JAX package on the same numpy inputs.

On a CUDA device ``DIA.mv`` launches the hand-written K5 instead;
``test_torch_cuda.py`` holds that against the twin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import assemble_poisson as j_assemble_poisson
from tpusparse.grid.poisson import poisson_dia_device as j_poisson_dia_device
from tpusparse.kernels.diaband import dia_mv_pallas, stack_bands
from tpusparse.sparse.dia import DFDIA as JDFDIA
from tpusparse.sparse.dia import DIA as JDIA
from tpusparse_torch import kernels
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import assemble_poisson, poisson_dia_device
from tpusparse_torch.interop import dfdia_from_numpy
from tpusparse_torch.kernels.diaband import dia_mv, dia_mv_torch
from tpusparse_torch.sparse.dia import DFDIA, DIA

N = 40 * 11 * 13            # ragged: no power of two, no multiple of 128
STAR = (-143, -13, -1, 0, 1, 13, 143)
BAND27 = tuple(sorted({dz * 143 + dy * 13 + dx for dz in (-1, 0, 1)
                       for dy in (-1, 0, 1) for dx in (-1, 0, 1)}))
# offsets reaching (almost) across the matrix at both ends, and an
# asymmetric cluster
WIDE = (-(N - 1), -2500, -1, 0, 2, 3, 5, 3000, N - 1)
CASES = {"star": STAR, "band27": BAND27, "wide": WIDE}
# (nz, ny, nx): an axis of 10 or 13 makes 1/h^2 inexact in f32, so lo != 0
SHAPES = [(24, 24, 24), (13, 11, 10)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bands(offsets, n=N, seed=0, dtype=np.float32):
    """Random bands; entries whose column leaves the matrix are zero (the
    DIA frame convention), so both packages see the same matrix."""
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((len(offsets), n)).astype(dtype)
    r = np.arange(n)
    for k, o in enumerate(offsets):
        bands[k, (r + o < 0) | (r + o >= n)] = 0
    return bands


def _x(n=N, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _close32(got, want):
    """f32 sums of K products in the same order; FMA contraction in XLA may
    move a row by an ulp of its largest term."""
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def _close_fields(got, want):
    """The f64 cosine fields: rtol 1e-14, plus an atol of 1e-15 of the
    field's range.  The cell-centre arguments are rounded in another order
    by numpy and may be by XLA's simplifier; an ulp of the argument moves a
    value near a zero of cos by ~1e-16 absolute, which is 1e-14 relative
    and more on values of 1e-2 and below."""
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-15 * np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_dia_mv_matches_jax(case):
    offsets = CASES[case]
    bands, x = _bands(offsets), _x()
    want = np.asarray(JDIA(bands=jnp.asarray(bands), offsets=offsets, shape=(N, N)).mv(jnp.asarray(x)))
    got = DIA(bands=torch.tensor(bands), offsets=offsets, shape=(N, N)).mv(torch.tensor(x))
    assert got.dtype == torch.float32 and got.shape == (N,)
    _close32(got.numpy(), want)


@pytest.mark.parametrize("case", ["star", "band27"])
def test_twin_matches_pallas_interpreter(case):
    offsets = CASES[case]
    bands, x = _bands(offsets, seed=2), _x(seed=3)
    want = np.asarray(dia_mv_pallas(
        stack_bands(bands, offsets, N), jnp.asarray(x), offsets, N, interpret=True,
    ))
    got = dia_mv_torch(torch.tensor(bands), torch.tensor(x), offsets).numpy()
    _close32(got, want)


def test_twin_drops_terms_outside_the_matrix():
    """Nonzero band entries whose column leaves the matrix add nothing."""
    bands = np.ones((2, 5), np.float32)
    x = np.arange(1, 6, dtype=np.float32)
    got = dia_mv_torch(torch.tensor(bands), torch.tensor(x), (-2, 3)).numpy()
    np.testing.assert_array_equal(got, [4.0, 5.0, 1.0, 2.0, 3.0])


@pytest.mark.parametrize("with_lo", [True, False])
def test_dfdia_mv_matches_jax(with_lo):
    offsets = WIDE
    bands64 = _bands(offsets, seed=4, dtype=np.float64)
    if not with_lo:
        bands64 = bands64.astype(np.float32).astype(np.float64)
    x = _x(seed=5, dtype=np.float64)
    jop = JDFDIA.from_host_bands(bands64, offsets, (N, N))
    op = DFDIA.from_host_bands(bands64, offsets, (N, N), device="cpu")
    assert (op.lo is None) == (jop.lo is None) == (not with_lo)
    np.testing.assert_array_equal(op.hi.numpy(), np.asarray(jop.hi))
    if with_lo:
        np.testing.assert_array_equal(op.lo.numpy(), np.asarray(jop.lo))
    want = np.asarray(jop.mv(jnp.asarray(x)))
    got = op.mv(torch.tensor(x))
    assert got.dtype == torch.float64
    # f64 sums of 2K terms in the same order: rounding only
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13 * np.abs(want).max())
    np.testing.assert_allclose(
        op.diagonal().numpy(), np.asarray(jop.diagonal()), rtol=1e-15, atol=0,
    )


def test_dfdia_refuses_the_grid_view():
    bands64 = _bands(STAR, seed=6, dtype=np.float64)
    op = DFDIA.from_host_bands(bands64, STAR, (N, N), device="cpu")
    with pytest.raises(NotImplementedError, match="griddia"):
        DFDIA(hi=op.hi, lo=op.lo, offsets=STAR, shape=(N, N), grid=((40, 11, 13), ()))


@pytest.mark.parametrize("shape", SHAPES)
def test_host_bands_match_jax(shape):
    nz, ny, nx = shape
    a, b, exact = assemble_poisson(Grid3D(nx, ny, nz))
    ja, jb, jexact = j_assemble_poisson(JGrid3D(nx, ny, nz))
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, name), getattr(ja, name))
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(exact, jexact)
    bands, offsets, shp = DIA.host_bands(a)
    jbands, joffsets, jshp = JDIA.host_bands(ja)
    assert (offsets, shp) == (joffsets, jshp)
    np.testing.assert_array_equal(bands, jbands)
    # a scipy matrix converts the same way; from_csr uploads the bands
    a_sp = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
    np.testing.assert_array_equal(DIA.host_bands(a_sp)[0], bands)
    op = DIA.from_csr(a_sp, dtype=np.float32, device="cpu")
    assert op.offsets == offsets and op.shape == shp and op.dtype == torch.float32
    np.testing.assert_array_equal(op.bands.numpy(), bands.astype(np.float32))
    with pytest.raises(ValueError, match="max_offsets"):
        DIA.host_bands(a, max_offsets=6)


@pytest.mark.parametrize("shape", SHAPES)
def test_poisson_dia_device_matches_jax(shape):
    nz, ny, nx = shape
    op_hi, op_lo, b, exact = poisson_dia_device(Grid3D(nx, ny, nz), device="cpu")
    jhi, jlo, jb, jexact = j_poisson_dia_device(JGrid3D(nx, ny, nz))
    assert op_lo.offsets == jlo.offsets and op_hi.offsets == jhi.offsets
    assert op_lo.bands is op_hi.hi  # the inner operator aliases the outer's hi
    np.testing.assert_array_equal(op_hi.hi.numpy(), np.asarray(jhi.hi))
    assert (op_hi.lo is None) == (jhi.lo is None) == (shape == (24, 24, 24))
    if op_hi.lo is not None:
        np.testing.assert_array_equal(op_hi.lo.numpy(), np.asarray(jhi.lo))
    assert b.dtype == exact.dtype == torch.float64
    _close_fields(b.numpy(), np.asarray(jb))
    _close_fields(exact.numpy(), np.asarray(jexact))
    # the JAX outer operator carried into the port applies as the JAX one
    carried = dfdia_from_numpy(
        np.asarray(jhi.hi), None if jhi.lo is None else np.asarray(jhi.lo),
        jhi.offsets, jhi.shape, device="cpu",
    )
    x = _x(nz * ny * nx, seed=8, dtype=np.float64)
    want = np.asarray(jhi.mv(jnp.asarray(x)))
    for op in (carried, op_hi):
        np.testing.assert_allclose(
            op.mv(torch.tensor(x)).numpy(), want, rtol=1e-13, atol=1e-13 * np.abs(want).max(),
        )


@pytest.mark.parametrize("shape", SHAPES)
def test_host_and_device_assembly_agree(shape):
    nz, ny, nx = shape
    grid = Grid3D(nx, ny, nz)
    op_hi, op_lo, b, exact = poisson_dia_device(grid, device="cpu")
    a, b_np, exact_np = assemble_poisson(grid)
    bands64, offsets, _ = DIA.host_bands(a)
    host = DFDIA.from_host_bands(bands64, offsets, (grid.n, grid.n), device="cpu")
    assert offsets == op_lo.offsets
    np.testing.assert_array_equal(op_hi.hi.numpy(), host.hi.numpy())
    assert (op_hi.lo is None) == (host.lo is None)
    if host.lo is not None:
        np.testing.assert_array_equal(op_hi.lo.numpy(), host.lo.numpy())
    _close_fields(b.numpy(), b_np)
    _close_fields(exact.numpy(), exact_np)
    # the two-float outer operator applies the f64 matrix
    x = _x(grid.n, seed=7, dtype=np.float64)
    y = op_hi.mv(torch.tensor(x)).numpy()
    want = a.data * x[a.indices]
    want = np.add.reduceat(want, a.indptr[:-1])
    np.testing.assert_allclose(y, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_dia_mv_refuses_what_the_kernel_does_not_take():
    bands, x = torch.tensor(_bands(STAR)), torch.tensor(_x())
    with pytest.raises(TypeError):
        dia_mv(bands.double(), x.double(), STAR)
    with pytest.raises(ValueError):
        dia_mv(bands, x[:-1], STAR)
    with pytest.raises(ValueError):
        dia_mv(bands, x, STAR[:-1])
    with pytest.raises(ValueError):
        dia_mv(torch.zeros((49, 8)), torch.zeros(8), tuple(range(49)))
    with pytest.raises(ValueError, match="contiguous"):
        dia_mv(bands.t().contiguous().t(), x, STAR)
    with pytest.raises(ValueError):
        dia_mv(bands.to("meta"), x.to("meta"), STAR)


def test_cpu_tensors_run_the_twin_and_count_nothing():
    kernels.reset_launches()
    op = DIA(bands=torch.tensor(_bands(STAR)), offsets=STAR, shape=(N, N))
    y = op.mv(torch.tensor(_x()))
    assert y.device.type == "cpu"
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    np.testing.assert_array_equal(op.diagonal().numpy(), op.bands[3].numpy())

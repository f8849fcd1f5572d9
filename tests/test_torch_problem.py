"""Problem build parity: the port's ``poisson_stencil_device`` against the
JAX package's, and against the port's own host-assembled oracle."""

import numpy as np
import pytest
import torch

from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import poisson_stencil_device as j_poisson_stencil_device
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import (
    exact_field,
    poisson_stencil,
    poisson_stencil_device,
    rhs_field,
)
from tpusparse_torch.sparse.stencil import StarStencil3D

# (nz, ny, nx) field shapes
SHAPES = [(24, 24, 24), (13, 11, 9)]
# 1-2 ulp of libm-vs-XLA-vs-torch cos (tpusparse/grid/poisson.py:164-165)
RTOL = 1e-13


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _grids(shape):
    nz, ny, nx = shape
    return Grid3D(nx, ny, nz), JGrid3D(nx, ny, nz)


@pytest.mark.parametrize("pin", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_device_build_matches_jax(shape, pin):
    grid, jgrid = _grids(shape)
    op, b, exact = poisson_stencil_device(grid, pin=pin, device="cpu")
    jop, jb, jexact = j_poisson_stencil_device(jgrid, pin=pin)
    assert op.dtype == torch.float64 and op.grid_shape == shape
    np.testing.assert_allclose(op.diag.numpy(), np.asarray(jop.diag), rtol=RTOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(exact.numpy(), np.asarray(jexact), rtol=RTOL, atol=1e-15)
    assert (op.cx, op.cy, op.cz) == (float(jop.cx), float(jop.cy), float(jop.cz))
    assert op.pinned == jop.pinned == pin
    if pin:
        # the pin: diagonal scale at the origin and its three b corrections
        for idx in [(0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 0)]:
            np.testing.assert_allclose(
                b[idx].item(), float(jb[idx]), rtol=RTOL
            )
        assert op.diag[0, 0, 0].item() == pytest.approx(float(jop.diag[0, 0, 0]), rel=RTOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_device_build_matches_host_oracle(shape):
    grid, _ = _grids(shape)
    op, b, exact = poisson_stencil_device(grid, device="cpu")
    hop, hb, hexact = poisson_stencil(grid, device="cpu")
    np.testing.assert_allclose(op.diag.numpy(), hop.diag.numpy(), rtol=RTOL)
    np.testing.assert_allclose(b.numpy(), hb.numpy(), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(exact.numpy(), hexact.numpy(), rtol=RTOL, atol=1e-15)
    np.testing.assert_allclose(hexact.numpy(), exact_field(grid))
    np.testing.assert_allclose(
        rhs_field(grid), -12 * np.pi**2 * exact_field(grid), rtol=1e-14
    )


def test_f32_build_rounds_like_jax():
    grid, jgrid = _grids((13, 11, 9))
    op, _, _ = poisson_stencil_device(grid, dtype=torch.float32, device="cpu")
    jop, _, _ = j_poisson_stencil_device(jgrid, dtype=np.float32)
    assert op.dtype == torch.float32
    np.testing.assert_array_equal(op.diag.numpy(), np.asarray(jop.diag))
    assert op.cx == float(jop.cx) and op.cz == float(jop.cz)


@pytest.mark.parametrize("pin", [True, False])
def test_star_mv_matches_jax(pin):
    from tpusparse.sparse.stencil import StarStencil3D as JStar

    shape = (13, 11, 9)
    grid, jgrid = _grids(shape)
    op, _, _ = poisson_stencil_device(grid, pin=pin, device="cpu")
    jop, _, _ = j_poisson_stencil_device(jgrid, pin=pin)
    x = np.random.default_rng(3).standard_normal(shape)
    got = op.mv(torch.from_numpy(x)).numpy()
    want = np.asarray(JStar.mv(jop, x))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_star_mv_rejects_wrong_shape():
    op = StarStencil3D(torch.ones(3, 4, 5, dtype=torch.float64), 1.0, 1.0, 1.0, True)
    with pytest.raises(ValueError):
        op.mv(torch.ones(3, 4, 4, dtype=torch.float64))

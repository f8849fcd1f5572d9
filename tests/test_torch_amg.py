"""Structured GAMG parity at 24^3 on the padded layout: the port's setup
against the JAX package's (level shapes, rho, transfers, probed Galerkin
coefficients), and the port's fused V-cycle on a copy of the JAX hierarchy
against the JAX fused V-cycle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.amg.fused_cycle import vcycle_fused as j_vcycle_fused
from tpusparse.amg.fused_cycle import vcycle_fused_dots as j_vcycle_fused_dots
from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.amg.hierarchy import gamg_setup as j_gamg_setup
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import poisson_stencil_device as j_poisson_stencil_device
from tpusparse.sparse.padded import PaddedStar as JPaddedStar
from tpusparse.sparse.padded import crop_field as j_crop_field
from tpusparse.sparse.padded import pad_field as j_pad_field
from tpusparse_torch.amg.fused_cycle import fused_fine_supported, vcycle_fused, vcycle_fused_dots
from tpusparse_torch.amg.hierarchy import AMGParams, gamg_setup, vcycle
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil_device
from tpusparse_torch.interop import hierarchy_from_numpy
from tpusparse_torch.sparse.padded import PaddedStar, crop_field, pad_field

N = 24
SHAPE = (N, N, N)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_fine_op(n=N):
    op = poisson_stencil_device(Grid3D(n, n, n), dtype=torch.float32, device="cpu")[0]
    return PaddedStar.from_star(op)


@pytest.fixture(scope="module")
def jax_hier():
    """The JAX setup evaluated op by op, as eager torch evaluates the port's.

    Compiled, XLA fuses the rho start vector's ``i*0.7 + 0.3`` into one
    multiply-add; at i ~ 1e4 that ulp of sin's argument moves the 25-step
    power-iteration estimate by 1.7e-4, beyond the rtol 1e-5 held here.
    """
    jop = j_poisson_stencil_device(JGrid3D(N, N, N), dtype=np.float32)[0]
    with jax.disable_jit():
        return j_gamg_setup(JPaddedStar.from_star(jop), JAMGParams())


@pytest.fixture(scope="module")
def port_hier():
    return gamg_setup(_port_fine_op(), AMGParams())


def jax_levels(jh):
    """The JAX hierarchy as the numpy level dicts of ``hierarchy_from_numpy``."""
    out = []
    for i, lev in enumerate(jh.levels):
        if i == 0:
            ts = lev.op.true_shape
            op = {
                "diag": np.asarray(j_crop_field(lev.op.diag, ts)),
                "cx": np.asarray(lev.op.cx), "cy": np.asarray(lev.op.cy),
                "cz": np.asarray(lev.op.cz), "pinned": lev.op.pinned,
            }
            dinv = np.asarray(j_crop_field(lev.dinv, ts))
            inner = lev.transfer.inner
        else:
            op = {"coef": np.asarray(lev.op.coef, dtype=np.float32)}
            dinv = np.asarray(lev.dinv)
            inner = lev.transfer
        transfer = None if inner is None else {
            "omega": np.asarray(inner.omega), "tnorm": np.asarray(inner.tnorm),
            "sz": np.asarray(inner.sz), "sy": np.asarray(inner.sy),
            "sx": np.asarray(inner.sx), "fine_shape": inner.fine_shape,
            "factor": inner.factor,
        }
        out.append({"op": op, "dinv": dinv, "rho": np.asarray(lev.rho), "transfer": transfer})
    return out


def port_copy(jh):
    return hierarchy_from_numpy(
        jax_levels(jh), damping=np.asarray(jh.damping), smoother=jh.smoother,
        degree=jh.degree, cheby_lo=jh.cheby_lo, cheby_hi=jh.cheby_hi, device="cpu",
    )


def test_level_shapes_match(jax_hier, port_hier):
    assert port_hier.n_levels == jax_hier.n_levels >= 3
    assert [lev.op.grid_shape for lev in port_hier.levels] == [
        tuple(lev.op.grid_shape) for lev in jax_hier.levels
    ]


def test_rho_matches(jax_hier, port_hier):
    for plev, jlev in zip(port_hier.levels, jax_hier.levels):
        assert plev.rho == pytest.approx(float(jlev.rho), rel=1e-5)


def test_transfers_match(jax_hier, port_hier):
    for plev, jlev in zip(port_hier.levels[:-1], jax_hier.levels[:-1]):
        ptr = getattr(plev.transfer, "inner", plev.transfer)
        jtr = getattr(jlev.transfer, "inner", jlev.transfer)
        assert ptr.omega == pytest.approx(float(jtr.omega), rel=1e-5)
        np.testing.assert_array_equal(ptr.tnorm.numpy(), np.asarray(jtr.tnorm))
        np.testing.assert_array_equal(ptr.sx.numpy(), np.asarray(jtr.sx))
    assert port_hier.levels[-1].transfer is None


def test_galerkin_coefficients_match(jax_hier, port_hier):
    for plev, jlev in zip(port_hier.levels[1:], jax_hier.levels[1:]):
        want = np.asarray(jlev.op.coef)
        got = plev.op.coef.numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_fine_dinv_keeps_unit_pads(port_hier):
    dinv = port_hier.levels[0].dinv
    inner = torch.zeros_like(dinv, dtype=torch.bool)
    inner[3:-3, :, :N] = True
    assert torch.all(dinv[~inner] == 1.0)


def _rhs(seed=5):
    return np.random.default_rng(seed).standard_normal(SHAPE, dtype=np.float32)


def test_vcycle_fused_dots_on_shared_hierarchy(jax_hier):
    b = _rhs()
    wz, wrz, wrr = j_vcycle_fused_dots(jax_hier, j_pad_field(jnp.asarray(b)))
    ph = port_copy(jax_hier)
    assert fused_fine_supported(ph)
    z, rz, rr = vcycle_fused_dots(ph, pad_field(torch.tensor(b)))
    want = np.asarray(j_crop_field(wz, SHAPE))
    # field rtol 1e-5; atol at 1e-6 of the range for cells that cancel
    np.testing.assert_allclose(
        crop_field(z, SHAPE).numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max()
    )
    assert rz.item() == pytest.approx(float(wrz), rel=1e-5)
    assert rr.item() == pytest.approx(float(wrr), rel=1e-5)


def test_fused_cycle_matches_plain_vcycle(port_hier):
    """The fused fine level reproduces hierarchy.vcycle up to its two
    benign reassociations (s0 = 1/theta; diag * (D^-1 r) == r)."""
    b_p = pad_field(torch.tensor(_rhs(9)))
    z, rz, rr = vcycle_fused_dots(port_hier, b_p)
    want = vcycle(port_hier, b_p)
    torch.testing.assert_close(z, want, rtol=1e-4, atol=1e-5 * want.abs().max().item())
    assert rz.item() == pytest.approx(torch.dot(b_p.flatten(), want.flatten()).item(), rel=1e-4)
    assert rr.item() == pytest.approx(torch.dot(b_p.flatten(), b_p.flatten()).item(), rel=1e-6)


def test_richardson_smoother_rides_the_fused_kernels():
    ph = gamg_setup(_port_fine_op(12), AMGParams(smoother="richardson", smooth_damping=0.6))
    b_p = pad_field(torch.tensor(np.random.default_rng(2).standard_normal((12, 12, 12), dtype=np.float32)))
    z, _, _ = vcycle_fused_dots(ph, b_p)
    want = vcycle(ph, b_p)
    torch.testing.assert_close(z, want, rtol=1e-4, atol=1e-5 * want.abs().max().item())


# (smoother, degree) of the level smoothers: the default Chebyshev(2)
# (K3/K4, K3'/K4'), the reference config's Richardson(1) and Chebyshev(1)
# (K6/K7, K6'/K7')
SMOOTHERS = [("chebyshev", 2), ("richardson", 1), ("chebyshev", 1)]


@pytest.mark.parametrize("dots", [True, False])
@pytest.mark.parametrize("smoother, degree", SMOOTHERS)
def test_fused_cycles_on_shared_hierarchy(smoother, degree, dots):
    """vcycle_fused(_dots) on a copy of the JAX hierarchy against the JAX
    package's (fused7_xla on the CPU), at the tolerances of
    test_vcycle_fused_dots_on_shared_hierarchy."""
    n, shape = 12, (12, 12, 12)
    jop = j_poisson_stencil_device(JGrid3D(n, n, n), dtype=np.float32)[0]
    jh = j_gamg_setup(JPaddedStar.from_star(jop), JAMGParams(smoother=smoother, degree=degree))
    ph = port_copy(jh)
    assert fused_fine_supported(ph) and ph.level_cfg(0) == (smoother, degree)
    b = np.random.default_rng(6).standard_normal(shape, dtype=np.float32)
    jb, pb = j_pad_field(jnp.asarray(b)), pad_field(torch.tensor(b))
    if dots:
        (wz, wrz, wrr), (z, rz, rr) = j_vcycle_fused_dots(jh, jb), vcycle_fused_dots(ph, pb)
        assert rz.item() == pytest.approx(float(wrz), rel=1e-5)
        assert rr.item() == pytest.approx(float(wrr), rel=1e-5)
    else:
        wz, z = j_vcycle_fused(jh, jb), vcycle_fused(ph, pb)
    want = np.asarray(j_crop_field(wz, shape))
    np.testing.assert_allclose(
        crop_field(z, shape).numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max()
    )


@pytest.mark.parametrize("smoother, degree", SMOOTHERS[1:])
def test_degree1_fused_cycle_matches_plain_vcycle(smoother, degree):
    """The degree-1 fused fine level reproduces hierarchy.vcycle up to the
    same benign reassociations as degree 2, with and without its dots."""
    ph = gamg_setup(_port_fine_op(12), AMGParams(smoother=smoother, degree=degree))
    b_p = pad_field(torch.tensor(np.random.default_rng(3).standard_normal((12, 12, 12), dtype=np.float32)))
    want = vcycle(ph, b_p)
    z, rz, _ = vcycle_fused_dots(ph, b_p)
    for got in (z, vcycle_fused(ph, b_p)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * want.abs().max().item())
    assert rz.item() == pytest.approx(torch.dot(b_p.flatten(), want.flatten()).item(), rel=1e-4)


def test_unsupported_fine_level_raises(port_hier):
    h3 = dataclasses.replace(port_hier, degree=3)
    assert not fused_fine_supported(h3)
    for cycle in (vcycle_fused_dots, vcycle_fused):
        with pytest.raises(ValueError):
            cycle(h3, torch.zeros_like(port_hier.levels[0].dinv))


@pytest.mark.parametrize(
    "params, err",
    [
        (AMGParams(bjacobi_bs=4), ValueError),        # the padded kernels are point Jacobi
        (AMGParams(smoother="sor"), ValueError),      # no colouring on the padded layout
        (AMGParams(coarse_solve="cholesky"), ValueError),
        (AMGParams(smoother="sor", bjacobi_bs=4), ValueError),
        (AMGParams(nsmooths=2), ValueError),
        (AMGParams(smoother="jacobi"), ValueError),
    ],
)
def test_setup_refuses_unported_options(params, err):
    """What the padded fine level cannot take raises, as in the JAX package
    (the driver's layout="auto" runs it on the plain layout instead)."""
    with pytest.raises(err):
        gamg_setup(_port_fine_op(6), params)


def test_padded_setup_degrades_lu_to_jacobi():
    """Where the JAX package's padded setup warns and degrades lu to the
    jacobi coarse solve, the port refuses it as it refuses sor and
    bjacobi_bs there: no entry point sends lu to the padded layout."""
    with pytest.raises(ValueError, match="lu' is not supported on the padded layout"):
        gamg_setup(_port_fine_op(6), AMGParams(coarse_solve="lu"))

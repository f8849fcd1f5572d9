"""``-pc_gamg_threshold`` on the structured path: the semicoarsening
schedule (exact tuples against the JAX package's, on several grids and on
either side of a threshold), the filtered hierarchy against the JAX
package's (level shapes, factors, rho, filtered legs, Galerkin
coefficients), the fused and unfused cycles with filtered legs on a shared
hierarchy, and an anisotropic solve at 24^3 against the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import port_copy

from tpusparse.amg.fused_cycle import vcycle_fused as j_vcycle_fused
from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.amg.hierarchy import axis_strengths as j_axis_strengths
from tpusparse.amg.hierarchy import gamg_setup as j_gamg_setup
from tpusparse.amg.hierarchy import threshold_schedule as j_threshold_schedule
from tpusparse.amg.hierarchy import vcycle as j_vcycle
from tpusparse.bench.driver import solve_poisson as j_solve_poisson
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import poisson_stencil_device as j_poisson_stencil_device
from tpusparse.sparse.padded import PaddedStar as JPaddedStar
from tpusparse.sparse.padded import crop_field as j_crop_field
from tpusparse.sparse.padded import pad_field as j_pad_field
from tpusparse_torch.amg.fused_cycle import fused_fine_supported, vcycle_fused
from tpusparse_torch.amg.hierarchy import (
    AMGParams,
    axis_strengths,
    gamg_setup,
    threshold_schedule,
    vcycle,
)
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil_device
from tpusparse_torch.sparse.padded import PaddedStar, crop_field, pad_field

EXTENT = (1.0, 1.0, 3.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stars(n, extent):
    """(JAX f32 star, port f32 star) of the Poisson operator on the box."""
    nx, ny, nz = n
    lx, ly, lz = extent
    jop = j_poisson_stencil_device(JGrid3D(nx, ny, nz, lx=lx, ly=ly, lz=lz), dtype=np.float32)[0]
    op = poisson_stencil_device(Grid3D(nx, ny, nz, lx=lx, ly=ly, lz=lz), dtype=torch.float32, device="cpu")[0]
    return jop, op


# (grid (nx, ny, nz), extent): isotropic, z-weak, x-strong, and two axes weak
GRIDS = [
    ((12, 12, 12), (1.0, 1.0, 1.0)),
    ((24, 24, 24), EXTENT),
    ((24, 20, 18), (0.3, 1.0, 1.0)),
    ((16, 16, 16), (1.0, 4.0, 4.0)),
    ((30, 10, 10), (1.0, 0.5, 2.0)),
]


@pytest.mark.parametrize("grid, extent", GRIDS)
def test_axis_strengths_match(grid, extent):
    jop, op = _stars(grid, extent)
    # JAX takes the mean |diag| in f32 (1.6e-5 off on the (24, 20, 18)
    # grid), the port in f64; the common scale cancels in the schedule
    np.testing.assert_allclose(axis_strengths(op), j_axis_strengths(jop), rtol=1e-4)


def _ratios(op):
    """The schedule's first-level drop ratios leg / (2 sum legs)."""
    legs = axis_strengths(op)
    return [v / (2.0 * sum(legs)) for v in legs]


@pytest.mark.parametrize("grid, extent", GRIDS)
@pytest.mark.parametrize("threshold", [0.0, 0.02, 0.05, 0.08, 0.2, "below", "above"])
def test_schedule_matches_exactly(grid, extent, threshold):
    """The schedule's tuples equal the JAX package's, plain and padded,
    including at a threshold 1e-6 below and above a level-0 drop ratio."""
    jop, op = _stars(grid, extent)
    if isinstance(threshold, str):
        ratio = sorted(_ratios(op))[0]
        threshold = ratio * (1 - 1e-6 if threshold == "below" else 1 + 1e-6)
    want = j_threshold_schedule(jop, threshold)
    assert threshold_schedule(op, threshold) == want
    assert threshold_schedule(PaddedStar.from_star(op), threshold) == want
    assert j_threshold_schedule(JPaddedStar.from_star(jop), threshold) == want


def test_anisotropic_schedule_semicoarsens():
    _, op = _stars((24, 24, 24), EXTENT)
    sched = threshold_schedule(op, 0.05)
    assert sched[0] == (1, 3, 3) and sched[-1] == (3, 3, 3)


@pytest.fixture(scope="module")
def hierarchies():
    """The filtered hierarchy of both packages at 24^3 on the z-stretched
    box, the JAX one evaluated op by op (``test_torch_amg.py``)."""
    jop, op = _stars((24, 24, 24), EXTENT)
    sched = threshold_schedule(op, 0.05)
    with jax.disable_jit():
        jh = j_gamg_setup(JPaddedStar.from_star(jop), JAMGParams(), factors_schedule=sched)
    ph = gamg_setup(PaddedStar.from_star(op), AMGParams(), factors_schedule=sched)
    return jh, ph


def test_filtered_hierarchy_matches(hierarchies):
    jh, ph = hierarchies
    assert ph.n_levels == jh.n_levels >= 3
    for plev, jlev in zip(ph.levels, jh.levels):
        assert tuple(plev.op.grid_shape) == tuple(jlev.op.grid_shape)
        assert plev.rho == pytest.approx(float(jlev.rho), rel=1e-5)
    for plev, jlev in zip(ph.levels[:-1], jh.levels[:-1]):
        pin = getattr(plev.transfer, "inner", plev.transfer)
        jin = getattr(jlev.transfer, "inner", jlev.transfer)
        assert pin.factor == tuple(jin.factor)
        assert (pin.fop is None) == (jin.fop is None)
        if pin.fop is not None and hasattr(pin.fop, "cx"):
            assert (pin.fop.cx, pin.fop.cy, pin.fop.cz) == pytest.approx(
                (float(jin.fop.cx), float(jin.fop.cy), float(jin.fop.cz))
            )
        elif pin.fop is not None:
            np.testing.assert_array_equal(pin.fop.coef.numpy() == 0, np.asarray(jin.fop.coef) == 0)
    # level 0 keeps z (its factor 1) and smooths P with the z legs dropped
    assert ph.levels[0].transfer.inner.factor == (1, 3, 3)
    assert ph.levels[0].transfer.flegs[2] == 0.0


def test_filtered_galerkin_coefficients_match(hierarchies):
    jh, ph = hierarchies
    for plev, jlev in zip(ph.levels[1:], jh.levels[1:]):
        want = np.asarray(jlev.op.coef)
        got = plev.op.coef.numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def _rhs(seed=8):
    return np.random.default_rng(seed).standard_normal((24, 24, 24), dtype=np.float32)


def test_fused_cycle_with_filtered_legs(hierarchies):
    """K3/K4 with flegs (twins) on a copy of the JAX hierarchy against the
    JAX package's fused cycle (``fused7_xla`` with ``fop``)."""
    jh, _ = hierarchies
    ph = port_copy(jh)
    assert fused_fine_supported(ph) and ph.levels[0].transfer.flegs is not None
    b = _rhs()
    want = np.asarray(j_crop_field(j_vcycle_fused(jh, j_pad_field(jnp.asarray(b))), (24, 24, 24)))
    got = crop_field(vcycle_fused(ph, pad_field(torch.tensor(b))), (24, 24, 24)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_unfused_cycle_with_filtered_legs(hierarchies):
    """K10-K16 with flegs (twins), Chebyshev(3), against the JAX package's
    unfused cycle on the same filtered hierarchy."""
    jh, _ = hierarchies
    jh3 = dataclasses.replace(jh, degree=3)
    ph = port_copy(jh3)
    assert not fused_fine_supported(ph)
    b = _rhs(9)
    want = np.asarray(j_crop_field(j_vcycle(jh3, j_pad_field(jnp.asarray(b))), (24, 24, 24)))
    got = crop_field(vcycle(ph, pad_field(torch.tensor(b))), (24, 24, 24)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.fixture(scope="module")
def solves():
    kw = dict(rtol=1e-8, atol=1e-12, pc="gamg", warmup=False, extent=EXTENT)
    return {
        thr: (
            j_solve_poisson(24, layout="padded", amg_params=JAMGParams(threshold=thr), **kw),
            solve_poisson(24, device="cpu", amg_params=AMGParams(threshold=thr), view=True, **kw),
        )
        for thr in (0.0, 0.05)
    }


@pytest.mark.parametrize("threshold", [0.0, 0.05])
def test_anisotropic_solve_matches_jax(solves, threshold):
    want, got = solves[threshold]
    assert (got.outer_iters, got.reason) == (want.outer_iters, want.reason) and want.reason == 2
    assert abs(got.iters - want.iters) <= 1
    assert abs(got.linf_error - want.linf_error) < 1e-6


def test_threshold_solve_semicoarsens(solves):
    view = solves[0.05][1].solver_view
    assert "coarsening (1, 3, 3) (filtered P smoother)" in view
    assert "fused fine level" in view
    assert "coarsening" not in solves[0.0][1].solver_view

"""The general-matrix (aij) slice end to end at 24^3: the JAX package's
structure-blind solve (``mat_type="aij", structure_detect=False``) against
the port's on the CPU, the options the port refuses there, and uniform
precision through the star lift."""

import json

import numpy as np
import pytest
import torch

from tpusparse.bench.driver import solve_poisson as j_solve_poisson
from tpusparse_torch.amg.geo import GeoTransfer
from tpusparse_torch.amg.hierarchy import AMGParams
from tpusparse_torch.amg.unstructured import gamg_setup_unstructured
from tpusparse_torch.bench.driver import build_system_aij, refined_solve_plain, solve_poisson
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import assemble_poisson
from tpusparse_torch.sparse.dia import DFDIA, DIA

# the structure-blind route (K5): the default proves the matrix a star
# and takes the stencil route (tests/test_torch_starlift.py)
KW = dict(rtol=1e-8, atol=1e-12, pc="gamg", mat_type="aij", structure_detect=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reports():
    want = j_solve_poisson(24, warmup=False, **KW)
    got = solve_poisson(24, device="cpu", warmup=False, **KW)
    return want, got


def test_aij_slice_matches_jax(reports):
    want, got = reports
    # the JAX package's own outcome at this size
    assert (want.iters, want.outer_iters, want.reason) == (24, 2, 2)
    assert want.linf_error == pytest.approx(1.117072894e-2, abs=1e-10)
    assert (got.outer_iters, got.reason) == (want.outer_iters, want.reason)
    # inner within +-1: f32 dots summed in another order may move the last
    # inner solve across its tolerance by one iteration
    assert abs(got.iters - want.iters) <= 1
    assert abs(got.linf_error - want.linf_error) < 1e-6


def test_aij_report_contract(reports):
    _, got = reports
    assert got.reference_block().splitlines()[0] == "[Nx, Ny, Nz]: [24, 24, 24]"
    assert got.converged_reason_line() == (
        f"Linear solve converged due to CONVERGED_RTOL iterations {got.iters}"
    )
    side = json.loads(got.json_sidecar())
    assert side["mat_type"] == "aij" and side["device"] == "cpu"
    assert min(got.t_init, got.t_setup, got.t_solve) >= 0.0


@pytest.mark.slow
@pytest.mark.parametrize("n", [100, 200])
def test_aij_counts_match_jax_in_f32(n):
    """The witness behind ``chip_smoke.py``'s 300^3 gate: on the CPU,
    where ``GeoTransfer``'s contractions are full f32 products in both
    packages, the port takes the JAX package's counts at sizes between 24^3
    and 300^3 (48^3 differs: there the rho start vector's rounding
    decides, ROADMAP section 3).  ~3 min for both sizes: ``pytest -m slow``."""
    want = j_solve_poisson(n, warmup=False, **KW)
    got = solve_poisson(n, device="cpu", warmup=False, **KW)
    assert (got.outer_iters, got.reason) == (want.outer_iters, want.reason)
    # inner within +-1, as at 24^3: f32 dots summed in another order (the
    # port's count at 200^3 is 29 on two threads and 30 on one)
    assert abs(got.iters - want.iters) <= 1
    assert abs(got.linf_error - want.linf_error) < 1e-6


def _host_system(n):
    """The aij system assembled on the host (``assemble_poisson``, the
    oracle) and uploaded band by band, as the JAX package's host route does."""
    a, b, exact = assemble_poisson(Grid3D(n, n, n))
    bands64, offsets, shape = DIA.host_bands(a)
    op_hi = DFDIA.from_host_bands(bands64, offsets, shape, device="cpu")
    op_lo = DIA(bands=torch.tensor(bands64.astype(np.float32)), offsets=offsets, shape=shape)
    return op_hi, op_lo, torch.tensor(b), torch.tensor(exact)


def test_host_assembly_gives_the_device_outcome():
    """The solve on the host-assembled system ends where the driver's
    device-assembled one does: the two assemblies give the same bands."""
    dev = solve_poisson(12, device="cpu", warmup=False, **KW)
    op_hi, op_lo, b, exact = _host_system(12)
    res = refined_solve_plain(
        op_hi, gamg_setup_unstructured(None, AMGParams(), fine_op=op_lo), b, rtol=KW["rtol"], atol=KW["atol"],
    )
    assert (res.iters, res.outer_iters, res.reason) == (dev.iters, dev.outer_iters, dev.reason)
    assert (res.x - exact).abs().max().item() == pytest.approx(dev.linf_error, rel=1e-9)


def test_aij_route_is_structure_blind():
    """The aij route never sees a stencil: a DIA system, a DIA hierarchy
    with geometric transfers, nothing padded."""
    op_hi, op_lo, b, exact = build_system_aij(Grid3D(8, 8, 8), "cpu")
    assert isinstance(op_hi, DFDIA) and isinstance(op_lo, DIA)
    assert op_lo.offsets == (-64, -8, -1, 0, 1, 8, 64)
    assert b.shape == exact.shape == (8**3,) and b.dtype == torch.float64
    hier = gamg_setup_unstructured(None, AMGParams(), fine_op=op_lo)
    assert all(isinstance(lev.op, DIA) for lev in hier.levels)
    assert all(isinstance(lev.transfer, GeoTransfer) for lev in hier.levels[:-1])


@pytest.mark.parametrize(
    "kw, err",
    [(dict(mat_type="csr"), ValueError), (dict(precision="f64", assembly="device"), ValueError)],
)
def test_unknown_options_raise(kw, err):
    """An unknown mat_type, and the device assembly under uniform precision
    (the JAX driver's rule: it assembles the mixed-precision split)."""
    opts = dict(KW, **kw)
    with pytest.raises(err):
        solve_poisson(8, device="cpu", **opts)


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_uniform_precision_runs_through_the_lift(precision):
    """``precision="f64"|"f32"`` with the default ``structure_detect``:
    the lifted star solved on the plain route in that dtype."""
    rep = solve_poisson(8, device="cpu", warmup=False, view=True,
                        **dict(KW, structure_detect=True, precision=precision, rtol=1e-6))
    assert rep.reason == 2 and rep.outer_iters == 0 and rep.precision == precision
    assert "star DETECTED" in rep.solver_view and "layout: plain" in rep.solver_view

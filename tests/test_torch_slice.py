"""The slice end to end at 24^3: the JAX package's padded mixed-precision
CG + GAMG solve against the port's ``solve_poisson`` on the CPU."""

import json

import pytest
import torch

from tpusparse.bench.driver import solve_poisson as j_solve_poisson
from tpusparse_torch.bench.driver import SolveReport, solve_poisson
from tpusparse_torch.solve.cg import ConvergedReason

KW = dict(rtol=1e-8, atol=1e-12, pc="gamg")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reports():
    want = j_solve_poisson(24, layout="padded", warmup=False, **KW)
    got = solve_poisson(24, device="cpu", warmup=False, **KW)
    return want, got


def test_slice_matches_jax(reports):
    want, got = reports
    # the JAX package's own outcome at this size
    assert (want.iters, want.outer_iters, want.reason) == (24, 2, 2)
    assert want.linf_error == pytest.approx(1.117e-2, abs=1e-5)
    assert (got.outer_iters, got.reason) == (want.outer_iters, want.reason)
    # inner within +-1: f32 dots summed in another order may move the last
    # inner solve across its tolerance by one iteration (exact here)
    assert abs(got.iters - want.iters) <= 1
    assert abs(got.linf_error - want.linf_error) < 1e-6   # test_padded.py:102


def test_report_contract(reports):
    _, got = reports
    lines = got.reference_block().splitlines()
    assert lines[0] == "[Nx, Ny, Nz]: [24, 24, 24]"
    assert lines[1] == f"Number of iterations: {got.iters}"
    assert lines[3].startswith("Maximum norm of error: 0.0111")
    assert lines[4].startswith("Time [init, create solver, solve]: [")
    assert got.converged_reason_line() == (
        f"Linear solve converged due to CONVERGED_RTOL iterations {got.iters}"
    )
    side = json.loads(got.json_sidecar())
    assert side["device"] == "cpu" and side["outer_iters"] == got.outer_iters
    assert min(got.t_init, got.t_setup, got.t_solve) >= 0.0


def test_reason_line_for_a_failed_solve():
    rep = SolveReport(
        nx=8, ny=8, nz=8, iters=5, resnorm=1.0, linf_error=1.0,
        reason=int(ConvergedReason.DIVERGED_ITS), t_init=0.0, t_setup=0.0,
        t_solve=0.0, rtol=1e-8, atol=1e-12, pc="gamg", device="cpu",
    )
    assert rep.converged_reason_line() == (
        "Linear solve did not converge due to DIVERGED_ITS iterations 5"
    )


def test_solve_needs_a_device_and_gamg():
    with pytest.raises(TypeError):
        solve_poisson(8, **KW)
    # the standalone block Jacobi needs the JAX package's host CSR
    with pytest.raises(ValueError, match="bjacobi"):
        solve_poisson(8, device="cpu", rtol=1e-8, pc="bjacobi")

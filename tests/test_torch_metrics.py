"""``tpusparse_torch.utils.metrics`` against the JAX package's
``tpusparse.utils.metrics``: the flop and traffic models, ``KernelStats``
and its line, ``PhaseTimer`` and the package exports; and the port's
chained timer ``chain_seconds`` on the CPU."""

import math

import pytest
import torch

import tpusparse.utils as j_utils
import tpusparse_torch.utils as utils
from tpusparse.utils import metrics as jm
from tpusparse_torch.utils import metrics as pm


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_exports_match_jax():
    assert utils.__all__ == j_utils.__all__
    for name in j_utils.__all__:
        assert getattr(utils, name) is getattr(pm, name)


@pytest.mark.parametrize("nnz, rows", [(0, None), (7, None), (188_460_000, 27_000_000), (11226, 1728), (5, 0)])
def test_spmv_flops_matches_jax(nnz, rows):
    assert pm.spmv_flops(nnz, rows) == jm.spmv_flops(nnz, rows)
    assert pm.spmv_flops(nnz) == jm.spmv_flops(nnz)


@pytest.mark.parametrize("n, width, vb, ib", [(27_000_000, 8, 4, 4), (4096, 8, 8, 4), (1000, 27, 4, 8), (1, 1, 2, 4)])
def test_ell_mv_traffic_matches_jax(n, width, vb, ib):
    assert pm.ell_mv_traffic(n, width, vb, ib) == jm.ell_mv_traffic(n, width, vb, ib)
    assert pm.ell_mv_traffic(n, width, vb) == jm.ell_mv_traffic(n, width, vb)


@pytest.mark.parametrize("n, vb, k", [(27_000_000, 4, 1), (4096, 8, 1), (1000, 4, 3), (7, 2, 0)])
def test_stencil_mv_traffic_matches_jax(n, vb, k):
    assert pm.stencil_mv_traffic(n, vb, k) == jm.stencil_mv_traffic(n, vb, k)
    assert pm.stencil_mv_traffic(n, vb) == jm.stencil_mv_traffic(n, vb)


@pytest.mark.parametrize("seconds, flops, nbytes, nnz", [
    (1.64e-4, 377_000_000, 324_000_000, 188_460_000),
    (4.65e-4, 376_920_000, 972_000_000, 188_460_000),
    (2.3e-3, 22_452, 90_000, 11_226),
    (1.0, 0, 0, 0),
])
def test_kernel_stats_match_jax(seconds, flops, nbytes, nnz):
    """Every rate and ``line()``, character for character."""
    got = pm.KernelStats("row_300^3_f32", seconds, flops, nbytes, nnz)
    want = jm.KernelStats("row_300^3_f32", seconds, flops, nbytes, nnz)
    assert (got.gflops, got.gb_s, got.nnz_per_s) == (want.gflops, want.gb_s, want.nnz_per_s)
    assert got.line() == want.line()


def test_phase_timer_accumulates_like_jax():
    for timer in (pm.PhaseTimer(), jm.PhaseTimer()):
        with timer.start("setup"):
            pass
        timer.start("solve")
        dt = timer.stop()
        with timer.start("setup"):
            pass
        assert set(timer.phases) == {"setup", "solve"} and timer.phases["solve"] == dt >= 0
        assert timer._name is None and timer._t0 is None


def test_phase_timer_refuses_an_unnamed_phase_like_jax():
    for timer in (pm.PhaseTimer(), jm.PhaseTimer()):
        with pytest.raises(AssertionError):
            with timer:
                pass


def test_chain_seconds_chains_and_times_on_cpu():
    """``reps`` chained steps a chain, one warm-up chain and ``chains``
    timed chains, each step fed the last one's output."""
    calls = []

    def step(a, v):
        calls.append(v.item())
        return v + a

    sec = pm.chain_seconds(step, (torch.tensor(1.0), torch.tensor(0.0)), reps=4, chains=3)
    assert math.isfinite(sec) and sec > 0
    assert calls == [0.0, 1.0, 2.0, 3.0] * 4

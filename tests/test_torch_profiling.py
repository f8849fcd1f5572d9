"""``-profile`` on ``torch.profiler`` (``tpusparse_torch/utils/profiling.py``):
a CPU solve through the CLI writes one Chrome trace into the directory,
and the trace names the drivers' annotated phases; the context managers
are no-ops without a directory, and ``Stopwatch`` times laps as the JAX
package's does."""

import json
import time

import pytest
import torch

from tpusparse.utils.profiling import Stopwatch as JStopwatch
from tpusparse_torch.__main__ import main
from tpusparse_torch.utils.profiling import Stopwatch, annotate, trace

PHASES = ("tpusparse:init", "tpusparse:setup", "tpusparse:solve")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _grid(n):
    return ["-da_grid_x", str(n), "-da_grid_y", str(n), "-da_grid_z", str(n)]


def _names(logdir) -> set:
    files = sorted(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    return {e.get("name") for e in events}


@pytest.mark.parametrize("argv", [[], ["-problem", "diffusion"], ["-mat_type", "aij", "-mat_structure_detect", "0"]],
                         ids=["poisson", "diffusion", "aij"])
def test_profile_writes_a_trace_naming_the_phases(tmp_path, capsys, argv):
    logdir = tmp_path / "trace"
    assert main([*_grid(6), *argv, "-profile", str(logdir), "-ksp_rtol", "1e-6", "-device", "cpu"]) == 0
    assert "Number of iterations" in capsys.readouterr().out
    names = _names(logdir)
    assert set(PHASES) <= names
    assert "aten::mul" in names  # the operators inside the phases


def test_trace_without_a_directory_is_a_no_op(tmp_path):
    with trace("") as got:
        with annotate("tpusparse:region"):
            torch.ones(3).sum()
    assert got is None
    with trace(tmp_path / "t") as got:
        with annotate("tpusparse:region"):
            torch.ones(3).sum()
    assert got == str(tmp_path / "t") and "tpusparse:region" in _names(tmp_path / "t")


def test_stopwatch_laps_as_jax():
    for sw in (Stopwatch(), JStopwatch()):
        for pause in (0.002, 0.001):
            with sw.lap():
                time.sleep(pause)
        assert len(sw.times) == 2 and sw.best == min(sw.times) >= 0.001
        assert sw.mean == pytest.approx(sum(sw.times) / 2)

"""Profiler integration — port of ``tpusparse/utils/profiling.py`` on
``torch.profiler``: the substitute for the reference's Score-P / nvprof
twin-binary infrastructure.

``trace(logdir)`` (the CLI's ``-profile <dir>``) records the enclosed
region with ``torch.profiler``: host operators, and the device's kernels
and copies (CUPTI) when a CUDA device is present, and writes one Chrome
trace, ``<worker>.<time>.pt.trace.json``, into ``logdir`` (TensorBoard's
PyTorch profiler plugin reads the directory; ``chrome://tracing`` or
Perfetto open the file).  ``annotate(name)`` marks a named phase inside
it, as the reference's PetscLogEvent brackets do.  Spans are recorded
exactly while a ``torch.profiler`` session records (``-profile``, or any
caller's own ``torch.profiler.profile``); otherwise ``annotate`` costs
one flag check.  The spans, by name:

- ``tpusparse:init``, ``tpusparse:setup``, ``tpusparse:solve``: the
  drivers' phases (``bench/driver.py``);
- ``tpusparse:ksp.solve``: one ``KSP.solve`` after its set-up, the entry
  layer;
- ``tpusparse:level<l>`` (l = 0, 1, ...): one multigrid cycle on level l
  (``amg/hierarchy.py::vcycle``; the fused fine levels of
  ``amg/fused_cycle.py`` and ``dist/fused_sharded.py`` as level 0): its
  smoothing, residual, restriction and prolongation, and level l + 1 as a
  child span; the coarsest level's direct or Jacobi solve.  A level-0
  span is one preconditioner application;
- ``tpusparse:read``: the host blocked on a device scalar (``read``), the
  Krylov layer's residual-norm reads (``solve/cg.py``,
  ``solve/refine.py``, ``ksp.py``);
- ``tpusparse:defect``: one defect-correction sweep's high-precision
  residual b - A x and the read of its norm (``solve/refine.py::
  cg_refined``), a ``tpusparse:read`` inside it.
"""

from __future__ import annotations

import contextlib
import pathlib
import time

import torch


@contextlib.contextmanager
def trace(logdir: str | pathlib.Path | None):
    """Context manager: a ``torch.profiler`` trace of the enclosed region,
    written into ``logdir`` when the region ends.  No-op when ``logdir``
    is falsy, so call sites can thread a CLI flag straight through."""
    if not logdir:
        yield None
        return
    logdir = str(logdir)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ):
        yield logdir


def sync(device: torch.device) -> None:
    """Wait for the device's queued work before a timer read (a no-op on
    the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A named sub-region inside a trace (``record_function``), for
    phase-level attribution; one shared no-op context when no profiler is
    recording."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def read(t: torch.Tensor):
    """``t.item()``, the host's read of a device scalar, inside a
    ``tpusparse:read`` span: the host waits there for the device to drain
    its queue."""
    with annotate("tpusparse:read"):
        return t.item()


class Stopwatch:
    """A repeated-region timer on the host clock, for quick spot checks
    without a trace.  The caller synchronizes the device inside the lap
    where device work must be counted."""

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def lap(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    @property
    def best(self) -> float:
        return min(self.times)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times)

"""Profiler integration — port of ``tpusparse/utils/profiling.py`` on
``torch.profiler``: the substitute for the reference's Score-P / nvprof
twin-binary infrastructure.

``trace(logdir)`` (the CLI's ``-profile <dir>``) records the enclosed
region with ``torch.profiler``: host operators, and the device's kernels
and copies (CUPTI) when a CUDA device is present, and writes one Chrome
trace, ``<worker>.<time>.pt.trace.json``, into ``logdir`` (TensorBoard's
PyTorch profiler plugin reads the directory; ``chrome://tracing`` or
Perfetto open the file).  ``annotate(name)`` marks a named phase inside
it, as the reference's PetscLogEvent brackets do; the drivers mark
``tpusparse:init``, ``tpusparse:setup`` and ``tpusparse:solve``.
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


def annotate(name: str):
    """A named sub-region inside a trace (``record_function``), for
    phase-level attribution; cheap when no trace is recording."""
    return torch.profiler.record_function(name)


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

"""The traced run's profile: capture with ``torch.profiler`` and the
reductions the per-layer readers take from it.

The arithmetic follows ``tpusparse_torch/bench/breakdown.py`` (device
time by kernel name over the profiler's device events), frozen here and
extended to the union of device intervals: kernels and copies on any
stream, overlaps counted once.  Raw kineto events are read, not the
profiler's ``FunctionEvent`` tree, which takes minutes to build for the
hundreds of thousands of events a 720^3 solve leaves.

The benchmark marks each traced solve with a span of its own,
``benchmark:step``, opened once the device has finished making the
solve's right-hand side and closed once it has finished the solve.  The
traced window is those spans: what the device does between solves (the
next right-hand side's generation) is left out.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

STEP_SPAN = "benchmark:step"
COPY_PREFIXES = ("Memcpy", "Memset")  # device events that are no kernel


@dataclasses.dataclass
class Trace:
    gpu_name: list[str]
    gpu_start: np.ndarray   # ns, the profiler's clock
    gpu_end: np.ndarray
    cpu_name: list[str]
    cpu_start: np.ndarray
    cpu_end: np.ndarray
    spans: np.ndarray       # (m, 2): the traced steps, in order

    @property
    def window_s(self) -> float:
        """The traced steps' seconds, summed."""
        return float(np.sum(self.spans[:, 1] - self.spans[:, 0])) / 1e9

    def _inside(self) -> np.ndarray:
        """Device events that ran inside a traced step."""
        i = np.searchsorted(self.spans[:, 0], self.gpu_start, side="right") - 1
        ok = i >= 0
        ok[ok] = self.gpu_end[ok] <= self.spans[i[ok], 1]
        return ok

    def kernel_mask(self, whole: bool = False) -> np.ndarray:
        """Device events inside the steps that are kernels; with ``whole``,
        every kernel of the capture."""
        is_kernel = np.array([not n.startswith(COPY_PREFIXES) for n in self.gpu_name], dtype=bool)
        return is_kernel if whole else self._inside() & is_kernel

    def busy_intervals(self) -> np.ndarray:
        """The union of the device intervals inside the steps, as (m, 2)."""
        keep = self._inside()
        starts, ends = self.gpu_start[keep], self.gpu_end[keep]
        if starts.size == 0:
            return np.zeros((0, 2), dtype=np.int64)
        order = np.argsort(starts, kind="stable")
        starts, ends = starts[order], np.maximum.accumulate(ends[order])
        # a new interval starts where an event begins after all before it ended
        new = np.ones(starts.size, dtype=bool)
        new[1:] = starts[1:] > ends[:-1]
        first = np.flatnonzero(new)
        last = np.append(first[1:] - 1, starts.size - 1)
        return np.stack([starts[first], ends[last]], axis=1)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float(np.sum(iv[:, 1] - iv[:, 0])) / 1e9

    def by_name(self) -> dict[str, tuple[float, int]]:
        """Device seconds and event count by name, inside the steps."""
        out: dict[str, list] = {}
        for i in np.flatnonzero(self._inside()):
            entry = out.setdefault(self.gpu_name[i], [0.0, 0])
            entry[0] += (self.gpu_end[i] - self.gpu_start[i]) / 1e9
            entry[1] += 1
        return {k: (v[0], v[1]) for k, v in out.items()}

    def idle_gaps(self, top: int = 10) -> list[tuple[str, float]]:
        """The ``top`` longest stretches of a step with nothing on the
        device, each named by the innermost host operation running at its
        middle (the shortest host event that spans it), longest first."""
        iv = self.busy_intervals()
        edges = []
        for s, e in self.spans:
            inside = iv[(iv[:, 0] >= s) & (iv[:, 1] <= e)]
            edges.append(np.concatenate([[s], inside.ravel(), [e]]).reshape(-1, 2))
        edges = np.concatenate(edges)
        lengths = edges[:, 1] - edges[:, 0]
        gaps = []
        for i in np.argsort(-lengths, kind="stable")[:top]:
            if lengths[i] <= 0:
                break
            mid = (edges[i, 0] + edges[i, 1]) // 2
            spans = [j for j in np.flatnonzero((self.cpu_start <= mid) & (self.cpu_end >= mid))
                     if self.cpu_name[j] != STEP_SPAN]
            name = min(spans, key=lambda j: self.cpu_end[j] - self.cpu_start[j]) if spans else None
            gaps.append((self.cpu_name[name] if name is not None else "(no host operation)", lengths[i] / 1e9))
        return gaps


@contextlib.contextmanager
def capture(device: torch.device):
    """Profile the block: host operations, and the device's kernels and
    copies where ``device`` is a GPU.  Yields a list that holds the
    ``Trace`` once the block has ended (empty when no step was marked)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out: list[Trace] = []
    with torch.profiler.profile(activities=acts) as prof:
        yield out
    trace = _read(prof)
    if trace is not None:
        out.append(trace)


def _read(prof) -> Trace | None:
    events = prof.profiler.kineto_results.events()
    gpu, cpu = [], []
    for e in events:
        row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            cpu.append(row)
        elif not e.is_user_annotation():  # a span's shadow on the device timeline is no work
            gpu.append(row)
    steps = sorted((s, t) for n, s, t in cpu if n == STEP_SPAN)
    if not steps:
        return None

    def arrays(rows):
        return ([r[0] for r in rows], np.array([r[1] for r in rows], dtype=np.int64),
                np.array([r[2] for r in rows], dtype=np.int64))

    gn, gs, ge = arrays(gpu)
    cn, cs, ce = arrays(cpu)
    return Trace(gn, gs, ge, cn, cs, ce, spans=np.array(steps, dtype=np.int64))


def step_span():
    """The span that marks one traced step."""
    return torch.profiler.record_function(STEP_SPAN)

"""The program's own spans in a traced run, and the interval arithmetic the
span readers share.

``tpusparse_torch`` opens ``record_function`` spans at the layer
boundaries of its solve path while a profiler records
(``tpusparse_torch/utils/profiling.py``): ``tpusparse:ksp.solve`` around
one ``KSP.solve``, ``tpusparse:level<l>`` around one multigrid cycle on
level l (level l + 1 nested inside it; level 0 is one preconditioner
application) and ``tpusparse:read`` around each host read of a residual
norm.  They land among the host events of the benchmark's ``Trace``, on
the clock of its device events.  This module reads only the public parts
of a ``Trace``: ``cpu_name``, ``cpu_start``, ``cpu_end``, ``spans`` and
``busy_intervals()``.

Intervals are (m, 2) int64 arrays of [start, end) in nanoseconds; a
"union" is sorted, disjoint and merged where intervals touch.  Overlaps
are computed exactly on the intervals' own edges.
"""

from __future__ import annotations

import numpy as np

KSP_SOLVE = "tpusparse:ksp.solve"
READ = "tpusparse:read"
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")  # launch calls of both CUDA APIs
EMPTY = np.zeros((0, 2), dtype=np.int64)


def level(index: int) -> str:
    """The span of one cycle on level ``index``."""
    return f"tpusparse:level{index}"


def union(iv) -> np.ndarray:
    """The union of the intervals ``iv``, as a sorted disjoint array."""
    iv = np.asarray(iv, dtype=np.int64).reshape(-1, 2)
    iv = iv[iv[:, 1] > iv[:, 0]]
    if iv.size == 0:
        return EMPTY
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    starts, ends = iv[:, 0], np.maximum.accumulate(iv[:, 1])
    new = np.ones(starts.size, dtype=bool)
    new[1:] = starts[1:] > ends[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, starts.size - 1)
    return np.stack([starts[first], ends[last]], axis=1)


def member(points, u: np.ndarray) -> np.ndarray:
    """Which of ``points`` lie in the union ``u`` (each interval [start, end))."""
    points = np.asarray(points, dtype=np.int64)
    if u.size == 0:
        return np.zeros(points.shape, dtype=bool)
    i = np.searchsorted(u[:, 0], points, side="right") - 1
    ok = i >= 0
    ok[ok] = points[ok] < u[i[ok], 1]
    return ok


def _combine(a: np.ndarray, b: np.ndarray, keep) -> np.ndarray:
    """The union of the pieces between the edges of unions ``a`` and ``b``
    for which ``keep(in_a, in_b)`` holds."""
    edges = np.unique(np.concatenate([a.ravel(), b.ravel()]))
    if edges.size < 2:
        return EMPTY
    lo, hi = edges[:-1], edges[1:]
    kept = keep(member(lo, a), member(lo, b))
    return union(np.stack([lo[kept], hi[kept]], axis=1))


def intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _combine(a, b, lambda x, y: x & y)


def subtract(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _combine(a, b, lambda x, y: x & ~y)


def seconds(u: np.ndarray) -> float:
    return float(np.sum(u[:, 1] - u[:, 0])) / 1e9


def named(trace, name: str) -> np.ndarray:
    """The union of the host events called ``name``."""
    keep = np.fromiter((n == name for n in trace.cpu_name), dtype=bool, count=len(trace.cpu_name))
    return union(np.stack([trace.cpu_start[keep], trace.cpu_end[keep]], axis=1))


def steps(trace) -> np.ndarray:
    """The traced steps (``benchmark:step``)."""
    return union(trace.spans)


def idle(trace) -> np.ndarray:
    """The stretches of the steps in which no kernel or copy ran."""
    return subtract(steps(trace), union(trace.busy_intervals()))


def launch_starts(trace) -> np.ndarray:
    """The start of every host launch call, in the order of the events."""
    keep = np.fromiter((n.startswith(LAUNCH_PREFIXES) for n in trace.cpu_name), dtype=bool,
                       count=len(trace.cpu_name))
    return trace.cpu_start[keep]


def levels(trace) -> list[np.ndarray]:
    """Each level's union of cycle spans, from level 0 to the deepest."""
    out = []
    while True:
        u = named(trace, level(len(out)))
        if u.size == 0:
            return out
        out.append(u)


def traced_iters(run) -> int:
    """The inner iterations of the traced solves."""
    return sum(s["iters"] for s in run.solves if s["traced"])


def on_device(run) -> bool:
    """The run has a trace with device events in its steps."""
    return run.trace is not None and run.trace.busy_intervals().size > 0


def report(run) -> list[str]:
    """Lines for the run's log: each level's host time, the device's idle
    time while the host was in that level and not in a deeper one, and the
    launch calls it made itself, over the traced solves' inner
    iterations; then the idle time outside every ``tpusparse:ksp.solve``
    and the launch calls in the steps."""
    trace = run.trace
    if not on_device(run):
        return []
    iters = max(traced_iters(run), 1)
    window = trace.window_s
    inside, gaps, starts = steps(trace), idle(trace), launch_starts(trace)
    lines = []
    lvls = levels(trace)
    for index, u in enumerate(lvls):
        own = subtract(u, lvls[index + 1]) if index + 1 < len(lvls) else u
        own = intersect(own, inside)
        lines.append(f"span {level(index)}: host {seconds(intersect(u, inside)):.6f} s, idle while in it and in no"
                     f" deeper level {seconds(intersect(gaps, own)):.6f} s"
                     f" ({100 * seconds(intersect(gaps, own)) / window:.3f}% of the window),"
                     f" launch calls of its own {int(member(starts, own).sum()) / iters:.2f} an inner iteration")
    outside = subtract(gaps, named(trace, KSP_SOLVE))
    lines.append(f"spans: idle outside {KSP_SOLVE} {seconds(outside):.6f} s ({100 * seconds(outside) / window:.3f}%);"
                 f" launch calls in the steps {int(member(starts, inside).sum())}")
    return lines

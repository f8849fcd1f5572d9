"""fine_roofline_pct.solve: over the traced capture's ``varstencil27_mv``
launches on the largest grid recorded (``benchmark/fine.py``: the
27-point fine level's applies, float32 and float64), the least time their
work needs on this card (``kernel_models/V27.json``: the larger of its
bytes over the published bandwidth and its flops over the float32 peak,
``peaks.json``) as a share of the time the trace gives them."""

from benchmark.fine import fine_launches
from benchmark.roofline import least_seconds


def read(run):
    if run.peak is None:
        return None
    found = fine_launches(run)
    if found is None:
        return None
    model, launches = found
    trace = run.trace
    traced = sum(float(trace.gpu_end[i] - trace.gpu_start[i]) for _, i in launches) / 1e9
    if traced <= 0:
        return None
    least = sum(least_seconds(model, args, run.peak) for args, _ in launches)
    print(f"fine level: {len(launches)} varstencil27_mv launches, {least:.6f} s least of {traced:.6f} s traced",
          flush=True)
    return 100.0 * least / traced

"""fine_applies_per_iter.solve: the ``varstencil27_mv`` launches on the
largest grid recorded (``benchmark/fine.py``: the 27-point fine level's
operator applies, float32 and float64) that ran inside the traced solves,
over those solves' inner iterations: CG's apply, the Chebyshev smoothers'
and the smoothed transfers' on level 0, and each sweep's float64
residual."""

from benchmark import spans
from benchmark.fine import fine_launches


def read(run):
    found = fine_launches(run)
    total = spans.traced_iters(run)
    if found is None or total == 0:
        return None
    inside = run.trace.kernel_mask()
    return sum(bool(inside[i]) for _, i in found[1]) / total

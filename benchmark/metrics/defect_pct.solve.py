"""defect_pct.solve: the device's busy time inside the program's
``tpusparse:defect`` spans (``solve/refine.py::cg_refined``: each
defect-correction sweep's float64 residual b - A x and its norm's read),
as a share of its busy time in the traced solves.  A step with no such
span adds its busy time to the whole and nothing to the share; a program
that opens no such span gives no reading."""

from benchmark import spans

DEFECT = "tpusparse:defect"


def read(run):
    if not spans.on_device(run):
        return None
    defect = spans.named(run.trace, DEFECT)
    if defect.size == 0:
        return None
    busy = spans.intersect(run.trace.busy_intervals(), spans.steps(run.trace))
    total = spans.seconds(busy)
    if total <= 0:
        return None
    return 100.0 * spans.seconds(spans.intersect(busy, defect)) / total

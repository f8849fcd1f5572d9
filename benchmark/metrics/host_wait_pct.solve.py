"""host_wait_pct.solve: the share of the traced solves' time in which the
host sat in a read of a device scalar (the Krylov layer's residual-norm
reads, ``tpusparse:read`` spans), waiting for the device to drain its
queue: 100 x the union of those spans inside the steps, over the steps'
length."""

from benchmark import spans


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    reads = spans.named(run.trace, spans.READ)
    if reads.size == 0:
        return None
    return 100.0 * spans.seconds(spans.intersect(reads, spans.steps(run.trace))) / run.trace.window_s

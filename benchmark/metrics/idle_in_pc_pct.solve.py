"""idle_in_pc_pct.solve: the share of the traced solves' time in which no
kernel or copy ran on the card while the host was applying the
preconditioner (inside a ``tpusparse:level0`` span: one V-cycle, the
coarse levels included), over the steps' length."""

from benchmark import spans


def read(run):
    if not spans.on_device(run) or run.trace.window_s <= 0:
        return None
    pc = spans.named(run.trace, spans.level(0))
    if pc.size == 0:
        return None
    return 100.0 * spans.seconds(spans.intersect(spans.idle(run.trace), pc)) / run.trace.window_s

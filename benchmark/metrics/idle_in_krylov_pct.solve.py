"""idle_in_krylov_pct.solve: the share of the traced solves' time in which
no kernel or copy ran on the card while the host was inside
``tpusparse:ksp.solve`` and outside every ``tpusparse:level0`` span: the
Krylov layer's vector updates, dots, norm reads and float64 residuals,
over the steps' length.  With ``idle_in_pc_pct.solve`` it sums to the
idle time inside the solves."""

from benchmark import spans


def read(run):
    if not spans.on_device(run) or run.trace.window_s <= 0:
        return None
    solve = spans.named(run.trace, spans.KSP_SOLVE)
    if solve.size == 0:
        return None
    krylov = spans.subtract(solve, spans.named(run.trace, spans.level(0)))
    return 100.0 * spans.seconds(spans.intersect(spans.idle(run.trace), krylov)) / run.trace.window_s

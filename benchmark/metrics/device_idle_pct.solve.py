"""device_idle_pct.solve: the share of the traced solves' time in which no
kernel or copy ran on the card (100 x (1 - the union of the device
intervals over the solves' length))."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or run.trace.gpu_start.size == 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)

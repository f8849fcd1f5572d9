"""launches_per_iter.solve: the device kernels the profiler saw in the
traced solves, over those solves' inner iterations.  Copies and memsets
are not counted."""


def read(run):
    if run.trace is None:
        return None
    kernels = int(run.trace.kernel_mask().sum())
    total = sum(s["iters"] for s in run.solves if s["traced"])
    if kernels == 0 or total == 0:
        return None
    return kernels / total

"""kernel_roofline_pct.solve: over the traced solves' launches of every
device kernel that has a model in ``kernel_models/`` (every launch of the
capture, ``roofline.kernel_shares``), the least time their work needs on
this card (the larger of the model's bytes over the published bandwidth
and its flops over the float32 peak, ``peaks.json``) as a share of the
time the trace gives them."""

from benchmark.roofline import kernel_shares


def read(run):
    if run.trace is None or run.peak is None or not run.launches:
        return None
    shares = kernel_shares(run.models, run.launches, run.trace, run.peak)
    traced = sum(sec for _, sec in shares.values())
    if traced <= 0:
        return None
    return 100.0 * sum(least for least, _ in shares.values()) / traced

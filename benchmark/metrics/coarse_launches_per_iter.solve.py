"""coarse_launches_per_iter.solve: the host's launch calls
(``cudaLaunch*``, ``cuLaunch*``) that start inside a
``tpusparse:level1`` span in the traced solves, over those solves' inner
iterations: the launches the coarse levels (1 and below) issue.  Prints
the per-level split of idle time and launches on the log."""

from benchmark import spans


def read(run):
    if not spans.on_device(run):
        return None
    coarse = spans.named(run.trace, spans.level(1))
    total = spans.traced_iters(run)
    if coarse.size == 0 or total == 0:
        return None
    for line in spans.report(run):
        print(line, flush=True)
    inside = spans.intersect(coarse, spans.steps(run.trace))
    return int(spans.member(spans.launch_starts(run.trace), inside).sum()) / total

"""inner_iters.solve: the mean inner Krylov iterations a right-hand side
(``KSPResult.iters``: every defect-correction sweep's inner CG summed),
over all the window's solves."""


def read(run):
    if not run.solves:
        return None
    return sum(s["iters"] for s in run.solves) / len(run.solves)

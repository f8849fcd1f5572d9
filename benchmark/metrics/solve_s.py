"""solve_s: the window's seconds over the solves completed in it, the mean
time to a solution of one right-hand side (the reference's KSPSolve wall
time).  The window holds everything the loop does: making each
right-hand side, the solve, and copying the check's sample."""


def read(run):
    if not run.solves:
        return None
    return run.window_s / len(run.solves)

"""setup_s: seconds from the process's start to the window's: the torch
import, the card's context, loading (at a checkout's first run, building)
the kernel library, the operator, the preconditioner and the warm-up."""


def read(run):
    return run.setup_s

"""Global reductions of a solve whose vectors are split over ranks.

The JAX package's GSPMD program turns every dot of a sharded solve into a
per-device partial and one ``psum`` (``tpusparse/dist/mesh.py``).  Here a
rank holds its own z-slab of each vector (``dist/mesh.py``), so a dot or a
norm is a local partial followed by one ``all_reduce``.  Every global
reduction of ``solve/`` goes through ``allreduce``: the Krylov dots
(``cg._dot``, so ``norm_h`` too), the CGS2 products of (F)GMRES, the outer
norm of ``cg_refined`` and the driver's Linf (a MAX).

``reductions(comm)`` makes ``comm`` the transport of the solve that runs
inside it: ``comm.allreduce(t, op)`` with op "sum" or "max" and
``comm.offset``, the global flat index of the rank's first cell (for the
start vectors that are built from global indices).  Outside it, or with
``comm`` None (one rank), every reduction is the local one, untouched.
The hierarchy's setup runs outside it: each rank builds the whole
hierarchy, as the JAX package builds it before placing it.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

# the transport of the solve running in this context (None: local); a
# context variable, so a thread or task of its own never sees another's
_COMM = contextvars.ContextVar("tpusparse_torch_solve_comm", default=None)


@contextlib.contextmanager
def reductions(comm):
    """Route the global reductions of the code inside through ``comm``
    (None: local)."""
    token = _COMM.set(comm)
    try:
        yield
    finally:
        _COMM.reset(token)


def distributed() -> bool:
    """True inside ``reductions`` over several ranks."""
    return _COMM.get() is not None


def allreduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` summed (or maxed) over the ranks; ``t`` itself on one."""
    comm = _COMM.get()
    return t if comm is None else comm.allreduce(t, op)


def global_offset() -> int:
    """The global flat index of this rank's first cell (0 on one rank)."""
    comm = _COMM.get()
    return 0 if comm is None else comm.offset

"""Flexible GMRES — KSPFGMRES parity; port of ``tpusparse/solve/fgmres.py``.

Right-preconditioned restarted GMRES that tolerates a different
preconditioner application every iteration: a second basis stores
z_j = M^-1 v_j, and the solution update x += Z y is exact even when M
varies.  Convergence is gated on the TRUE residual norm |g[j+1]| =
||b - A x|| (KSP_NORM_UNPRECONDITIONED).  The restart cycle is
``solve/gmres.py::_cycle``.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpusparse_torch.solve.cg import (
    CGResult,
    ConvergedReason,
    convergence_test,
    new_history,
    norm_h,
    np_float,
)
from tpusparse_torch.solve.gmres import _cycle


def fgmres(
    a_mv: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 10000,
    restart: int = 30,
    m_mv: Callable | None = None,
    divtol: float = 1e5,
    history: bool = False,
):
    """Solve A x = b with flexible (right-preconditioned) GMRES(restart).
    ``m_mv`` may be a variable or inexact preconditioner.  ``history=True``
    returns ``(result, norms)`` as ``cg`` does."""
    if m_mv is None:
        m_mv = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    shape = b.shape
    f = np_float(b.dtype)
    bnorm = norm_h(b, f)
    classify = convergence_test(f, bnorm, rtol, atol, divtol, maxiter)

    def apply(vj):
        zj = m_mv(vj.reshape(shape))
        return a_mv(zj).reshape(-1), zj.reshape(-1)

    r = b - a_mv(x)                      # TRUE residual (right PC)
    rnorm, it = norm_h(r, f), 0
    norms = new_history(maxiter, rnorm) if history else None
    while classify(rnorm, it) == ConvergedReason.ITERATING:
        if it:
            r = b - a_mv(x)
        dx, rnorm, it = _cycle(r, apply, int(restart), classify, rnorm, it, f, norms)
        x = x + dx.reshape(shape)
    result = CGResult(
        x=x, iters=it, resnorm=float(rnorm), reason=int(classify(rnorm, it)),
        bnorm=float(bnorm),
    )
    return (result, norms) if history else result

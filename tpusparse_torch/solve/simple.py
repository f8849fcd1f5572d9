"""Simple KSP types — Richardson iteration and preonly; port of
``tpusparse/solve/simple.py``.

PETSc exposes both as top-level KSP types; under mixed precision they are
the inner solver of each defect-correction sweep ("multigrid as a solver"
with ``pc=gamg``).  Same contract as ``cg``: ``CGResult`` and PETSc
converged reasons, one host read per iteration.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tpusparse_torch.solve.cg import (
    CGResult,
    ConvergedReason,
    convergence_test,
    new_history,
    norm_h,
    np_float,
)


def richardson(
    a_mv: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 10000,
    m_mv: Callable | None = None,
    scale: float = 1.0,
    divtol: float = 1e5,
    history: bool = False,
):
    """Preconditioned Richardson iteration x += scale * M (b - A x)
    (KSPRICHARDSON with ``-ksp_richardson_scale``); ``history=True``
    returns ``(result, norms)`` as ``cg`` does."""
    if m_mv is None:
        m_mv = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    f = np_float(b.dtype)
    bnorm = norm_h(b, f)
    classify = convergence_test(f, bnorm, rtol, atol, divtol, maxiter)
    w = float(f(scale))

    r = b - a_mv(x)
    rnorm, it = norm_h(r, f), 0
    norms = new_history(maxiter, rnorm) if history else None
    reason = classify(rnorm, it)
    while reason == ConvergedReason.ITERATING:
        x = x + w * m_mv(r)
        r = b - a_mv(x)
        rnorm, it = norm_h(r, f), it + 1
        if history:
            norms[it] = rnorm
        reason = classify(rnorm, it)
    result = CGResult(x=x, iters=it, resnorm=float(rnorm), reason=int(reason), bnorm=float(bnorm))
    return (result, norms) if history else result


def preonly(
    a_mv: Callable,
    b: torch.Tensor,
    x0=None,
    *,
    rtol: float = 0.0,
    atol: float = 0.0,
    maxiter: int = 1,
    m_mv: Callable | None = None,
    divtol: float = 1e5,
    history: bool = False,
):
    """One preconditioner application, x = M b (KSPPREONLY).

    The tolerance and iteration arguments exist for interface compatibility
    and are ignored (PETSc's preonly performs no convergence test); the
    residual is reported for observability.  ``history=True`` returns
    ``(result, [||b||, ||b - A x||])`` as f32 values.
    """
    del x0, rtol, atol, maxiter, divtol
    if m_mv is None:
        m_mv = lambda r: r  # noqa: E731
    f = np_float(b.dtype)
    x = m_mv(b)
    result = CGResult(
        x=x, iters=1, resnorm=float(norm_h(b - a_mv(x), f)),
        reason=int(ConvergedReason.CONVERGED_RTOL), bnorm=float(norm_h(b, f)),
    )
    if history:
        return result, np.array([result.bnorm, result.resnorm], np.float32)
    return result

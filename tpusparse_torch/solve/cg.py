"""Preconditioned conjugate gradients — port of ``tpusparse/solve/cg.py``.

Parity target: KSPCG with KSPConvergedDefault on the unpreconditioned
residual (``src/main_ksp.cpp:92-117``), checked every iteration, with a
converged-reason API that distinguishes rtol/atol convergence from
iteration-limit, divergence-tolerance and NaN failure.

The JAX package runs the loop as one ``lax.while_loop``; here it is a
Python loop over device tensors that reads one scalar (the residual norm)
to the host per iteration for the convergence test.  The scalar algebra of
the test is done in numpy scalars of ``b``'s dtype, as JAX does it on 0-d
arrays.  The operator and preconditioner come in as callables, including
the fused forms ``a_mv_dot`` (``PaddedStar.mv_dot``) and ``m_mv_dots``
(``amg.fused_cycle.vcycle_fused_dots``).

Sign note: the reference assembles a negative-definite Laplacian; CG's
recurrences are sign-symmetric, so the system is solved as assembled.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable

import numpy as np
import torch


class ConvergedReason(enum.IntEnum):
    """PETSc's KSPConvergedReason sign convention (> 0 converged, < 0
    diverged), with the same values as the JAX package."""

    CONVERGED_RTOL = 2
    CONVERGED_ATOL = 3
    # defect correction reached the attainable true-residual floor before
    # rtol; deliberately outside PETSc's range (see tpusparse/solve/cg.py)
    CONVERGED_STALLED = 100
    CONVERGED_ITS = 4
    ITERATING = 0
    DIVERGED_ITS = -3
    DIVERGED_DTOL = -4
    DIVERGED_NANORINF = -9


@dataclasses.dataclass
class CGResult:
    x: torch.Tensor
    iters: int
    resnorm: float      # final residual 2-norm
    reason: int         # ConvergedReason value
    bnorm: float

    def converged(self) -> bool:
        return self.reason > 0


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Flattened dot as a 0-d device tensor."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def np_float(dtype: torch.dtype):
    """The numpy scalar type of a float tensor dtype: scalar algebra in it
    rounds as JAX's does on 0-d arrays of that dtype."""
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def convergence_test(f, ref, rtol: float, atol: float, divtol: float, maxiter: int):
    """KSPConvergedDefault as ``classify(rnorm, it)`` on host scalars of
    numpy type ``f``: converged at ``max(rtol*ref, atol)``, diverged at
    ``divtol*ref`` (divtol <= 0 disables that test) or past ``maxiter``.
    ``ref`` is the norm the method gates against (``||b||`` for most)."""
    atol_f = f(atol)
    tol = max(f(rtol) * ref, atol_f)
    dgate = f(divtol) * ref if divtol and divtol > 0 else f(math.inf)

    def classify(rnorm, it):
        if not math.isfinite(rnorm):
            return ConvergedReason.DIVERGED_NANORINF
        if rnorm <= atol_f:
            return ConvergedReason.CONVERGED_ATOL
        if rnorm <= tol:
            return ConvergedReason.CONVERGED_RTOL
        if rnorm >= dgate:
            return ConvergedReason.DIVERGED_DTOL
        if it >= maxiter:
            return ConvergedReason.DIVERGED_ITS
        return ConvergedReason.ITERATING

    return classify


def norm_h(v: torch.Tensor, f):
    """||v||_2 read to the host as a numpy scalar of type ``f``."""
    return f(torch.sqrt(_dot(v, v)).item())


def cg(
    a_mv: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 10000,
    m_mv: Callable | None = None,
    a_mv_dot: Callable | None = None,
    m_mv_dots: Callable | None = None,
    divtol: float = 1e5,
) -> CGResult:
    """Solve A x = b with (preconditioned) CG.

    Convergence: ||r||_2 <= max(rtol*||b||_2, atol), checked every
    iteration; ||r||_2 >= divtol*||b||_2 reports DIVERGED_DTOL (divtol <= 0
    disables it).  ``a_mv_dot(p) -> (A p, <p, A p>)`` replaces the apply and
    the alpha-denominator dot; ``m_mv_dots(r) -> (z, <r, z>, <r, r>)``
    replaces the preconditioner and both residual reductions (and overrides
    ``m_mv``).
    """
    if m_mv is None:
        m_mv = lambda r: r  # noqa: E731
    if x0 is None:
        x0 = torch.zeros_like(b)  # the reference zeroes the initial guess

    f = np_float(b.dtype)
    bnorm = norm_h(b, f)
    classify = convergence_test(f, bnorm, rtol, atol, divtol, maxiter)

    x = x0
    r = b - a_mv(x0)
    if m_mv_dots is not None:
        z, rz, rr = m_mv_dots(r)
        rnorm = torch.sqrt(rr)
    else:
        z = m_mv(r)
        rz = _dot(r, z)
        rnorm = torch.sqrt(_dot(r, r))
    p = z
    it = 0
    rnorm_h = f(rnorm.item())
    reason = classify(rnorm_h, it)
    while reason == ConvergedReason.ITERATING:
        if a_mv_dot is not None:
            ap, pap = a_mv_dot(p)
            alpha = rz / pap.to(rz.dtype)
        else:
            ap = a_mv(p)
            alpha = rz / _dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        if m_mv_dots is not None:
            z, rz_new, rr = m_mv_dots(r)
            rnorm = torch.sqrt(rr)
        else:
            z = m_mv(r)
            rz_new = _dot(r, z)
            rnorm = torch.sqrt(_dot(r, r))
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        it += 1
        rnorm_h = f(rnorm.item())  # the one host read per iteration
        reason = classify(rnorm_h, it)
    return CGResult(
        x=x, iters=it, resnorm=float(rnorm_h), reason=int(reason),
        bnorm=float(bnorm),
    )

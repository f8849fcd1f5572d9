"""BiCGStab — KSPBCGS parity; port of ``tpusparse/solve/bcgs.py``.

Right-preconditioned with convergence on the true residual (PETSc's
KSPBCGS default is left preconditioning with the preconditioned norm: the
two agree on the solution, not on counts near the tolerance).  Breakdown
(rho or omega ~ 0) is reported as ``DIVERGED_BREAKDOWN`` (PETSc's
KSP_DIVERGED_BREAKDOWN = -5) with the pre-breakdown state.

Scalars stay 0-d device tensors; the one host read per iteration carries
the residual norm and the breakdown flag together.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpusparse_torch.solve.cg import (
    CGResult,
    ConvergedReason,
    _dot,
    convergence_test,
    new_history,
    norm_h,
    np_float,
)

DIVERGED_BREAKDOWN = -5  # PETSc KSP_DIVERGED_BREAKDOWN


def bicgstab(
    a_mv: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 10000,
    m_mv: Callable | None = None,
    divtol: float = 1e5,
    history: bool = False,
):
    """Solve A x = b with preconditioned BiCGStab.  ``divtol`` is accepted
    for the common interface and, as in the JAX package, not tested.
    ``history=True`` returns ``(result, norms)`` as ``cg`` does; a
    breakdown's iteration counts but records no norm."""
    if m_mv is None:
        m_mv = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    dt = b.dtype
    f = np_float(dt)
    bnorm = norm_h(b, f)
    classify = convergence_test(f, bnorm, rtol, atol, 0.0, maxiter)
    eps = float(f(torch.finfo(dt).tiny * 1e4))
    one = torch.ones((), dtype=dt, device=b.device)

    r0 = b - a_mv(x)
    r = r0
    p = v = torch.zeros_like(b)
    rho = alpha = omega = one
    rnorm, it, broke = norm_h(r0, f), 0, False
    norms = new_history(maxiter, rnorm) if history else None
    reason = classify(rnorm, it)
    while reason == ConvergedReason.ITERATING:
        rho_new = _dot(r0, r)
        brk = rho_new.abs() <= eps
        beta = (rho_new / torch.where(brk, one, rho)) * (
            alpha / torch.where(omega == 0, one, omega)
        )
        p_new = r + beta * (p - omega * v)
        ph = m_mv(p_new)
        v_new = a_mv(ph)
        denom = _dot(r0, v_new)
        brk = brk | (denom.abs() <= eps)
        alpha_new = rho_new / torch.where(brk, one, denom)
        s = r - alpha_new * v_new
        sh = m_mv(s)
        t = a_mv(sh)
        tt = _dot(t, t)
        omega_new = _dot(t, s) / torch.where(tt == 0, one, tt)
        r_new = s - omega_new * t
        # one host read: ||r_new|| and the breakdown flag
        rn_h, brk_h = torch.stack([torch.sqrt(_dot(r_new, r_new)), brk.to(dt)]).tolist()
        it += 1
        if brk_h:
            # PETSc's BCGS exits before the update: the substituted unit
            # denominators only kept the arithmetic finite
            broke = True
            break
        x = x + alpha_new * ph + omega_new * sh
        r, p, v = r_new, p_new, v_new
        rho, alpha, omega = rho_new, alpha_new, omega_new
        rnorm = f(rn_h)
        if history:
            norms[it] = rnorm
        reason = classify(rnorm, it)
    result = CGResult(
        x=x, iters=it, resnorm=float(rnorm),
        reason=DIVERGED_BREAKDOWN if broke else int(reason), bnorm=float(bnorm),
    )
    return (result, norms) if history else result

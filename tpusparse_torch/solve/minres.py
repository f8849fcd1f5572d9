"""MINRES — PETSc ``KSPMINRES`` parity (symmetric, possibly indefinite A);
port of ``tpusparse/solve/minres.py``.

Paige–Saunders with an SPD preconditioner M: one A-apply and one M-apply
per iteration, a 3-term Lanczos recurrence and a Givens-QR update of the
solution.  Convergence follows KSP_NORM_PRECONDITIONED: the recurrence
scalar ``phibar`` (= sqrt(<r, M r>)) is gated against
``max(rtol * phibar0, atol)``; the returned ``resnorm`` is the true
``||b - A x||``.  A negative-definite M (the GAMG V-cycle on the
reference's A = nabla^2 sign convention) is auto-negated.

Scalars stay 0-d device tensors; the one host read per iteration is
``phibar``.
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

__all__ = ["minres"]


def minres(
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
    """Solve A x = b, A symmetric (indefinite allowed), M definite.  An
    indefinite M surfaces as DIVERGED_NANORINF.  ``history=True`` returns
    ``(result, norms)`` as ``cg`` does, with ``phibar`` (the gated norm) in
    place of ||r||."""
    if m_mv is None:
        m_mv = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    dt = b.dtype
    f = np_float(dt)
    dev = b.device
    eps = torch.tensor(torch.finfo(dt).tiny * 16, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    bnorm = norm_h(b, f)

    r1 = b - a_mv(x)
    y_raw = m_mv(r1)
    beta1_sq_raw = _dot(r1, y_raw)
    # -M is SPD where M is negative definite, and preconditioned MINRES with
    # -M solves the same system (M only shapes the Lanczos inner product)
    msign = float(-1.0 if beta1_sq_raw.item() < 0 else 1.0)
    y = msign * y_raw
    beta = torch.sqrt(torch.clamp(msign * beta1_sq_raw, min=0.0))
    beta1 = f(beta.item())
    classify = convergence_test(f, beta1, rtol, atol, divtol, maxiter)

    r2 = r1
    w = w2 = torch.zeros_like(b)
    oldb = dbar = epsln = sn = zero
    cs = -torch.ones((), dtype=dt, device=dev)
    phibar = beta
    phibar_h, it = beta1, 0
    norms = new_history(maxiter, beta1) if history else None
    # beta1 == 0: r0 = 0 (or M r0 = 0), already converged
    while classify(phibar_h, it) == ConvergedReason.ITERATING and beta1 > 0:
        # Lanczos step: v = y / beta; y <- M (A v - (beta/oldb) r1 -
        # (alfa/beta) r2) in the stable two-stage form
        v = y / beta
        ay = a_mv(v)
        if it > 0:
            ay = ay - (beta / oldb) * r1
        alfa = _dot(v, ay)
        ay = ay - (alfa / beta) * r2
        r1, r2 = r2, ay
        y = msign * m_mv(r2)
        oldb = beta
        beta_sq = _dot(r2, y)
        betan = torch.sqrt(torch.clamp(beta_sq, min=0.0))
        # previous rotation applied to the new Lanczos column
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * betan
        dbar = -cs * betan
        # current rotation
        gamma = torch.maximum(torch.sqrt(gbar * gbar + betan * betan), eps)
        cs = gbar / gamma
        sn = betan / gamma
        phi = cs * phibar
        phibar = torch.where(beta_sq < 0, torch.nan, sn * phibar)  # indefinite M
        # solution update
        w1 = w2
        w2 = w
        w = (v - oldeps * w1 - delta * w) / gamma
        x = x + phi * w
        beta = betan
        phibar_h, it = f(phibar.item()), it + 1
        if history:
            norms[it] = phibar_h
    result = CGResult(
        x=x, iters=it, resnorm=float(norm_h(b - a_mv(x), f)),
        reason=int(classify(phibar_h, it)), bnorm=float(bnorm),
    )
    return (result, norms) if history else result

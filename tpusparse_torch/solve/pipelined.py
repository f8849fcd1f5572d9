"""Pipelined preconditioned CG (Ghysels & Vanroose) — port of
``tpusparse/solve/pipelined.py``.

One fused reduction round per iteration: gamma = (r, u), delta = (w, u) and
||r||^2 reduce over vectors available at the same point, and the operator
and preconditioner applies (m = M w, n = A m) do not depend on them.  The
extra recurrences drift; periodic residual replacement every
``replace_every`` iterations re-anchors them, and ``scalar_dtype`` lets an
f32 solve carry its recurrence scalars in f64 (the ``delta -
beta*gamma/alpha`` denominator cancels in f32) — the mixed-precision
configuration the driver picks (``ksp.py::_pick_ksp``).

Scalars stay 0-d device tensors; the one host read per iteration is the
residual norm of the convergence test.
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


def cg_pipelined(
    a_mv: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 10000,
    m_mv: Callable | None = None,
    replace_every: int = 50,
    scalar_dtype: torch.dtype | None = None,
    divtol: float = 1e5,
    history: bool = False,
):
    """Solve A x = b with pipelined PCG.  Same contract as ``cg``;
    ``history=True`` returns ``(result, norms)`` as ``cg`` does.

    ``replace_every``: residual-replacement period (0 disables).
    ``scalar_dtype``: dtype of the recurrence scalars (default b's)."""
    if m_mv is None:
        m_mv = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    dt = b.dtype
    sdt = scalar_dtype or dt
    f = np_float(dt)
    bnorm = norm_h(b, f)
    classify = convergence_test(f, bnorm, rtol, atol, divtol, maxiter)

    r = b - a_mv(x)
    u = m_mv(r)
    w = a_mv(u)
    gamma = _dot(r, u).to(sdt)
    zeros = torch.zeros_like(b)
    z = q = p = s = zeros
    alpha = None
    rnorm, it = norm_h(r, f), 0
    norms = new_history(maxiter, rnorm) if history else None
    reason = classify(rnorm, it)
    while reason == ConvergedReason.ITERATING:
        # the two applies are independent of this iteration's reductions
        m = m_mv(w)
        n = a_mv(m)
        delta = _dot(w, u).to(sdt)
        gamma_new = _dot(r, u).to(sdt)  # gamma = the previous iteration's
        if it == 0:
            beta = torch.zeros((), dtype=sdt, device=b.device)
            alpha = gamma_new / delta
        else:
            beta = gamma_new / gamma
            alpha = gamma_new / (delta - beta * gamma_new / alpha)
        beta_v, alpha_v = beta.to(dt), alpha.to(dt)
        z = n + beta_v * z
        q = m + beta_v * q
        p = u + beta_v * p
        s = w + beta_v * s
        x = x + alpha_v * p
        r = r - alpha_v * s
        u = u - alpha_v * q
        w = w - alpha_v * z
        if replace_every and (it + 1) % replace_every == 0:
            # residual replacement (Ghysels & Vanroose section 4): re-anchor
            # every recurrence-maintained vector on its definition
            r = b - a_mv(x)
            u = m_mv(r)
            w = a_mv(u)
            s = a_mv(p)
            q = m_mv(s)
            z = a_mv(q)
        gamma = gamma_new
        rnorm, it = norm_h(r, f), it + 1
        if history:
            norms[it] = rnorm
        reason = classify(rnorm, it)
    result = CGResult(x=x, iters=it, resnorm=float(rnorm), reason=int(reason), bnorm=float(bnorm))
    return (result, norms) if history else result

"""KSPCHEBYSHEV — Chebyshev semi-iteration as a top-level KSP; port of
``tpusparse/solve/chebyshev.py``.

Dot-free per iteration apart from the convergence norm: one A-apply, one
M-apply and vector updates.  Without given bounds a deterministic power
iteration estimates rho(M A) and PETSc's default transform sets
lo = 0.1 rho, hi = 1.1 rho.  A and M may both be negative definite (the
reference's sign convention): the iteration only sees M A.

The scalar recurrence runs on the host in numpy scalars of b's dtype, the
arithmetic JAX does on 0-d arrays of that dtype.
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
from tpusparse_torch.solve.reduce import global_offset

__all__ = ["chebyshev"]


def chebyshev(
    a_mv: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 10000,
    m_mv: Callable | None = None,
    emin: float | None = None,
    emax: float | None = None,
    est_iters: int = 25,
    divtol: float = 1e5,
    history: bool = False,
):
    """Solve A x = b with the preconditioned Chebyshev iteration.

    ``emin``/``emax``: spectrum bounds of M A; omitted, an ``est_iters``-step
    power iteration estimates them.  Same contract as ``cg`` otherwise;
    ``history=True`` returns ``(result, norms)`` as ``cg`` does.
    """
    if m_mv is None:
        m_mv = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    f = np_float(b.dtype)
    bnorm = norm_h(b, f)
    classify = convergence_test(f, bnorm, rtol, atol, divtol, maxiter)

    if emax is None and emin is not None:
        raise ValueError(
            "emin without emax: the auto-estimate would silently discard"
            " the supplied lower bound — give both bounds or neither"
        )
    if emax is None:
        # rho(M A) by power iteration from the deterministic non-smooth start
        # of estimate_rho_dinv_a, over b's own layout as the JAX code does
        # (global indices when b is a rank's slab)
        off = global_offset()
        idx = torch.arange(off, off + b.numel(), dtype=torch.int64, device=b.device).to(b.dtype)
        v = torch.sin(idx * 0.7 + 0.3).reshape(b.shape)
        v = v / torch.sqrt(_dot(v, v))
        for _ in range(est_iters):
            w = m_mv(a_mv(v))
            v = w / torch.sqrt(_dot(w, w))
        rho = f(_dot(v, m_mv(a_mv(v))).item())  # v normalized
        lo, hi = 0.1 * rho, 1.1 * rho
    else:
        lo = f(emin if emin is not None else 0.1 * emax)
        hi = f(emax)

    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma1 = theta / delta

    r = b - a_mv(x)
    d = None
    rho_k = f(1.0)
    rnorm, it = norm_h(r, f), 0
    norms = new_history(maxiter, rnorm) if history else None
    reason = classify(rnorm, it)
    while reason == ConvergedReason.ITERATING:
        # first step: d = M r / theta; later: the two-term recurrence
        z = m_mv(r)
        if it == 0:
            rho_new = f(1.0 / sigma1)
            d = z / float(theta)
        else:
            rho_new = f(1.0 / (2.0 * sigma1 - rho_k))
            d = float(rho_new * rho_k) * d + float(2.0 * rho_new / delta) * z
        x = x + d
        r = r - a_mv(d)
        rho_k = rho_new
        rnorm, it = norm_h(r, f), it + 1
        if history:
            norms[it] = rnorm
        reason = classify(rnorm, it)
    result = CGResult(x=x, iters=it, resnorm=float(rnorm), reason=int(reason), bnorm=float(bnorm))
    return (result, norms) if history else result

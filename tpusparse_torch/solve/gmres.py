"""Restarted GMRES — KSPGMRES parity; port of ``tpusparse/solve/gmres.py``.

Left-preconditioned (PETSc's default): convergence is gated on the
preconditioned residual norm.  The Krylov basis is one dense
``(restart + 1, n)`` tensor, so each step orthogonalizes with two rounds of
classical Gram-Schmidt as matrix products (CGS2), as the JAX package does.
The Hessenberg column, its Givens rotations and the small triangular solve
are O(restart^2) scalars: they run on the host in numpy scalars of b's
dtype, read once per step together with the residual estimate.

``_cycle`` also serves ``solve/fgmres.py``, whose flexible variant differs
only in which vectors form the update and where the preconditioner sits.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
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
from tpusparse_torch.solve.reduce import allreduce


def _cycle(r, apply, m: int, classify, rn, it: int, f, norms=None):
    """One restart cycle of (F)GMRES from the residual ``r``.

    ``apply(v_j) -> (w, u_j)``: the new Krylov direction and the vector the
    solution update combines (``v_j`` itself for GMRES, ``M^-1 v_j`` for
    FGMRES).  Steps stop once ``classify`` no longer says ITERATING.
    Returns ``(dx, rn, it)``: the update as a flat vector, the last residual
    estimate |g[j+1]| and the iteration count.  ``norms``, a history
    array, receives each step's estimate at its iteration's index.
    """
    dt, n = r.dtype, r.numel()
    beta = norm_h(r, f)
    v = torch.zeros((m + 1, n), dtype=dt, device=r.device)
    v[0] = r.reshape(-1) / float(beta if beta > 0 else f(1.0))
    h = np.zeros((m + 1, m), f)
    cs, sn = np.zeros(m, f), np.zeros(m, f)
    g = np.zeros(m + 1, f)
    g[0] = beta
    us = []
    j = 0
    while j < m and classify(rn, it) == ConvergedReason.ITERATING:
        w, u = apply(v[j])
        us.append(u)
        # CGS2: two rounds of classical Gram-Schmidt as matrix products;
        # unfilled basis rows are zero, so masking is automatic
        c1 = allreduce(v @ w)
        w = w - v.T @ c1
        c2 = allreduce(v @ w)
        w = w - v.T @ c2
        col = torch.cat([c1 + c2, torch.sqrt(_dot(w, w))[None]]).cpu().numpy()
        hj, wnorm = col[: m + 1], col[m + 1]
        hj[j + 1] = wnorm
        v[j + 1] = w / float(wnorm if wnorm > 0 else f(1.0))
        # apply the accumulated Givens rotations to the new column
        for i in range(j):
            a_, b_ = hj[i], hj[i + 1]
            hj[i] = cs[i] * a_ + sn[i] * b_
            hj[i + 1] = -sn[i] * a_ + cs[i] * b_
        denom = np.sqrt(hj[j] ** 2 + hj[j + 1] ** 2)
        c_new = hj[j] / denom if denom > 0 else f(1.0)
        s_new = hj[j + 1] / denom if denom > 0 else f(0.0)
        hj[j] = c_new * hj[j] + s_new * hj[j + 1]
        hj[j + 1] = 0.0
        g_j = g[j]
        g[j], g[j + 1] = c_new * g_j, -s_new * g_j
        cs[j], sn[j] = c_new, s_new
        h[:, j] = hj
        rn = f(abs(g[j + 1]))
        it += 1
        j += 1
        if norms is not None:
            norms[it] = rn

    # back-substitute R y = g on the filled j x j triangle; a column whose
    # rotated diagonal is exactly zero (lucky breakdown) gets a unit
    # diagonal and a zero coefficient, so it cannot enter the update
    diag = np.diagonal(h[:j, :j])
    valid = np.abs(diag) > 0
    hs = np.where(valid[None, :], h[:j, :j], f(0.0)) + np.diag(np.where(valid, 0.0, 1.0).astype(f))
    y = np.zeros(j, f)
    for i in reversed(range(j)):
        y[i] = (g[i] - hs[i, i + 1:] @ y[i + 1:]) / hs[i, i]
    y = np.where(valid, y, f(0.0))
    basis = torch.stack(us) if us else v[:0]
    dx = basis.T @ torch.from_numpy(y).to(device=r.device, dtype=dt)
    return dx, rn, it


def gmres(
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
    """Solve A x = b with left-preconditioned restarted GMRES(restart).
    Same result contract as ``cg``; the gate is ``||M b||``-relative.
    ``history=True`` returns ``(result, norms)`` as ``cg`` does, of the
    preconditioned residual norm."""
    if m_mv is None:
        m_mv = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    shape = b.shape
    f = np_float(b.dtype)
    bnorm = norm_h(m_mv(b), f)
    classify = convergence_test(f, bnorm, rtol, atol, divtol, maxiter)

    def pres(x):
        return m_mv(b - a_mv(x))  # preconditioned residual M (b - A x)

    def apply(vj):
        return m_mv(a_mv(vj.reshape(shape))).reshape(-1), vj

    r = pres(x)
    rnorm, it = norm_h(r, f), 0
    norms = new_history(maxiter, rnorm) if history else None
    while classify(rnorm, it) == ConvergedReason.ITERATING:
        if it:
            r = pres(x)
        dx, rnorm, it = _cycle(r, apply, int(restart), classify, rnorm, it, f, norms)
        x = x + dx.reshape(shape)
    result = CGResult(
        x=x, iters=it, resnorm=float(rnorm), reason=int(classify(rnorm, it)),
        bnorm=float(bnorm),
    )
    return (result, norms) if history else result

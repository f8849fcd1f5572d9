"""Mixed-precision iterative refinement (defect correction) — port of
``tpusparse/solve/refine.py::cg_refined``.

    x = 0                                 (f64)
    repeat:
        r = b - A x                       (f64: ONE operator apply per sweep)
        stop when ||r|| <= max(rtol*||b||, atol)
        e ~= A^{-1} r                     (f32 CG + AMG, adaptive inner rtol)
        x = x + e                         (f64)

All the AMG/CG work runs in f32; each outer sweep multiplies the true
residual by about the inner tolerance.  The inner system is solved for the
normalized residual r / ||r||, so late residuals never leave f32's range.

The JAX package computes ||r|| on the f32 datapath (``_norm_fast``) because
the TPU emulates f64; the H100 has f64 in hardware, so this is a plain f64
norm.  Reported iterations are total inner CG iterations plus the outer
count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from tpusparse_torch.solve.cg import ConvergedReason, cg


@dataclasses.dataclass
class RefinedResult:
    x: torch.Tensor
    iters: int          # total inner CG iterations
    outer_iters: int    # refinement sweeps
    resnorm: float      # true f64 residual 2-norm
    reason: int
    bnorm: float

    def converged(self) -> bool:
        """True for any positive reason — INCLUDING ``CONVERGED_STALLED``."""
        return self.reason > 0


def _norm(r: torch.Tensor) -> float:
    return torch.linalg.vector_norm(r).item()


def cg_refined(
    a_hi_mv: Callable,
    a_lo_mv: Callable,
    b: torch.Tensor,
    *,
    rtol: float = 1e-14,
    atol: float = 1e-12,
    max_outer: int = 12,
    inner_rtol: float = 1e-5,
    inner_maxiter: int = 200,
    m_lo_mv: Callable | None = None,
    m_lo_mv_dots: Callable | None = None,
    a_lo_mv_dot: Callable | None = None,
    ab_fused: Callable | None = None,
    m_fused: Callable | None = None,
    lo_dtype: torch.dtype = torch.float32,
    encode: Callable | None = None,
    decode: Callable | None = None,
    solver: Callable = cg,
    history: bool = False,
    divtol: float = 1e5,
):
    """Solve A x = b to high-precision tolerances with low-precision inners.

    ``a_hi_mv`` applies A in b's (high) dtype; ``a_lo_mv``/``m_lo_mv`` (or
    the fused ``a_lo_mv_dot``/``m_lo_mv_dots``, CG only) apply the operator
    and the preconditioner in ``lo_dtype``.  The full-fusion pair
    ``ab_fused``/``m_fused`` (CG only, ``cg``'s arguments of those names)
    overrides ``m_lo_mv_dots`` and suppresses ``a_lo_mv_dot``, as in the
    JAX package.  ``encode``/``decode`` translate
    between the outer layout and the inner solver's (the padded-resident
    layout).  ``solver`` is the inner Krylov method (``cg``'s interface).
    An inner solve that stops at ``inner_maxiter`` is not an error: its
    reason is ignored and only its iterations count.

    ``history=True`` returns ``(result, norms)`` with the true residual
    norm of each outer sweep as f32 values, index 0 = ||b|| (the monitor
    data of mixed precision, one entry per defect-correction sweep).
    """
    dt = b.dtype
    bnorm = _norm(b)
    tol = max(rtol * bnorm, atol)
    dgate = divtol * bnorm if divtol and divtol > 0 else math.inf
    fused = {}
    if ab_fused is not None and m_fused is not None:
        fused.update(ab_fused=ab_fused, m_fused=m_fused)
    elif m_lo_mv_dots is not None:
        fused["m_mv_dots"] = m_lo_mv_dots
    if a_lo_mv_dot is not None and ab_fused is None:
        fused["a_mv_dot"] = a_lo_mv_dot

    def inner(r_hi, rnorm):
        r_lo = (r_hi / rnorm).to(lo_dtype)
        if encode is not None:
            r_lo = encode(r_lo)
        # adaptive inner tolerance: reduce only as far as the OUTER gate
        # still needs (x0.25 safety), floored at what f32 reliably delivers
        need = float(np.float32(min(max(0.25 * tol / rnorm, inner_rtol), 0.5)))
        res = solver(
            a_lo_mv, r_lo, rtol=need, maxiter=inner_maxiter, m_mv=m_lo_mv,
            **fused,
        )
        e = decode(res.x) if decode is not None else res.x
        return e.to(dt) * rnorm, res.iters

    def classify(rnorm, prev, outer):
        # stall = a full sweep failed to halve the true residual: the
        # attainable f64 floor (~eps * ||A|| ||x|| / ||b||) has been reached
        if not math.isfinite(rnorm):
            return ConvergedReason.DIVERGED_NANORINF
        if rnorm <= atol:
            return ConvergedReason.CONVERGED_ATOL
        if rnorm <= tol:
            return ConvergedReason.CONVERGED_RTOL
        if rnorm >= dgate:  # a blow-up outranks the stall
            return ConvergedReason.DIVERGED_DTOL
        if outer >= 2 and rnorm > 0.5 * prev:
            return ConvergedReason.CONVERGED_STALLED
        if outer >= max_outer:
            return ConvergedReason.DIVERGED_ITS
        return ConvergedReason.ITERATING

    x = torch.zeros_like(b)
    r = b  # x0 = 0
    rnorm, prev, outer, total = _norm(r), math.inf, 0, 0
    norms = [float(np.float32(rnorm))]
    reason = classify(rnorm, prev, outer)
    while reason == ConvergedReason.ITERATING:
        e, its = inner(r, rnorm)
        x = x + e
        r = b - a_hi_mv(x)  # the one high-precision apply per outer sweep
        prev, rnorm = rnorm, _norm(r)
        norms.append(float(np.float32(rnorm)))
        outer += 1
        total += its
        reason = classify(rnorm, prev, outer)
    result = RefinedResult(
        x=x, iters=total, outer_iters=outer, resnorm=rnorm,
        reason=int(reason), bnorm=bnorm,
    )
    return (result, norms) if history else result

"""Block (multi-right-hand-side) solves — port of
``tpusparse/solve/multi.py``, PETSc ``KSPMatSolve`` parity.

Solving k systems one at a time re-streams the operator for every vector;
a batched apply over the (k, ...) stack streams its coefficients once for
all k columns (``StarStencil3D.mv`` on a stack: one ``star7_mv_batched``
launch), and the per-column scalar recurrences become (k,)-vector ops.

The iteration is per-column MASKED independent CG, not a shared-Krylov
"block CG": each column takes the iterations the single-RHS solver would,
and converged columns are frozen (alpha = 0 and a denominator of 1, their
counters stopped) while the rest finish.  The column classification runs
on the device, as the JAX package's ``jnp.where`` chain; the loop's
condition is one host read an iteration (does any column iterate?), as in
the port's ``cg``.

``cg_multi`` is the uniform-precision block solver; ``refined_multi`` the
block form of mixed-precision defect correction (``solve/refine.py``) with
per-column outer gates, stall detection and adaptive inner tolerances.
``rtol``/``atol`` may be scalars or per-column (k,) sequences throughout.
The outer norms are plain f64 per-column norms (the JAX package's
``_norm_fast`` exists because the TPU emulates f64).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from tpusparse_torch.solve.cg import ConvergedReason

__all__ = ["MultiResult", "cg_multi", "refined_multi"]

_ITERATING = int(ConvergedReason.ITERATING)


@dataclasses.dataclass
class MultiResult:
    """Per-column results: every field's leading axis is the k columns."""

    x: torch.Tensor            # (k, ...) solutions
    iters: torch.Tensor        # (k,) int32 — per-column (inner) iterations
    outer_iters: torch.Tensor  # (k,) int32 — refinement sweeps (0 for cg_multi)
    resnorm: torch.Tensor      # (k,) final residual 2-norms
    reason: torch.Tensor       # (k,) int32 ConvergedReason values
    bnorm: torch.Tensor        # (k,)

    def all_converged(self) -> bool:
        return bool(torch.all(self.reason > 0))


def _bdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-column dot: reduce every axis but the leading k."""
    k = u.shape[0]
    return torch.sum(u.reshape(k, -1) * v.reshape(k, -1), dim=1)


def _bc(m: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Broadcast a (k,) column mask/scalar onto ref's (k, ...) shape."""
    return m.reshape(m.shape + (1,) * (ref.dim() - 1))


def _col(v, dt, b) -> torch.Tensor:
    """A scalar or per-column value as a (k,) tensor of dtype ``dt``."""
    return torch.as_tensor(v, dtype=dt, device=b.device).expand(b.shape[0]).clone()


def _reasons(*branches) -> torch.Tensor:
    """The first true branch's reason per column, ITERATING where none is
    (the nested ``jnp.where`` chain of the JAX package, outermost first)."""
    out = torch.full(branches[0][0].shape, _ITERATING, dtype=torch.int32, device=branches[0][0].device)
    for cond, reason in reversed(branches):
        out = torch.where(cond, torch.tensor(int(reason), dtype=torch.int32, device=out.device), out)
    return out


def _stack_map(fn: Callable) -> Callable:
    """A single-column callable applied to each column of a stack, for
    callers with no batched form (``batched_ops=False``)."""
    return lambda xs: torch.stack([fn(x) for x in xs])


def cg_multi(
    a_mv: Callable,
    b: torch.Tensor,
    *,
    rtol=1e-5,
    atol=1e-50,
    maxiter: int = 10000,
    m_mv: Callable | None = None,
    batched_ops: bool = False,
    divtol: float = 1e5,
) -> MultiResult:
    """Masked block CG: solve A x_i = b_i for every column b = B[i].

    ``a_mv``/``m_mv`` apply to ONE column (looped over the stack here);
    pass ``batched_ops=True`` when they take the (k, ...) stack, as
    ``KSP.mat_solve`` always does.  Convergence per column: ||r_i|| <=
    max(rtol_i*||b_i||, atol_i), the single-RHS solver's
    KSPConvergedDefault semantics, with its divtol branch.
    """
    mv = a_mv if batched_ops else _stack_map(a_mv)
    if m_mv is None:
        pc = lambda r: r  # noqa: E731
    else:
        pc = m_mv if batched_ops else _stack_map(m_mv)

    dt = b.dtype
    bnorm = torch.sqrt(_bdot(b, b))
    atol_a = _col(atol, dt, b)
    tol = torch.maximum(_col(rtol, dt, b) * bnorm, atol_a)
    dgate = (
        _col(divtol, dt, b) * bnorm if divtol and divtol > 0
        else torch.full_like(bnorm, float("inf"))
    )

    def classify(rnorm, it):
        return _reasons(
            (~torch.isfinite(rnorm), ConvergedReason.DIVERGED_NANORINF),
            (rnorm <= atol_a, ConvergedReason.CONVERGED_ATOL),
            (rnorm <= tol, ConvergedReason.CONVERGED_RTOL),
            (rnorm >= dgate, ConvergedReason.DIVERGED_DTOL),
            (it >= maxiter, ConvergedReason.DIVERGED_ITS),
        )

    r = b  # x0 = 0 (the reference zeroes the guess, helper.cpp:48)
    z = pc(r)
    rz = _bdot(r, z)
    rnorm = torch.sqrt(_bdot(r, r))
    x, p = torch.zeros_like(b), z
    it = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    one = torch.ones((), dtype=dt, device=b.device)
    zero = torch.zeros((), dtype=dt, device=b.device)
    act = classify(rnorm, it) == _ITERATING
    while bool(act.any()):  # the one host read per iteration
        ap = mv(p)
        pap = _bdot(p, ap)
        # frozen columns get alpha = 0 (state provably unchanged) and a
        # non-zero denominator (their true pap may underflow to 0/0)
        alpha = torch.where(act, rz / torch.where(act, pap, one), zero)
        x = x + _bc(alpha, x) * p
        r = r - _bc(alpha, r) * ap
        z_new = pc(r)
        rz_new = _bdot(r, z_new)
        beta = torch.where(act, rz_new / torch.where(act, rz, one), zero)
        actn = _bc(act, p)
        p = torch.where(actn, z_new + _bc(beta, p) * p, p)
        z = torch.where(actn, z_new, z)
        rz = torch.where(act, rz_new, rz)
        rnorm = torch.where(act, torch.sqrt(_bdot(r, r)), rnorm)
        it = it + act.to(torch.int32)
        act = classify(rnorm, it) == _ITERATING
    return MultiResult(
        x=x, iters=it, outer_iters=torch.zeros_like(it), resnorm=rnorm,
        reason=classify(rnorm, it), bnorm=bnorm,
    )


def _norms(v: torch.Tensor) -> torch.Tensor:
    """Per-column 2-norms of a (k, ...) stack."""
    return torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=1)


def refined_multi(
    a_hi_mv: Callable,
    a_lo_mv: Callable,
    b: torch.Tensor,
    *,
    rtol=1e-14,
    atol=1e-12,
    max_outer: int = 12,
    inner_rtol: float = 1e-5,
    inner_maxiter: int = 200,
    m_lo_mv: Callable | None = None,
    lo_dtype: torch.dtype = torch.float32,
    encode: Callable | None = None,
    decode: Callable | None = None,
    batched_ops: bool = False,
    divtol: float = 1e5,
) -> MultiResult:
    """Block mixed-precision defect correction (``cg_refined`` per column,
    masked): f32 block-CG inners under per-column f64 outer gates, with the
    single-RHS path's adaptive inner tolerance and stall detection.

    ``encode``/``decode`` translate single-column fields between the outer
    layout and the inner solver's layout; apply functions are single-column
    unless ``batched_ops``.
    """
    mv_hi = a_hi_mv if batched_ops else _stack_map(a_hi_mv)
    enc = None if encode is None else (encode if batched_ops else _stack_map(encode))
    dec = None if decode is None else (decode if batched_ops else _stack_map(decode))

    dt = b.dtype
    k = b.shape[0]
    bnorm = _norms(b)
    atol_a = _col(atol, dt, b)
    tol = torch.maximum(_col(rtol, dt, b) * bnorm, atol_a)
    dgate = (
        _col(divtol, dt, b) * bnorm if divtol and divtol > 0
        else torch.full_like(bnorm, float("inf"))
    )

    def classify(rnorm, prev, outer):
        return _reasons(
            (~torch.isfinite(rnorm), ConvergedReason.DIVERGED_NANORINF),
            (rnorm <= atol_a, ConvergedReason.CONVERGED_ATOL),
            (rnorm <= tol, ConvergedReason.CONVERGED_RTOL),
            # a genuine blow-up must NOT be mislabeled as the attainable-
            # accuracy stall: dtol outranks it (same ordering as cg_refined)
            (rnorm >= dgate, ConvergedReason.DIVERGED_DTOL),
            ((outer >= 2) & (rnorm > 0.5 * prev), ConvergedReason.CONVERGED_STALLED),
            (outer >= max_outer, ConvergedReason.DIVERGED_ITS),
        )

    x, r, rnorm = torch.zeros_like(b), b, bnorm
    prev = torch.full((k,), float("inf"), dtype=dt, device=b.device)
    outer = torch.zeros(k, dtype=torch.int32, device=b.device)
    tot = torch.zeros_like(outer)
    act = classify(rnorm, prev, outer) == _ITERATING
    while bool(act.any()):  # one host read an outer sweep
        r_lo = (r / _bc(rnorm, r)).to(lo_dtype)
        if enc is not None:
            r_lo = enc(r_lo)
        # adaptive per-column inner tolerance (solve/refine.py rule);
        # frozen columns solve to the loosest gate so they cost ~nothing
        need = torch.clamp(0.25 * tol / rnorm, inner_rtol, 0.5)
        need = torch.where(act, need, torch.full_like(need, 0.5)).to(torch.float32)
        res = cg_multi(
            a_lo_mv, r_lo, rtol=need, maxiter=inner_maxiter, m_mv=m_lo_mv,
            batched_ops=batched_ops,
        )
        e = dec(res.x) if dec is not None else res.x
        e = e.to(dt) * _bc(rnorm, e)
        x = torch.where(_bc(act, x), x + e, x)
        r = torch.where(_bc(act, r), b - mv_hi(x), r)  # one high-precision block apply
        prev = torch.where(act, rnorm, prev)
        rnorm = torch.where(act, _norms(r), rnorm)
        outer = outer + act.to(torch.int32)
        tot = tot + torch.where(act, res.iters, torch.zeros_like(res.iters))
        act = classify(rnorm, prev, outer) == _ITERATING
    return MultiResult(
        x=x, iters=tot, outer_iters=outer, resnorm=rnorm,
        reason=classify(rnorm, prev, outer), bnorm=bnorm,
    )

"""Preconditioned conjugate gradients — port of ``tpusparse/solve/cg.py``.

Parity target: KSPCG with KSPConvergedDefault on the unpreconditioned
residual (``src/main_ksp.cpp:92-117``), checked every iteration, with a
converged-reason API that distinguishes rtol/atol convergence from
iteration-limit, divergence-tolerance and NaN failure.

The JAX package runs the loop as one ``lax.while_loop``; here it is a
Python loop over device tensors that reads one scalar (the residual norm)
to the host per convergence test, once every ``check_every`` iterations.  The scalar algebra of
the test is done in numpy scalars of ``b``'s dtype, as JAX does it on 0-d
arrays.  The operator and preconditioner come in as callables, including
the fused forms ``a_mv_dot`` (``PaddedStar.mv_dot``) and ``m_mv_dots``
(``amg.fused_cycle.vcycle_fused_dots``), and the full-fusion pair
``ab_fused`` (``PaddedStar.cgmv``) and ``m_fused``
(``amg.fused_cycle.vcycle_fused_rupdate``).

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

from tpusparse_torch.kernels.cgupdate import cg_update_r, cg_update_xp
from tpusparse_torch.solve.reduce import allreduce
from tpusparse_torch.utils.profiling import read


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
    """Flattened dot as a 0-d device tensor, summed over the ranks of a
    split solve (``solve/reduce.py``)."""
    return allreduce(torch.dot(a.reshape(-1), b.reshape(-1)))


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


def new_history(maxiter: int, first):
    """The ``history=True`` record of a Krylov method: a ``(maxiter + 1,)``
    f32 array, index 0 the initial norm, zeros past the last iteration (the
    JAX package's array)."""
    norms = np.zeros(maxiter + 1, np.float32)
    norms[0] = first
    return norms


def norm_h(v: torch.Tensor, f):
    """||v||_2 read to the host as a numpy scalar of type ``f``."""
    return f(read(torch.sqrt(_dot(v, v))))


def _check_args(*, fused, x0, state0, return_state, history, spectrum, a_mv_dot, m_mv_dots,
                check_every=1):
    """JAX's incompatibility rules between ``cg``'s arguments
    (``tpusparse/solve/cg.py:172-205``)."""
    if history and state0 is not None:
        raise ValueError("history=True is incompatible with state0 resume")
    if history and return_state:
        raise ValueError(
            "history=True is incompatible with return_state=True (the state"
            " tuple would be returned where the caller expects the history)"
        )
    if spectrum and (history or return_state or state0 is not None):
        raise ValueError(
            "spectrum=True is incompatible with history/return_state/state0"
            " (each changes what the extra return slot carries)"
        )
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if fused and (
        x0 is not None or state0 is not None or return_state or history or spectrum
        or a_mv_dot is not None or m_mv_dots is not None
    ):
        raise ValueError(
            "the full-fusion CG body needs a zero initial guess and is"
            " incompatible with state0/return_state/history/spectrum/"
            "a_mv_dot/m_mv_dots"
        )
    if check_every > 1 and (history or spectrum):
        raise ValueError(
            "check_every > 1 is incompatible with history/spectrum (the"
            " per-iteration trace arrays are sized by maxiter, which an"
            " unchecked sub-iteration may overrun)"
        )


def cg(
    a_mv: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 10000,
    m_mv: Callable | None = None,
    state0: tuple | None = None,
    return_state: bool = False,
    history: bool = False,
    a_mv_dot: Callable | None = None,
    m_mv_dots: Callable | None = None,
    check_every: int = 1,
    spectrum: bool = False,
    ab_fused: Callable | None = None,
    m_fused: Callable | None = None,
    divtol: float = 1e5,
    norm_type: str = "unpreconditioned",
):
    """Solve A x = b with (preconditioned) CG.

    Convergence: ||r||_2 <= max(rtol*||b||_2, atol), checked every
    ``check_every`` iterations; ||r||_2 >= divtol*||b||_2 reports DIVERGED_DTOL (divtol <= 0
    disables it).  ``a_mv_dot(p) -> (A p, <p, A p>)`` replaces the apply and
    the alpha-denominator dot; ``m_mv_dots(r) -> (z, <r, z>, <r, r>)``
    replaces the preconditioner and both residual reductions (and overrides
    ``m_mv``).

    ``ab_fused(z, p, x, alpha_prev, beta) -> (A p', p', x', <p', A p'>)``
    and ``m_fused(r, ap, alpha) -> (z, r', <r', z>, <r', r'>)``, given
    together, switch the loop to the full-fusion body: the p update, the x
    and r updates, the operator, the preconditioner and the three dots ride
    inside the two callables.  The x update is deferred one iteration (x
    lacks alpha_k p_k until the next trip; the exit adds the last term),
    which changes no residual the convergence test sees.  It needs a zero
    initial guess and takes neither ``a_mv_dot`` nor ``m_mv_dots``.

    The vector updates are two launches an iteration on the card
    (``kernels/cgupdate.py``): r' = r - alpha A p before the
    preconditioner, which reads it, and x' = x + alpha p with p' = z + beta
    p after it.  x is updated later within the iteration than the textbook
    order, which changes no value: nothing reads x between the two points.

    ``norm_type`` (-ksp_norm_type): "unpreconditioned" (||r||_2, the
    default), "preconditioned" (||r||_M = sqrt(|<r, z>|), PETSc CG's own
    default, still gated against ``rtol * ||b||_2``), or "none" (no
    residual test: run ``maxiter`` iterations and report CONVERGED_ITS, or
    DIVERGED_NANORINF on a non-finite norm; PETSc KSP_NORM_NONE).  As in the
    JAX package, the full-fusion body keeps ||r||_2 under "preconditioned".

    ``check_every`` runs that many iterations between convergence tests,
    in either body (PETSc tests every iteration, the default 1), so the
    host reads the residual norm once a block.  The solve may then run up
    to ``check_every - 1`` iterations past the tolerance (extra CG
    iterations only lower the residual) and past ``maxiter`` by as many.
    It takes neither ``history`` nor ``spectrum``.

    Extra results, as in the JAX package (one at a time):

    - ``history=True`` returns ``(result, norms)``: a ``(maxiter + 1,)``
      f32 numpy array of the residual norm of each iteration (index 0 the
      initial one, zeros past ``result.iters``), the ``-ksp_monitor`` data,
      recorded from the norm the loop reads anyway.
    - ``spectrum=True`` returns ``(result, (alphas, betas))``: two
      ``(maxiter,)`` f64 numpy arrays of the iteration's scalars, the
      Lanczos data of ``solve/spectrum.py``.  They stay on the device
      until the solve ends and come over in one transfer.
    - ``return_state=True`` returns ``(result, state)``, the Krylov state
      ``(x, r, z, p, <r, z>, ||r||, it)``; passed back as ``state0`` it
      resumes the iteration exactly (``x0`` is then ignored).  The state's
      counter goes on from where it stopped: a resumed call runs until
      ``it`` reaches ``maxiter``.
    """
    fused = ab_fused is not None
    if fused != (m_fused is not None):
        raise ValueError("ab_fused and m_fused must be given together")
    if norm_type not in ("unpreconditioned", "preconditioned", "none"):
        raise ValueError(f"unknown norm_type {norm_type!r}")
    _check_args(
        fused=fused, x0=x0, state0=state0, return_state=return_state, history=history,
        spectrum=spectrum, a_mv_dot=a_mv_dot, m_mv_dots=m_mv_dots, check_every=check_every,
    )
    if m_mv is None:
        m_mv = lambda r: r  # noqa: E731
    if x0 is None:
        x0 = torch.zeros_like(b)  # the reference zeroes the initial guess

    f = np_float(b.dtype)
    bnorm = norm_h(b, f)
    if norm_type == "none":
        def classify(rnorm, it):
            if not math.isfinite(rnorm):
                return ConvergedReason.DIVERGED_NANORINF
            return ConvergedReason.CONVERGED_ITS if it >= maxiter else ConvergedReason.ITERATING
    else:
        classify = convergence_test(f, bnorm, rtol, atol, divtol, maxiter)
    precond_norm = norm_type == "preconditioned"
    if fused:
        return _cg_fused(ab_fused, m_fused, b, x0, f, bnorm, classify, check_every)

    if state0 is None:
        x = x0
        r = b - a_mv(x0)
        if m_mv_dots is not None:
            z, rz, rr = m_mv_dots(r)
            rnorm = torch.sqrt(rr)
        else:
            z = m_mv(r)
            rz = _dot(r, z)
            rnorm = torch.sqrt(_dot(r, r))
        if precond_norm:
            rnorm = torch.sqrt(torch.abs(rz))
        p, it = z, 0
    else:
        x, r, z, p, rz, rnorm, it = state0
    rnorm_h = f(read(rnorm))
    reason = classify(rnorm_h, it)
    norms = new_history(maxiter, rnorm_h) if history else None
    scalars = [] if spectrum else None
    while reason == ConvergedReason.ITERATING:
        for _ in range(check_every):
            if a_mv_dot is not None:
                ap, pap = a_mv_dot(p)
                alpha = rz / pap.to(rz.dtype)
            else:
                ap = a_mv(p)
                alpha = rz / _dot(p, ap)
            r = cg_update_r(r, ap, alpha)
            if m_mv_dots is not None:
                z, rz_new, rr = m_mv_dots(r)
                rnorm = torch.sqrt(rr)
            else:
                z = m_mv(r)
                rz_new = _dot(r, z)
                rnorm = torch.sqrt(_dot(r, r))
            if precond_norm:
                rnorm = torch.sqrt(torch.abs(rz_new))
            beta = rz_new / rz
            x, p = cg_update_xp(x, p, z, alpha, beta)
            rz = rz_new
            it += 1
            if spectrum:
                scalars.append(torch.stack([alpha, beta]).to(torch.float64))
        rnorm_h = f(read(rnorm))  # the one host read per convergence test
        if history:
            norms[it] = rnorm_h
        reason = classify(rnorm_h, it)
    result = CGResult(
        x=x, iters=it, resnorm=float(rnorm_h), reason=int(reason),
        bnorm=float(bnorm),
    )
    if return_state:
        return result, (x, r, z, p, rz, rnorm, it)
    if history:
        return result, norms
    if spectrum:
        ab = np.zeros((2, maxiter), np.float64)
        if scalars:
            ab[:, :len(scalars)] = torch.stack(scalars).T.cpu().numpy()  # one transfer
        return result, (ab[0], ab[1])
    return result


def _cg_fused(ab_fused, m_fused, b, x, f, bnorm, classify, check_every) -> CGResult:
    """The full-fusion body of ``cg`` from the zero guess ``x``: the state
    carries (alpha_prev, beta), so the next trip's ``ab_fused`` retires the
    deferred x update and forms p = z + beta p; ``check_every`` trips run
    between convergence tests."""
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    z, r, rz, rr = m_fused(b, b, zero)  # r0 = b - 0 * b = b
    p, alpha_prev, beta = z, zero, zero
    it = 0
    rnorm_h = f(read(torch.sqrt(rr)))
    reason = classify(rnorm_h, it)
    while reason == ConvergedReason.ITERATING:
        for _ in range(check_every):
            ap, p, x, pap = ab_fused(z, p, x, alpha_prev, beta)
            alpha = rz / pap.to(rz.dtype)
            z, r, rz_new, rr = m_fused(r, ap, alpha)
            beta = rz_new / rz
            rz, alpha_prev = rz_new, alpha
            it += 1
        rnorm_h = f(read(torch.sqrt(rr)))  # the one host read per convergence test
        reason = classify(rnorm_h, it)
    # retire the last deferred x update; a zero-trip exit adds 0 * z0
    x = x + alpha_prev * p
    return CGResult(
        x=x, iters=it, resnorm=float(rnorm_h), reason=int(reason),
        bnorm=float(bnorm),
    )

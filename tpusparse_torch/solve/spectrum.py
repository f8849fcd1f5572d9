"""Iteratively computed eigenvalues — PETSc ``-ksp_compute_eigenvalues``;
port of ``tpusparse/solve/spectrum.py``.

For CG the iteration scalars ``alpha_k``/``beta_k`` are a Lanczos process:
the tridiagonal

    T[j, j]   = 1/alpha_j + beta_{j-1}/alpha_{j-1}   (beta_{-1} = 0)
    T[j, j+1] = sqrt(beta_j) / alpha_j

has Ritz values that converge to eigenvalues of M A, extreme ones first,
so ``kappa(M A) = lmax / lmin`` comes from the production solve itself.
``cg(spectrum=True)`` returns the scalars; the tridiagonal eigensolve is
host numpy/scipy on a few tens of values.

Lanczos without reorthogonalization duplicates converged extreme
eigenvalues ("ghosts"), as PETSc's KSPComputeEigenvalues does from the
same scalars: near-duplicates are copies of one eigenvalue.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ritz_values", "eigenvalue_block"]


def ritz_values(alphas, betas, iters: int) -> np.ndarray:
    """Ritz values of M A from ``iters`` CG steps' scalars, ascending.

    Assumes a definite CG pair (A and M both positive or both negative
    definite), so every alpha and beta is positive; raises on non-finite or
    negative scalars among the first ``iters``.
    """
    import scipy.linalg as sla

    k = int(iters)
    if k < 1:
        return np.zeros((0,))
    a = np.asarray(alphas, dtype=np.float64)[:k]
    b = np.asarray(betas, dtype=np.float64)[: max(k - 1, 0)]
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise ValueError("non-finite CG scalars: cannot form the Lanczos T")
    if (a <= 0).any() or (b < 0).any():
        raise ValueError(
            "negative CG scalars (indefinite operator/preconditioner pair):"
            " the CG-Lanczos identity does not apply"
        )
    diag = 1.0 / a
    diag[1:] += b[: k - 1] / a[: k - 1]
    off = np.sqrt(b[: k - 1]) / a[: k - 1]
    if k == 1:
        return diag.copy()
    return sla.eigvalsh_tridiagonal(diag, off)


def eigenvalue_block(ritz: np.ndarray) -> str:
    """PETSc's ``-ksp_compute_eigenvalues`` output: an 'Iteratively computed
    eigenvalues' header, one '%g + %gi' line a value (the imaginary parts
    are zero for CG), and the condition estimate they imply."""
    lines = [f"Iteratively computed eigenvalues: {ritz.size}"]
    lines += [f"{v:g} + 0i" for v in ritz]
    if ritz.size >= 2 and ritz[0] > 0:
        lines.append(
            f"Condition estimate kappa(MA) ~= {ritz[-1] / ritz[0]:.4g} "
            f"(lmin {ritz[0]:.4g}, lmax {ritz[-1]:.4g})"
        )
    return "\n".join(lines)

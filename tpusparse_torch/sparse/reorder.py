"""Bandwidth-reducing reordering — port of ``tpusparse/sparse/reorder.py``:
the bridge from a CSR matrix of any sparsity pattern to the banded
executors.

Reverse Cuthill-McKee (``rcm_permutation``, on the port's own C++ engine,
``native.py``) bounds the graph bandwidth of a scattered matrix; after it
a matrix of at most 192 occupied diagonals goes to the DIA family, and a
wider one to the padded ELL (``sparse/ell.py``).  ``KSP`` carries the
permutation: it solves P A P^T (P x) = P b and unpermutes x on the way
out.  The similarity transform keeps the spectrum, but greedy
aggregation follows the order, so GAMG's counts may differ from the
natural order's (the JAX package's record: 49 against 35 at 100^3).

``occupied_offsets`` and ``distinct_diagonals`` tell whether a host
matrix fits the DIA family, and the general-matrix GAMG router reads
them.
"""

from __future__ import annotations

import numpy as np

from tpusparse_torch import native
from tpusparse_torch.sparse.csr import HostCSR


def occupied_offsets(a: HostCSR) -> np.ndarray:
    """The occupied diagonals (column - row of the stored entries), sorted."""
    if a.nnz == 0:
        return np.zeros(0, np.int64)
    rows = np.repeat(np.arange(a.n_rows, dtype=np.int64), np.diff(a.indptr))
    off = a.indices.astype(np.int64) - rows
    omin = int(off.min())
    span = int(off.max()) - omin + 1
    if span <= max(4 * off.size, 1 << 24):
        # a banded matrix: one bincount pass, not np.unique's sort (tens of
        # seconds over the 188.6M entries of the 300^3 Poisson matrix)
        return np.flatnonzero(np.bincount(off - omin, minlength=span)) + omin
    return np.unique(off)


def distinct_diagonals(a: HostCSR) -> int:
    """Number of occupied diagonals (the DIA storage axis)."""
    return int(occupied_offsets(a).size)


def bandwidth(a: HostCSR) -> int:
    """max |col - row| over the stored entries (0 for a diagonal or empty
    matrix)."""
    if a.nnz == 0:
        return 0
    rows = np.repeat(np.arange(a.n_rows, dtype=np.int64), np.diff(a.indptr))
    return int(np.abs(a.indices.astype(np.int64) - rows).max())


def rcm_permutation(a: HostCSR) -> np.ndarray:
    """The RCM order of A's graph: ``perm[new] = old`` (int64[n]).  A
    pattern that is not structurally symmetric is symmetrized first (RCM
    walks an undirected graph).  Raises when the engine cannot be built:
    there is no fallback, since scipy's order differs from JAX's."""
    if not _pattern_symmetric(a):
        a = _symmetrize_pattern(a)
    return native.rcm(a)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    return inv


def permute_csr(a: HostCSR, perm: np.ndarray) -> HostCSR:
    """B = P A P^T with P the permutation matrix of ``perm`` (perm[new] =
    old): ``B[i, j] = A[perm[i], perm[j]]``, the similarity transform that
    keeps symmetry and the spectrum."""
    s = a.to_scipy()[perm][:, perm].tocsr()
    s.sort_indices()
    return HostCSR.from_scipy(s)


def _pattern_symmetric(a: HostCSR) -> bool:
    s = a.to_scipy()
    s2 = s.copy()
    s2.data = np.ones_like(s2.data)
    d = (s2 - s2.T).tocsr()
    d.eliminate_zeros()
    return d.nnz == 0


def _symmetrize_pattern(a: HostCSR) -> HostCSR:
    s = a.to_scipy()
    p = s.copy()
    p.data = np.ones_like(p.data)
    sym = (p + p.T).tocsr()
    sym.sort_indices()
    return HostCSR.from_scipy(sym)

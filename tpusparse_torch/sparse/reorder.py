"""The occupied diagonals of a host matrix — the part of
``tpusparse/sparse/reorder.py`` that ``KSP.set_operators`` needs to tell
whether a host matrix fits the DIA family in its natural ordering, and
that the general-matrix GAMG router reads.

Reverse Cuthill-McKee (``rcm_permutation``, ``permute_csr``) and the
banded-ELL executor it feeds are ROADMAP queue 1, item 10.
"""

from __future__ import annotations

import numpy as np

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

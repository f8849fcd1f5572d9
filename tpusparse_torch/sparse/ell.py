"""Padded-ELL sparse matrix — port of ``tpusparse/sparse/ell.py``.

Every row is padded to one width, so an apply is ``width`` gathers of full
rows, a product and a sum over the width axis, with no ragged loops.
Padded slots hold ``col = 0, val = 0``: the gather stays in bounds and the
slot adds nothing.  The arrays are width-major, ``(width, n_rows)``, the
JAX package's layout.

The general-matrix path uses ELL for the thin gather remainder of a
``HybridDIA`` level and for the explicit transfers of ``ELLTransfer``.  In
the JAX package its apply is XLA glue, not a Pallas kernel, so here it is
plain torch.

``rmv`` (x = A^T y) sums without float atomics: at construction a
transpose table ``tmap`` (n_cols, max column count) lists, for each
column, the flat slots of its stored entries in ascending order, its pad
slots pointing at an appended zero.  The apply is one gather and one sum
in that fixed order, so it gives the same bits on every run (an
``index_add_`` on CUDA would not).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusparse_torch.sparse.csr import HostCSR


def _transpose_map(cols: torch.Tensor, vals: torch.Tensor, n_cols: int) -> torch.Tensor:
    """(n_cols, m) int64: row c lists the flat slots (into ``vals.reshape(-1)``)
    of the stored entries of column c in ascending order, padded with
    ``vals.numel()``, the slot of an appended zero."""
    flat = cols.reshape(-1)
    slots = torch.nonzero(vals.reshape(-1) != 0).reshape(-1)
    c = flat[slots]
    order = torch.argsort(c, stable=True)
    c, slots = c[order], slots[order]
    counts = torch.bincount(c, minlength=n_cols)
    width = int(counts.max()) if counts.numel() and c.numel() else 1
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(c.numel(), device=c.device) - start[c]
    tmap = torch.full((n_cols, max(width, 1)), vals.numel(), dtype=torch.int64, device=c.device)
    tmap[c, rank] = slots
    return tmap


@dataclasses.dataclass
class ELL:
    """Padded-ELL matrix: ``cols``/``vals`` of shape (width, n_rows)."""

    cols: torch.Tensor               # (width, n_rows) int64; padded entries 0
    vals: torch.Tensor               # (width, n_rows) float; padded entries 0
    shape: tuple[int, int]
    tmap: torch.Tensor | None = None  # transpose table (``_transpose_map``)

    def __post_init__(self):
        if self.tmap is None:
            self.tmap = _transpose_map(self.cols, self.vals, self.shape[1])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def width(self) -> int:
        return self.cols.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def nnz(self) -> int:
        """Count of stored (non-padding) entries."""
        return int(torch.count_nonzero(self.vals))

    @classmethod
    def from_csr(cls, csr, width: int | None = None, dtype=None, *, device) -> "ELL":
        """Convert a HostCSR (or scipy CSR) matrix; ``width`` defaults to
        the longest row.  ``dtype`` is a numpy dtype (default the
        matrix's)."""
        if not isinstance(csr, HostCSR):
            csr = HostCSR.from_scipy(csr)
        row_nnz = csr.row_nnz()
        longest = int(row_nnz.max(initial=0))
        w = max(int(width) if width is not None else longest, 1)
        if longest > w:
            raise ValueError(f"width {w} < max row nnz {longest}")
        # entry e of row r lives at csr.indptr[r] + e; stored width-major
        pos = csr.indptr[None, :-1] + np.arange(w, dtype=np.int64)[:, None]
        mask = np.arange(w, dtype=np.int64)[:, None] < row_nnz[None, :]
        pos = np.where(mask, pos, 0)
        cols = np.where(mask, csr.indices[pos] if csr.indices.size else 0, 0).astype(np.int64)
        data = csr.data.astype(dtype) if dtype is not None else csr.data
        vals = np.where(mask, data[pos] if data.size else 0, 0).astype(data.dtype)
        return cls(
            cols=torch.as_tensor(cols, device=device), vals=torch.as_tensor(vals, device=device),
            shape=tuple(csr.shape),
        )

    def to_csr(self) -> HostCSR:
        """Back to HostCSR, the padding dropped."""
        import scipy.sparse as sp

        cols = self.cols.cpu().numpy()
        vals = self.vals.cpu().numpy()
        keep = vals != 0
        rows = np.broadcast_to(np.arange(self.n_rows)[None, :], cols.shape)[keep]
        m = sp.csr_matrix((vals[keep], (rows, cols[keep])), shape=self.shape)
        m.sum_duplicates()
        m.sort_indices()
        return HostCSR.from_scipy(m)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x for a vector (n_cols,) or for each column of a stack
        (k, n_cols): ``width`` row gathers, a product, a sum over width."""
        return (self.vals * x[..., self.cols]).sum(dim=-2)

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        """Y = A @ X for a dense block X of shape (n_cols, k)."""
        return torch.einsum("wr,wrk->rk", self.vals, x[self.cols])

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        """x = A^T @ y for a vector (n_rows,) or a stack (k, n_rows): the
        products gathered through ``tmap`` and summed in its fixed order."""
        prod = (self.vals * y[..., None, :]).reshape(*y.shape[:-1], -1)
        prod = torch.cat([prod, prod.new_zeros(*y.shape[:-1], 1)], dim=-1)
        return prod[..., self.tmap].sum(dim=-1)

    def diagonal(self) -> torch.Tensor:
        rows = torch.arange(self.n_rows, device=self.cols.device)[None, :]
        on_diag = (self.cols == rows) & (self.vals != 0)
        return torch.where(on_diag, self.vals, torch.zeros_like(self.vals)).sum(dim=0)

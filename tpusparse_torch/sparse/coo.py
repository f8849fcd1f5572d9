"""COO sparse matrix — port of ``tpusparse/sparse/coo.py``.

The assembly-order format (PETSc's ``MatSetValues`` stage before
``MatAssemblyEnd``): coordinate triplets, duplicates allowed (they sum,
as ``ADD_VALUES`` does).  The JAX package's ``mv`` is an XLA gather and
``segment_sum``, not a Pallas kernel, so the port's is plain torch: an
``index_select`` of x and an ``index_add_`` over the rows.  No solve path
runs it; it is a library container.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusparse_torch.sparse.csr import HostCSR


@dataclasses.dataclass
class COO:
    """Coordinate-format sparse matrix on a device."""

    rows: torch.Tensor  # (nnz,) int64
    cols: torch.Tensor  # (nnz,) int64
    vals: torch.Tensor  # (nnz,) float
    shape: tuple[int, int]
    rows_sorted: bool = False

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @classmethod
    def from_csr(cls, csr, dtype=None, *, device="cuda") -> "COO":
        """From a HostCSR or scipy matrix; ``dtype`` a numpy dtype for the
        values (default: the matrix's)."""
        if not isinstance(csr, HostCSR):
            csr = HostCSR.from_scipy(csr)
        rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64), csr.row_nnz())
        data = csr.data.astype(dtype) if dtype is not None else csr.data
        return cls(
            rows=torch.as_tensor(rows, device=device),
            cols=torch.as_tensor(csr.indices.astype(np.int64), device=device),
            vals=torch.as_tensor(data, device=device),
            shape=tuple(csr.shape),
            rows_sorted=True,
        )

    def to_csr(self) -> HostCSR:
        """Back to a HostCSR, duplicates summed (MatAssemblyEnd)."""
        import scipy.sparse as sp

        m = sp.csr_matrix(
            (self.vals.cpu().numpy(), (self.rows.cpu().numpy(), self.cols.cpu().numpy())),
            shape=self.shape,
        )
        m.sum_duplicates()
        m.sort_indices()
        return HostCSR.from_scipy(m)

    def _sum_rows(self, contrib: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
        out = contrib.new_zeros((n,) + tuple(contrib.shape[1:]))
        return out.index_add_(0, index, contrib)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x: the per-entry products summed into their rows."""
        return self._sum_rows(self.vals * x.index_select(0, self.cols), self.rows, self.shape[0])

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        """Y = A @ X for X of shape (n_cols, k)."""
        return self._sum_rows(self.vals[:, None] * x.index_select(0, self.cols), self.rows, self.shape[0])

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        """x = A^T @ y: the products summed into their columns."""
        return self._sum_rows(self.vals * y.index_select(0, self.rows), self.cols, self.shape[1])

    def diagonal(self) -> torch.Tensor:
        on_diag = self.rows == self.cols
        return self._sum_rows(torch.where(on_diag, self.vals, 0.0), self.rows, self.shape[0])

    def __matmul__(self, x):
        return self.mv(x)

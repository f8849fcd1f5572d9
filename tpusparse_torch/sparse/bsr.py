"""BSR (block compressed sparse row) matrix — port of
``tpusparse/sparse/bsr.py``.

PETSc's BAIJ family: square ``bs`` x ``bs`` blocks stored as one dense
``(nnzb, bs, bs)`` tensor, so ``y_block = B x_block`` is a batched small
product and each block row's sum an ``index_add_``.  The JAX package's
``mv`` is an XLA einsum, gather and ``segment_sum``, not a Pallas kernel,
so the port's is plain torch.  No solve path runs it; it is a library
container.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusparse_torch.sparse.csr import HostCSR


@dataclasses.dataclass
class BSR:
    """Block-sparse matrix with square ``bs`` x ``bs`` blocks.

    ``brows``/``bcols``: (nnzb,) block coordinates, rows sorted;
    ``blocks``: (nnzb, bs, bs) values.  ``shape`` is the scalar shape.
    """

    brows: torch.Tensor   # (nnzb,) int64, sorted
    bcols: torch.Tensor   # (nnzb,) int64
    blocks: torch.Tensor  # (nnzb, bs, bs)
    shape: tuple[int, int]
    bs: int

    @property
    def nnzb(self) -> int:
        return self.blocks.shape[0]

    @property
    def nnz(self) -> int:
        return self.nnzb * self.bs * self.bs

    @property
    def n_brows(self) -> int:
        return self.shape[0] // self.bs

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @classmethod
    def from_scipy_bsr(cls, m, dtype=None, *, device="cuda") -> "BSR":
        """From a ``scipy.sparse.bsr_matrix`` (or any scipy sparse matrix,
        taken in 1 x 1 blocks)."""
        import scipy.sparse as sp

        if not sp.issparse(m):
            raise TypeError("expected a scipy sparse matrix")
        bs = m.blocksize[0] if hasattr(m, "blocksize") else 1
        m = m.tobsr(blocksize=(bs, bs)) if m.format != "bsr" else m
        m.sort_indices()
        bs = m.blocksize[0]
        if m.blocksize[0] != m.blocksize[1]:
            raise ValueError(f"square blocks only, got {m.blocksize}")
        brows = np.repeat(np.arange(m.shape[0] // bs, dtype=np.int64), np.diff(m.indptr))
        data = m.data.astype(dtype) if dtype is not None else m.data
        return cls(
            brows=torch.as_tensor(brows, device=device),
            bcols=torch.as_tensor(m.indices.astype(np.int64), device=device),
            blocks=torch.as_tensor(data, device=device),
            shape=tuple(m.shape),
            bs=bs,
        )

    @classmethod
    def from_csr(cls, csr, bs: int, dtype=None, *, device="cuda") -> "BSR":
        """Re-block a HostCSR or scipy CSR into ``bs`` x ``bs`` blocks."""
        if isinstance(csr, HostCSR):
            csr = csr.to_scipy()
        return cls.from_scipy_bsr(csr.tobsr(blocksize=(bs, bs)), dtype, device=device)

    def to_csr(self) -> HostCSR:
        import scipy.sparse as sp

        indptr = np.zeros(self.n_brows + 1, np.int64)
        np.add.at(indptr[1:], self.brows.cpu().numpy(), 1)
        np.cumsum(indptr, out=indptr)
        m = sp.bsr_matrix(
            (self.blocks.cpu().numpy(), self.bcols.cpu().numpy(), indptr), shape=self.shape,
        )
        c = m.tocsr()
        c.sum_duplicates()
        c.sort_indices()
        c.eliminate_zeros()
        return HostCSR.from_scipy(c)

    def _sum_brows(self, contrib: torch.Tensor) -> torch.Tensor:
        out = contrib.new_zeros((self.n_brows,) + tuple(contrib.shape[1:]))
        return out.index_add_(0, self.brows, contrib)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x: gather the x blocks, batched bs x bs products, block
        row sums."""
        xb = x.reshape(-1, self.bs).index_select(0, self.bcols)          # (nnzb, bs)
        return self._sum_brows(torch.einsum("nij,nj->ni", self.blocks, xb)).reshape(-1)

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        """Y = A @ X for X of shape (n_cols, k)."""
        k = x.shape[1]
        xb = x.reshape(-1, self.bs, k).index_select(0, self.bcols)       # (nnzb, bs, k)
        return self._sum_brows(torch.einsum("nij,njk->nik", self.blocks, xb)).reshape(-1, k)

    def diagonal(self) -> torch.Tensor:
        """The scalar diagonal (the diagonal entries of the diagonal blocks)."""
        on_diag = (self.brows == self.bcols)[:, None, None]
        dsum = self._sum_brows(torch.where(on_diag, self.blocks, 0.0))  # (nbrows, bs, bs)
        return torch.diagonal(dsum, dim1=1, dim2=2).reshape(-1)

    def __matmul__(self, x):
        return self.mv(x)

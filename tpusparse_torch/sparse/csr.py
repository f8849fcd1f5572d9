"""Host CSR matrix — port of ``tpusparse/sparse/csr.py::HostCSR``.

The staging format of the general-matrix path: assembly
(``grid/poisson.py::assemble_poisson``) and the PETSc binary reader
(``sparse/io.py``) produce it, and ``DIA.host_bands``,
``BlockJacobi.build`` and ``KSP.set_operators`` read it.  Numpy on the
host (PETSc SeqAIJ's ``a->i / a->j / a->a``), never on the hot path.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HostCSR:
    """Compressed sparse row matrix on the host (numpy arrays)."""

    indptr: np.ndarray   # (n_rows + 1,) int64
    indices: np.ndarray  # (nnz,) int32
    data: np.ndarray     # (nnz,) float
    shape: tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def dtype(self):
        return self.data.dtype

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def max_row_nnz(self) -> int:
        return int(self.row_nnz().max(initial=0))

    def _rows(self) -> np.ndarray:
        """The row of each stored entry."""
        return np.repeat(np.arange(self.n_rows, dtype=np.int64), self.row_nnz())

    @classmethod
    def from_scipy(cls, m) -> "HostCSR":
        m = m.tocsr()
        m.sort_indices()
        return cls(
            indptr=np.asarray(m.indptr, dtype=np.int64),
            indices=np.asarray(m.indices, dtype=np.int32),
            data=np.asarray(m.data),
            shape=tuple(m.shape),
        )

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix((self.data, self.indices, self.indptr), shape=self.shape)

    @classmethod
    def from_dense(cls, a: np.ndarray) -> "HostCSR":
        import scipy.sparse as sp

        return cls.from_scipy(sp.csr_matrix(np.asarray(a)))

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()

    def mv(self, x: np.ndarray) -> np.ndarray:
        """y = A @ x: the per-row dot of the stored entries
        (MatMult_SeqAIJ's semantics), a numpy oracle."""
        x = np.asarray(x)
        y = np.zeros(self.n_rows, dtype=np.result_type(self.data, x))
        np.add.at(y, self._rows(), self.data * x[self.indices])
        return y

    def diagonal(self) -> np.ndarray:
        """MatGetDiagonal (reference ``src/helper.cpp:264``)."""
        d = np.zeros(self.n_rows, dtype=self.dtype)
        rows = self._rows()
        on_diag = rows == self.indices
        d[rows[on_diag]] = self.data[on_diag]
        return d

    def transpose(self) -> "HostCSR":
        return HostCSR.from_scipy(self.to_scipy().T.tocsr())

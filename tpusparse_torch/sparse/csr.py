"""Host CSR matrix — the part of ``tpusparse/sparse/csr.py::HostCSR`` that
the general-matrix path needs: the container ``assemble_poisson`` returns
and ``DIA.host_bands`` reads.  Numpy on the host, never on the hot path.
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

"""Banded (DIA) sparse matrices — port of ``tpusparse/sparse/dia.py``: the
containers of the general-matrix (``mat_type="aij"``) path.

A DIA matrix stores one value array per occupied diagonal and applies

    y[r] = sum_k  bands[k][r] * x[r + offsets[k]]      (zero outside [0, n))

Matrices from meshes occupy few distinct diagonals: the 7-point Poisson
has 7 bands, its geometric Galerkin coarse operators at most 27.  Storage
is ``bands (K, n)`` with ``bands[k, r] = A[r, r + offsets[k]]``; rows whose
diagonal leaves the matrix hold zeros.

``DIA.mv`` goes through ``kernels/diaband.py::dia_mv``: on a CUDA tensor the
hand-written K5 kernel, on a CPU tensor its plain twin.  ``DFDIA`` is the
two-float (hi + lo f32) outer operator of the mixed-precision solve; its
apply stays plain torch in x's dtype (f64), once per outer sweep, as the JAX
package computes it in XLA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusparse_torch.kernels.diaband import _shift, dia_mv
from tpusparse_torch.sparse.csr import HostCSR


@dataclasses.dataclass
class DIA:
    """Banded matrix: ``bands[k, r] = A[r, r + offsets[k]]``."""

    bands: torch.Tensor            # (K, n)
    offsets: tuple[int, ...]       # sorted
    shape: tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.bands.dtype

    @staticmethod
    def host_bands(csr, max_offsets: int = 192, dtype=None):
        """Host-side band extraction: (bands ndarray (K, n), offsets tuple,
        shape).  Raises ValueError above ``max_offsets`` diagonals."""
        if not isinstance(csr, HostCSR):
            csr = HostCSR.from_scipy(csr)
        n, m = csr.shape
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.indptr))
        off = csr.indices.astype(np.int64) - rows
        data = csr.data.astype(dtype) if dtype is not None else csr.data
        if off.size == 0:
            return np.zeros((1, n), data.dtype), (0,), (n, m)
        offsets, k = np.unique(off, return_inverse=True)
        if offsets.size > max_offsets:
            raise ValueError(
                f"matrix occupies {offsets.size} diagonals > max_offsets={max_offsets}"
            )
        bands = np.zeros((offsets.size, n), data.dtype)
        bands[k, rows] = data
        return bands, tuple(int(o) for o in offsets), (n, m)

    @classmethod
    def from_csr(cls, csr, max_offsets: int = 192, dtype=None, *, device) -> "DIA":
        """Convert a HostCSR or scipy CSR matrix; its bands go to ``device``."""
        bands, offsets, shape = cls.host_bands(csr, max_offsets, dtype)
        return cls(bands=torch.as_tensor(bands, device=device), offsets=offsets, shape=shape)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x: K5 on a CUDA tensor, its plain twin on a CPU one."""
        return dia_mv(self.bands, x, self.offsets)

    def diagonal(self) -> torch.Tensor:
        if 0 in self.offsets:
            return self.bands[self.offsets.index(0)]
        return torch.zeros(self.n_rows, dtype=self.dtype, device=self.bands.device)


@dataclasses.dataclass
class DFDIA:
    """Two-float (hi + lo f32) banded matrix that applies in x's dtype.

    ``hi`` holds ``float32(A)``; ``lo`` the f32 residual ``A - hi``, or None
    when A is exactly f32-representable.  ``mv`` promotes each band to x's
    dtype, so hi + lo carries ~48 mantissa bits at 4 B per entry.  ``hi``
    may alias the f32 hierarchy's fine-level bands.

    ``grid`` (the JAX package's 3-D view, ``sparse/griddia.py``) is not
    ported: only the flat form exists here.
    """

    hi: torch.Tensor                 # (K, n) f32
    lo: torch.Tensor | None          # (K, n) f32 residual, or None
    offsets: tuple[int, ...]
    shape: tuple[int, int]
    grid: tuple | None = None

    def __post_init__(self):
        if self.grid is not None:
            raise NotImplementedError(
                "the 3-D grid view of DFDIA (sparse/griddia.py) is not ported yet"
            )

    @classmethod
    def from_host_bands(cls, bands64: np.ndarray, offsets, shape, *, device) -> "DFDIA":
        """Split host f64 bands into tensors on ``device``; upload lo only
        when nonzero."""
        hi_np = bands64.astype(np.float32)
        lo_np = (bands64 - hi_np.astype(np.float64)).astype(np.float32)
        return cls(
            hi=torch.as_tensor(hi_np, device=device),
            lo=torch.as_tensor(lo_np, device=device) if np.any(lo_np) else None,
            offsets=tuple(int(o) for o in offsets),
            shape=tuple(shape),
        )

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x in x's dtype (each band promoted on the fly), hi terms in
        ascending band order, then lo terms."""
        dt, n = x.dtype, self.n_rows
        y = self.hi[0].to(dt) * _shift(x, self.offsets[0], n)
        for k, o in enumerate(self.offsets[1:], start=1):
            y = y + self.hi[k].to(dt) * _shift(x, o, n)
        if self.lo is not None:
            for k, o in enumerate(self.offsets):
                y = y + self.lo[k].to(dt) * _shift(x, o, n)
        return y

    def diagonal(self) -> torch.Tensor:
        if 0 not in self.offsets:
            return torch.zeros(self.n_rows, dtype=torch.float64, device=self.hi.device)
        k = self.offsets.index(0)
        d = self.hi[k].to(torch.float64)
        if self.lo is not None:
            d = d + self.lo[k].to(torch.float64)
        return d

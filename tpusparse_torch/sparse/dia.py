"""Banded (DIA) sparse matrices — port of ``tpusparse/sparse/dia.py``: the
containers of the general-matrix (``mat_type="aij"``) path.

A DIA matrix stores one value array per occupied diagonal and applies

    y[r] = sum_k  bands[k][r] * x[r + offsets[k]]      (zero outside [0, n))

Matrices from meshes occupy few distinct diagonals: the 7-point Poisson
has 7 bands, its geometric Galerkin coarse operators at most 27.  Storage
is ``bands (K, n)`` with ``bands[k, r] = A[r, r + offsets[k]]``; rows whose
diagonal leaves the matrix hold zeros.

``DIA.mv`` on float32 bands goes through ``kernels/diaband.py``: a vector
to ``dia_mv`` (K5), a stack of columns (k, n) to ``dia_mv_batched``; on a
CUDA tensor the hand-written kernels, on a CPU tensor their plain twin.
Bands of any other dtype (the f64 levels of uniform precision) apply in
plain torch in ascending band order, which is the JAX package's own XLA
``DIA.mv``: its Pallas K5 is f32 only, as the port's kernels are.
``HybridDIA`` keeps the heaviest diagonals of a matrix past the DIA cap
as a DIA (K5) and the rest as a thin ``ELL`` gather (``auto_container``
picks one or the other).  ``DFDIA`` is the two-float (hi + lo f32) outer operator of the
mixed-precision solve; its apply stays plain torch in x's dtype (f64),
once per outer sweep, as the JAX package computes it in XLA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusparse_torch.kernels.diaband import _shift, dia_mv, dia_mv_batched, dia_mv_torch
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
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.bands.dtype

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.bands))

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
        # the distinct offsets and each entry's band without np.unique's
        # O(nnz log nnz) sort where the offset range is small (a banded
        # matrix): a bincount and a lookup table, one linear pass each
        omin = int(off.min())
        span = int(off.max()) - omin + 1
        if span <= max(4 * off.size, 1 << 24):
            offsets = np.flatnonzero(np.bincount(off - omin, minlength=span)) + omin
            lut = np.zeros(span, np.int64)
            lut[offsets - omin] = np.arange(offsets.size)
            k = lut[off - omin]
        else:
            offsets = np.unique(off)
            k = np.searchsorted(offsets, off)
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

    def to_scipy(self):
        import scipy.sparse as sp

        bands = self.bands.cpu().numpy()
        n, m = self.shape
        rows, cols, vals = [], [], []
        for k, o in enumerate(self.offsets):
            r = np.arange(max(0, -o), min(n, m - o))
            v = bands[k, r]
            keep = v != 0
            rows.append(r[keep])
            cols.append(r[keep] + o)
            vals.append(v[keep])
        a = sp.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=self.shape,
        )
        a.sum_duplicates()
        a.sort_indices()
        return a

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x for a vector (n,), or for each column of a stack (k,
        n): K5 or the batched K5 on f32 bands, plain torch on any other."""
        if self.dtype != torch.float32:
            return dia_mv_torch(self.bands, x, self.offsets)
        kernel = dia_mv if x.dim() == 1 else dia_mv_batched
        return kernel(self.bands, x.contiguous(), self.offsets)

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        """Y = A @ X for dense X of shape (n_cols, j), in plain torch."""
        n = self.n_rows
        y = self.bands[0][:, None] * _shift(x, self.offsets[0], n, dim=0)
        for k, o in enumerate(self.offsets[1:], start=1):
            y = y + self.bands[k][:, None] * _shift(x, o, n, dim=0)
        return y

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        """x = A^T @ y: the products shifted the other way, in plain torch."""
        m = self.n_cols
        x = _shift(self.bands[0] * y, -self.offsets[0], m)
        for k, o in enumerate(self.offsets[1:], start=1):
            x = x + _shift(self.bands[k] * y, -o, m)
        return x

    def diagonal(self) -> torch.Tensor:
        if 0 in self.offsets:
            return self.bands[self.offsets.index(0)]
        return torch.zeros(self.n_rows, dtype=self.dtype, device=self.bands.device)


@dataclasses.dataclass
class HybridDIA:
    """DIA for the heavy diagonals plus a thin ELL remainder.

    Matrices that occupy too many distinct diagonals for pure DIA (the
    Galerkin coarse operators of greedy aggregation: a few dominant
    near-grid offsets and a scatter of ragged-boundary entries) split: the
    most populated diagonals carry the bulk of the entries through K5, and
    the rest is an ``ELL`` gather.  ``mv`` takes a vector or a stack of
    columns (k, n).
    """

    dia: DIA
    rem: object | None   # ELL, or None when the bands cover everything

    @classmethod
    def from_csr(cls, csr, max_bands: int = 64, dtype=None, *, device) -> "HybridDIA":
        """Keep the ``max_bands`` most populated diagonals (and the main
        one) as DIA, the rest as ELL.  The bands are chosen with the JAX
        package's numpy calls (``np.unique`` counts, a reversed
        ``np.argsort``), so tied counts pick the same diagonals."""
        import scipy.sparse as sp

        from tpusparse_torch.sparse.ell import ELL

        if not isinstance(csr, HostCSR):
            csr = HostCSR.from_scipy(csr)
        n, m = csr.shape
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.indptr))
        off = csr.indices.astype(np.int64) - rows
        offsets, counts = np.unique(off, return_counts=True)
        if offsets.size > max_bands:
            order = np.argsort(counts)[::-1]
            keep = set(offsets[order[:max_bands]].tolist())
            keep.add(0)
        else:
            keep = set(offsets.tolist()) | {0}
        in_dia = np.isin(off, np.fromiter(keep, np.int64))

        def sub(mask):
            return sp.csr_matrix((csr.data[mask], (rows[mask], csr.indices[mask])), shape=(n, m))

        dia = DIA.from_csr(sub(in_dia), max_offsets=max_bands + 1, dtype=dtype, device=device)
        rem = None
        if (~in_dia).any():
            rem = ELL.from_csr(sub(~in_dia), dtype=dtype, device=device)
        return cls(dia=dia, rem=rem)

    @property
    def shape(self) -> tuple[int, int]:
        return self.dia.shape

    @property
    def n_rows(self) -> int:
        return self.dia.n_rows

    @property
    def n_cols(self) -> int:
        return self.dia.n_cols

    @property
    def dtype(self) -> torch.dtype:
        return self.dia.dtype

    @property
    def nnz(self) -> int:
        return self.dia.nnz + (self.rem.nnz if self.rem is not None else 0)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dia.mv(x)
        if self.rem is not None:
            y = y + self.rem.mv(x)
        return y

    def diagonal(self) -> torch.Tensor:
        return self.dia.diagonal()  # the main diagonal is always a band

    def to_scipy(self):
        a = self.dia.to_scipy()
        if self.rem is not None:
            a = (a + self.rem.to_csr().to_scipy()).tocsr()
        return a


def auto_container(csr, max_bands: int = 64, dtype=None, *, device):
    """The level container of a host matrix past the DIA cap: pure DIA
    when its ``max_bands`` heaviest diagonals cover it, else a
    ``HybridDIA``.  The JAX package's ``auto_container`` without its gather
    cap (a libtpu crash cap, not to port): no widened DIA, no banded
    ELL."""
    hyb = HybridDIA.from_csr(csr, max_bands=max_bands, dtype=dtype, device=device)
    return hyb.dia if hyb.rem is None else hyb


@dataclasses.dataclass
class DFDIA:
    """Two-float (hi + lo f32) banded matrix that applies in x's dtype.

    ``hi`` holds ``float32(A)``; ``lo`` the f32 residual ``A - hi``, or None
    when A is exactly f32-representable.  ``mv`` promotes each band to x's
    dtype, so hi + lo carries ~48 mantissa bits at 4 B per entry.  ``hi``
    may alias the f32 hierarchy's fine-level bands.

    ``grid`` (the JAX package's 3-D view, ``sparse/griddia.py``) is not
    ported: only the JAX package's sharded general executor
    (``dist/general.py``) builds it, so it belongs with the multi-device
    work (ROADMAP queue 12).  No single-device entry point builds it, and
    the JAX driver keeps the flat form, measured faster there.
    """

    hi: torch.Tensor                 # (K, n) f32
    lo: torch.Tensor | None          # (K, n) f32 residual, or None
    offsets: tuple[int, ...]
    shape: tuple[int, int]
    grid: tuple | None = None

    def __post_init__(self):
        if self.grid is not None:
            raise NotImplementedError(
                "the 3-D grid view of DFDIA (sparse/griddia.py) is not ported to tpusparse_torch yet"
                " (ROADMAP queue 12: only the sharded general executor builds it)"
            )

    @classmethod
    def from_host_bands(cls, bands64: np.ndarray, offsets, shape, *, device, hi_dev=None) -> "DFDIA":
        """Split host f64 bands into tensors on ``device``; upload lo only
        when nonzero.  ``hi_dev``: an f32 band tensor already uploaded to
        alias as ``hi``; it must equal ``float32(bands64)``, which is
        checked on its shape, dtype and first and last entries."""
        hi_np = bands64.astype(np.float32)
        lo_np = (bands64 - hi_np.astype(np.float64)).astype(np.float32)
        if hi_dev is None:
            hi_dev = torch.as_tensor(hi_np, device=device)
        elif tuple(hi_dev.shape) != hi_np.shape or hi_dev.dtype != torch.float32 or (
            hi_np.size and (hi_dev.reshape(-1)[[0, -1]].cpu().numpy() != hi_np.reshape(-1)[[0, -1]]).any()
        ):
            # lo was computed against the host bands: a stale alias would
            # build hi + lo != A
            raise ValueError(
                f"hi_dev {tuple(hi_dev.shape)} {hi_dev.dtype} is not float32(bands64) {hi_np.shape}"
            )
        return cls(
            hi=hi_dev,
            lo=torch.as_tensor(lo_np, device=device) if np.any(lo_np) else None,
            offsets=tuple(int(o) for o in offsets),
            shape=tuple(shape),
        )

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64  # the dtype mv applies in

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x in x's dtype (each band promoted on the fly), hi terms in
        ascending band order, then lo terms; for a vector (n,) or for each
        column of a stack (k, n)."""
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


def host_dia_operators(csr, precision: str, *, device, timings: dict | None = None):
    """A host matrix on ``device`` as the DIA family, the JAX package's
    rule: ``(op_hi, op_lo)``.  Under ``precision="mixed"`` one f32 upload
    serves both precisions, the f32 ``DIA`` of the inner solves and the
    hierarchy and the hi half of the two-float ``DFDIA`` outer operator
    (whose lo half uploads only where A is not exactly f32); under
    ``"f64"``/``"f32"`` one ``DIA`` in that dtype is both.  ``timings``
    receives the seconds of the band extraction (``host_bands``) and of the
    upload (``upload``, synchronized)."""
    import time

    t0 = time.perf_counter()
    bands, offsets, shape = DIA.host_bands(csr, dtype=np.float32 if precision == "f32" else None)
    t1 = time.perf_counter()
    if precision == "mixed":
        op_lo = DIA(bands=torch.as_tensor(bands.astype(np.float32), device=device), offsets=offsets, shape=shape)
        op_hi = DFDIA.from_host_bands(bands, offsets, shape, device=device, hi_dev=op_lo.bands)
    else:
        op_hi = op_lo = DIA(bands=torch.as_tensor(bands, device=device), offsets=offsets, shape=shape)
    if timings is not None:
        if op_lo.bands.device.type == "cuda":
            torch.cuda.synchronize(op_lo.bands.device)
        timings.update(host_bands=t1 - t0, upload=time.perf_counter() - t1)
    return op_hi, op_lo

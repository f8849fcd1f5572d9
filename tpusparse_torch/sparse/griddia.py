"""Grid-view banded matrix: DIA with 3-D shift semantics — port of
``tpusparse/sparse/griddia.py``.

``DIA.mv`` applies bands as 1-D shifts of the flat vector.  When the
operator lives on a known (nz, ny, nx) grid (the geometric aij path,
``amg/geo.py``), the same product is

    y3 = sum_k  B_k3 * shift3(x3, d3_k)

over field views, the formulation of the structured stencil path, with
per-row coefficient fields: still the general banded container.  The JAX
package keeps it for its TPU, where a flat shift by +-1 crosses vector
lanes; here ``mv`` is the same sum in torch ops (XLA glue in the JAX
package, not a Pallas kernel), and the block-row executor
(``dist/general.py``) shards its flat view (``to_dia``).

Flat and 3-D shifts differ at grid edges (a flat offset +1 at x = nx - 1
wraps into the next row).  They coincide where every band is zero at its
wrap positions, which ``host_grid_view`` validates band by band (one host
pass); inputs that fail keep the flat form.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def shift3(x3: torch.Tensor, d3) -> torch.Tensor:
    """out[p] = x3[p + d3] with zeros shifted in."""
    if all(d == 0 for d in d3):
        return x3
    out = torch.zeros_like(x3)
    src, dst = [], []
    for d, s in zip(d3, x3.shape):
        lo, hi = max(0, -d), min(s, s - d)
        if hi <= lo:
            return out
        dst.append(slice(lo, hi))
        src.append(slice(lo + d, hi + d))
    out[tuple(dst)] = x3[tuple(src)]
    return out


def _decompose(o: int, shape) -> tuple[int, int, int] | None:
    """Flat offset -> (dz, dy, dx) on ``shape``, or None if out of range."""
    nz, ny, nx = shape
    q = ny * nx
    dz = round(o / q) if nz > 1 else 0
    rem = o - dz * q
    dy = round(rem / nx) if ny > 1 else 0
    dx = rem - dy * nx
    if abs(dz) >= nz or abs(dy) >= ny or abs(dx) >= nx:
        return None
    if dz * q + dy * nx + dx != o:
        return None
    return (dz, dy, dx)


def _wrap_ok(band: np.ndarray, d3, shape) -> bool:
    """True when the band is zero wherever the 3-D neighbour leaves the
    grid (= wherever flat and 3-D shift semantics differ)."""
    b3 = band.reshape(shape)
    for ax, (d, n) in enumerate(zip(d3, shape)):
        if d == 0:
            continue
        sl = [slice(None)] * 3
        sl[ax] = slice(n - d, n) if d > 0 else slice(0, -d)
        e = b3[tuple(sl)]
        if e.size and np.any(e != 0):
            return False
    return True


def host_grid_view(bands_host: np.ndarray, offsets, grid_shape):
    """Validate a host band array for the 3-D view: every offset must
    decompose on ``grid_shape`` and every band must be zero at its wrap
    positions.  Returns the d3 tuple, or None (keep the flat form)."""
    shape = tuple(int(s) for s in grid_shape)
    d3s = []
    for k, o in enumerate(offsets):
        d3 = _decompose(int(o), shape)
        if d3 is None or not _wrap_ok(bands_host[k], d3, shape):
            return None
        d3s.append(d3)
    return tuple(d3s)


@dataclasses.dataclass
class GridDIA:
    """Banded matrix on a known (nz, ny, nx) grid, its bands applied as 3-D
    field shifts.  Flat-vector interface (``mv``/``diagonal`` take and
    return (n,)), so it drops into the DIA-shaped hierarchy unchanged."""

    bands: torch.Tensor                   # (K, n)
    offsets: tuple[int, ...]              # flat offsets (sorted, DIA parity)
    d3s: tuple[tuple[int, int, int], ...]
    grid_shape: tuple[int, int, int]

    @classmethod
    def from_dia(cls, dia, grid_shape, validate: bool = True):
        """Wrap a DIA whose couplings are grid-neighbour couplings; None
        when an offset does not decompose or (``validate``) a band has
        nonzero wrap entries (the caller keeps the flat DIA)."""
        shape = tuple(int(s) for s in grid_shape)
        if validate:
            d3s = host_grid_view(dia.bands.cpu().numpy(), dia.offsets, shape)
            if d3s is None:
                return None
        else:
            d3s = []
            for o in dia.offsets:
                d3 = _decompose(int(o), shape)
                if d3 is None:
                    return None
                d3s.append(d3)
            d3s = tuple(d3s)
        return cls(bands=dia.bands, offsets=tuple(int(o) for o in dia.offsets), d3s=d3s, grid_shape=shape)

    def to_dia(self):
        from tpusparse_torch.sparse.dia import DIA

        return DIA(bands=self.bands, offsets=self.offsets, shape=self.shape)

    # --- DIA-compatible surface -----------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        n = int(np.prod(self.grid_shape))
        return (n, n)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.bands.dtype

    def diagonal(self) -> torch.Tensor:
        if 0 in self.offsets:
            return self.bands[self.offsets.index(0)]
        return torch.zeros(self.n_rows, dtype=self.dtype, device=self.bands.device)

    def to_scipy(self):
        return self.to_dia().to_scipy()

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x via 3-D field shifts (flat in, flat out), in ascending
        band order."""
        shape = self.grid_shape
        x3 = x.reshape(shape)
        y3 = self.bands[0].reshape(shape) * shift3(x3, self.d3s[0])
        for k in range(1, len(self.d3s)):
            y3 = y3 + self.bands[k].reshape(shape) * shift3(x3, self.d3s[k])
        return y3.reshape(-1)

    def __matmul__(self, x):
        return self.mv(x)

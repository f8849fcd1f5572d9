"""7-point star-stencil operator on structured 3D grids — port of
``tpusparse/sparse/stencil.py``.

The matrix action is six shifted reads plus a positionally varying diagonal,

    y[k,j,i] = diag[k,j,i]*x[k,j,i]
             + cx*(x[k,j,i-1] + x[k,j,i+1])
             + cy*(x[k,j-1,i] + x[k,j+1,i])
             + cz*(x[k-1,j,i] + x[k+1,j,i])

with zero fill outside the domain (the reference's Neumann-via-dropped
-entries assembly, ``src/helper.cpp:229-233``).  The pinned row/column
(``MatZeroRowsColumns``, ``src/helper.cpp:274``) is carried structurally:
x[0,0,0] is zeroed before the shifts and y[0,0,0] is rewritten after.

``mv`` runs kernel K1p (``kernels/stencil7.py::star7_mv``) on f32 fields,
the inner operator of the plain layout and of uniform f32 precision, as
the JAX package takes ``star7_mv_pallas`` for f32 only, and on a stack of
k f32 fields ``(k, nz, ny, nx)`` the batched K1p (``star7_mv_batched``, one
launch for the stack: ``KSP.mat_solve``'s block apply).  Other dtypes run
the same math in plain torch: the f64 outer operator of the mixed-precision
solve and the operator of uniform f64 precision, since the H100 has f64 in
hardware.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusparse_torch.kernels.stencil7 import star7_mv, star7_mv_batched, star7_mv_torch


@dataclasses.dataclass
class StarStencil3D:
    """Symmetric 7-point star with constant per-axis off-diagonal
    coefficients and an arbitrary (nz, ny, nx) diagonal field.

    ``cx``/``cy``/``cz`` are Python floats holding values of ``diag``'s
    dtype.  If ``pinned``, row/column 0 are zeroed except the diagonal.
    """

    diag: torch.Tensor   # (nz, ny, nx)
    cx: float
    cy: float
    cz: float
    pinned: bool

    @property
    def shape(self) -> tuple[int, int]:
        n = int(np.prod(self.grid_shape))
        return (n, n)

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return tuple(self.diag.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.diag.dtype

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x on the 3D field view (nz, ny, nx), or on each field of
        a stack (k, nz, ny, nx)."""
        if x.dim() not in (3, 4) or x.shape[-3:] != self.diag.shape:
            raise ValueError(f"x shape {tuple(x.shape)}: not grid {self.grid_shape} or a stack of it")
        if x.dtype == self.dtype == torch.float32:
            mv = star7_mv if x.dim() == 3 else star7_mv_batched
            return mv(self.diag, self.cx, self.cy, self.cz, x.contiguous(), self.pinned)
        return star7_mv_torch(self.diag, self.cx, self.cy, self.cz, x, self.pinned)

    def mv_flat(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x on the flat natural-ordering vector view."""
        return self.mv(x.reshape(self.diag.shape)).reshape(-1)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.mv(x) if x.dim() == 3 else self.mv_flat(x)

    def diagonal(self) -> torch.Tensor:
        return self.diag.reshape(-1)

    def diagonal_field(self) -> torch.Tensor:
        return self.diag

    def _index(self):
        nz, ny, nx = self.grid_shape
        dev = self.diag.device
        return (
            torch.arange(nz, device=dev)[:, None, None],
            torch.arange(ny, device=dev)[None, :, None],
            torch.arange(nx, device=dev)[None, None, :],
        )

    def gs_color_masks(self) -> list:
        """Red-black coloring: the star couples only opposite (i+j+k)
        parities, so a masked simultaneous update over one color is a
        Gauss-Seidel ordering (multicolor SOR, the parallel form of PETSc's
        PCSOR)."""
        k, j, i = self._index()
        p = (k + j + i) % 2
        return [p == 0, p == 1]

    def flat_band_fields(self, max_abs_offset: int) -> dict:
        """{flat offset o: field f with f[p] = A[p, p+o]} for every leg with
        0 < |o| < ``max_abs_offset`` (natural ordering).  Domain-edge drops
        and the pinned row/column are masked in, so the fields are the
        matrix bands (consumed by ``solve/bjacobi.py::BlockJacobi.from_bands``)."""
        nz, ny, nx = self.grid_shape
        k, j, i = self._index()
        zero = torch.zeros((), dtype=self.dtype, device=self.diag.device)
        legs = [
            (1, self.cx, i < nx - 1), (-1, self.cx, i > 0),
            (nx, self.cy, j < ny - 1), (-nx, self.cy, j > 0),
            (nx * ny, self.cz, k < nz - 1), (-nx * ny, self.cz, k > 0),
        ]
        flat = (k * ny + j) * nx + i
        out = {}
        for o, c, valid in legs:
            if abs(o) >= max_abs_offset:
                continue
            f = torch.where(valid, torch.tensor(c, dtype=self.dtype, device=self.diag.device), zero)
            f = f.expand(self.grid_shape)
            if self.pinned:
                # MatZeroRowsColumns on row/col 0: A[0, o] = A[o, 0] = 0
                f = torch.where((flat == 0) | (flat + o == 0), zero, f)
            out[o] = f
        return out

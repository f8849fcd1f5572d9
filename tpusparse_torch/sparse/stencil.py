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
the JAX package takes ``star7_mv_pallas`` for f32 only.  Other dtypes run
the same math in plain torch: the f64 outer operator of the mixed-precision
solve and the operator of uniform f64 precision, since the H100 has f64 in
hardware.
"""

from __future__ import annotations

import dataclasses

import torch

from tpusparse_torch.kernels.stencil7 import star7_mv, star7_mv_torch


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
    def grid_shape(self) -> tuple[int, int, int]:
        return tuple(self.diag.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.diag.dtype

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x on the 3D field view (nz, ny, nx)."""
        if x.shape != self.diag.shape:
            raise ValueError(f"x shape {tuple(x.shape)} != grid {self.grid_shape}")
        if x.dtype == self.dtype == torch.float32:
            return star7_mv(self.diag, self.cx, self.cy, self.cz, x.contiguous(), self.pinned)
        return star7_mv_torch(self.diag, self.cx, self.cy, self.cz, x, self.pinned)

    def diagonal_field(self) -> torch.Tensor:
        return self.diag

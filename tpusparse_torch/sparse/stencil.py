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

This is the f64 outer operator of the mixed-precision solve.  It stays in
plain torch on the card: the H100 has f64 in hardware and the outer loop
applies it once per defect-correction sweep.
"""

from __future__ import annotations

import dataclasses

import torch


def _shift(x: torch.Tensor, axis: int, direction: int) -> torch.Tensor:
    """out[..., i, ...] = x[..., i + direction, ...], zero-filled at the edge."""
    n = x.shape[axis]
    zero = torch.zeros_like(x.narrow(axis, 0, 1))
    if direction == 1:
        return torch.cat([x.narrow(axis, 1, n - 1), zero], dim=axis)
    if direction == -1:
        return torch.cat([zero, x.narrow(axis, 0, n - 1)], dim=axis)
    raise ValueError(f"direction must be +-1, got {direction}")


def _origin_mask(x: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the pinned cell (0, 0, 0), shaped like ``x``."""
    m = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    m[0, 0, 0] = True
    return m


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
        if self.pinned:
            origin = _origin_mask(x)
            xn = torch.where(origin, torch.zeros((), dtype=x.dtype, device=x.device), x)
        else:
            xn = x
        y = self.diag * x
        y += self.cx * (_shift(xn, 2, 1) + _shift(xn, 2, -1))
        y += self.cy * (_shift(xn, 1, 1) + _shift(xn, 1, -1))
        y += self.cz * (_shift(xn, 0, 1) + _shift(xn, 0, -1))
        if self.pinned:
            # pinned row: y[0] = diag[0] * x[0] only
            y = torch.where(origin, self.diag * x, y)
        return y

    def diagonal_field(self) -> torch.Tensor:
        return self.diag

"""Variable-coefficient 27-point stencil operator — port of
``tpusparse/sparse/varstencil.py``: the coarse-level Galerkin operators of
the structured AMG.

With geometric 3x3x3 aggregation and a once-smoothed prolongator every
coarse operator couples only the 27 immediate neighbours, so its action is
``sum_o coef[o] * x_shifted_by_o`` — shifted multiply-adds, no column
indices.  The apply stays plain torch: the coarse levels hold 1/27 of the
fine level's cells and less.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.nn.functional as F

# the 27 offsets in a fixed lexicographic order (dk, dj, di), each in {-1,0,1}
OFFSETS: tuple[tuple[int, int, int], ...] = tuple(
    itertools.product((-1, 0, 1), repeat=3)
)
CENTER = OFFSETS.index((0, 0, 0))  # = 13


def pad1(x: torch.Tensor) -> torch.Tensor:
    """One zero cell around every face: the source of all 27 shifts."""
    return F.pad(x, (1, 1, 1, 1, 1, 1))


def shifted_view(xp: torch.Tensor, off, shape) -> torch.Tensor:
    """x[p + off] with zero fill, as a view of ``xp = pad1(x)``."""
    (dk, dj, di), (nz, ny, nx) = off, shape
    return xp[1 + dk:1 + dk + nz, 1 + dj:1 + dj + ny, 1 + di:1 + di + nx]


def shift3(x: torch.Tensor, off: tuple[int, int, int]) -> torch.Tensor:
    """out[p] = x[p + off] with zero fill."""
    if all(d == 0 for d in off):
        return x
    return shifted_view(pad1(x), off, tuple(x.shape))


@dataclasses.dataclass
class VarStencil27:
    """y[p] = sum_o coef[o][p] * x[p + o], offsets o in OFFSETS order.

    ``coef`` has shape (27, nz, ny, nx).  Coefficients whose target p + o
    lies outside the grid are never read.  After ``cast_coarse_coefs`` the
    stack is bf16 while vectors stay f32: bf16 * f32 promotes to f32, as in
    JAX, so only the coefficient bytes shrink.
    """

    coef: torch.Tensor  # (27, nz, ny, nx)

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return tuple(self.coef.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.coef.dtype

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x on the 3D field view (same accumulation order as JAX)."""
        y = self.coef[CENTER] * x
        xp = pad1(x)
        for o, off in enumerate(OFFSETS):
            if o == CENTER:
                continue
            y = y + self.coef[o] * shifted_view(xp, off, self.grid_shape)
        return y

    def diagonal_field(self) -> torch.Tensor:
        return self.coef[CENTER]

"""Padded-resident 7-point stencil operator — port of
``tpusparse/sparse/padded.py``.

Every level-0 field of the inner solve (x, b, r, p, diag, dinv, ...) lives
permanently in the layout of ``kernels/stencil7.py::padded_shape`` with two
invariants: **every pad cell of a vector is zero**, and **diag's pads hold
1.0** (so ``1 / diag`` is finite and ``dinv * r`` keeps the pad zeros).  All
elementwise solver algebra preserves them, dots are unchanged by the zero
pads, and each stencil apply is one kernel launch over the resident fields.

The AMG transfers cross between the padded fine level and the true-shape
coarse levels: ``PaddedTransfer`` contracts with aggregation matrices whose
pad rows are zero, so prolongation writes and restriction reads the padded
layout directly.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tpusparse_torch.kernels.fused7 import fused7_cgmv, fused7_mvdot
from tpusparse_torch.kernels.stencil7 import FACE, padded_shape, star7_mv_padded
from tpusparse_torch.sparse.stencil import StarStencil3D


def pad_field(x: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """(nz, ny, nx) → padded layout, pads filled with ``value``."""
    nzp, nyp, nxp = padded_shape(tuple(x.shape))
    nz, ny, nx = x.shape
    return F.pad(x, (0, nxp - nx, 0, nyp - ny, FACE, FACE), value=value)


def crop_field(x_p: torch.Tensor, shape: tuple[int, int, int]) -> torch.Tensor:
    """Padded layout → (nz, ny, nx) (a view)."""
    nz, ny, nx = shape
    return x_p[FACE:nz + FACE, :ny, :nx]


@dataclasses.dataclass
class PaddedStar:
    """StarStencil3D twin operating on padded-resident f32 fields.

    ``diag`` is stored padded with 1.0 in the pads; the kernels never read
    it there (their outputs are zero outside the domain).
    """

    diag: torch.Tensor   # padded_shape(true_shape)
    cx: float
    cy: float
    cz: float
    pinned: bool
    true_shape: tuple[int, int, int]

    @classmethod
    def from_star(cls, op: StarStencil3D) -> "PaddedStar":
        return cls(
            diag=pad_field(op.diag, 1.0),
            cx=op.cx, cy=op.cy, cz=op.cz,
            pinned=op.pinned,
            true_shape=tuple(op.diag.shape),
        )

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return self.true_shape

    @property
    def dtype(self) -> torch.dtype:
        return self.diag.dtype

    def diagonal_field(self) -> torch.Tensor:
        """PADDED diagonal with 1.0 pads — safe to invert elementwise."""
        return self.diag

    def mv(self, x_p: torch.Tensor) -> torch.Tensor:
        """y = A @ x on padded fields (K1)."""
        return star7_mv_padded(
            self.diag, self.cx, self.cy, self.cz, x_p, self.true_shape,
            self.pinned,
        )

    def mv_dot(self, x_p: torch.Tensor):
        """(A @ x, <x, A x>) in one launch (K2): the CG alpha denominator."""
        return fused7_mvdot(
            self.diag, self.cx, self.cy, self.cz, x_p, self.true_shape,
            self.pinned,
        )

    def cgmv(self, z_p, p_p, x_p, alpha_prev, beta):
        """The full-fusion CG body's top half in one launch (K8):
        ``(ap, p_new, x_new, pap)`` with p_new = z + beta p, ap = A p_new,
        the deferred x_new = x + alpha_prev p and pap = <p_new, ap>."""
        return fused7_cgmv(
            self.diag, self.cx, self.cy, self.cz, z_p, p_p, x_p, beta,
            alpha_prev, self.true_shape, self.pinned,
        )


class PaddedTransfer:
    """StructuredTransfer adapter for a padded fine level.  Coarse fields
    stay true-shaped (VarStencil27 levels are unpadded)."""

    def __init__(self, inner):
        self.inner = inner  # StructuredTransfer
        # zero-padded per-axis aggregation matrices: the T-action einsums
        # then produce/consume the padded layout directly (the zero rows
        # realize the pads)
        nz, ny, nx = inner.fine_shape
        nzp, nyp, nxp = padded_shape(inner.fine_shape)
        self.szp = F.pad(inner.sz, (0, 0, FACE, nzp - nz - FACE))
        self.syp = F.pad(inner.sy, (0, 0, 0, nyp - ny))
        self.sxp = F.pad(inner.sx, (0, 0, 0, nxp - nx))

    @property
    def c_shape(self):
        return self.inner.c_shape

    @property
    def omega(self) -> float:
        return self.inner.omega

    def t_apply_padded(self, e_c: torch.Tensor) -> torch.Tensor:
        """T e_c straight into the padded layout (zero faces/pads)."""
        x = e_c * self.inner.tnorm
        x = torch.einsum("zc,cde->zde", self.szp, x)
        x = torch.einsum("yd,zde->zye", self.syp, x)
        return torch.einsum("xe,zye->zyx", self.sxp, x)

    def tT_apply_padded(self, s_p: torch.Tensor) -> torch.Tensor:
        """T^T s from a padded field (pads contract against zero rows)."""
        x = torch.einsum("zyx,zc->cyx", s_p, self.szp)
        x = torch.einsum("cyx,yd->cdx", x, self.syp)
        x = torch.einsum("cdx,xe->cde", x, self.sxp)
        return x * self.inner.tnorm

    def prolong(self, fine_op, dinv, e_c):
        t_p = self.t_apply_padded(e_c)
        return t_p - self.inner.omega * dinv * fine_op.mv(t_p)

    def restrict(self, fine_op, dinv, r_p):
        s_p = r_p - self.inner.omega * fine_op.mv(dinv * r_p)
        return self.tT_apply_padded(s_p)

"""Padded-resident 7-point stencil operator — port of
``tpusparse/sparse/padded.py``.

Every level-0 field of the inner solve (x, b, r, p, diag, dinv, ...) lives
permanently in the layout of ``kernels/stencil7.py::padded_shape`` with two
invariants: **every pad cell of a vector is zero**, and **diag's pads hold
1.0** (so ``1 / diag`` is finite and ``dinv * r`` keeps the pad zeros).  All
elementwise solver algebra preserves them, dots are unchanged by the zero
pads, and each stencil apply is one kernel launch over the resident fields.

The AMG transfers cross between the padded fine level and the true-shape
coarse levels: ``PaddedTransfer``'s T and T^T write and read the padded
layout directly, one ``kernels/transfer.py`` launch each on the card (on
the CPU, contractions with aggregation matrices whose pad rows are zero).

The unfused padded V-cycle (``amg/hierarchy.py::vcycle`` on a padded level)
runs on the single-step kernels K10-K16: ``PaddedStar.{residual, rich,
cheb0, cheb, pre2, restrict, prolong}`` and ``PaddedTransfer.{restrict_steps,
prolong_steps}``.  ``PaddedTransfer.{restrict, prolong}`` stay K1 plus torch:
the Galerkin probes and the rho estimate keep that arithmetic.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from tpusparse_torch.kernels.fused7 import (
    fused7_cgmv,
    fused7_cheb,
    fused7_cheb0,
    fused7_mvdot,
    fused7_pre2,
    fused7_prolong,
    fused7_residual,
    fused7_restrict,
    fused7_rich,
)
from tpusparse_torch.kernels.stencil7 import FACE, padded_shape, star7_mv_padded
from tpusparse_torch.kernels.transfer import agg_prolong, agg_restrict
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
    def shape(self) -> tuple[int, int]:
        n = int(np.prod(self.true_shape))
        return (n, n)

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

    def __matmul__(self, x_p: torch.Tensor) -> torch.Tensor:
        return self.mv(x_p)

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

    # --- the single steps of the unfused padded V-cycle (K10-K16) ----------
    @property
    def _legs(self):
        return self.diag, self.cx, self.cy, self.cz

    @property
    def _pin(self):
        return self.true_shape, self.pinned

    def residual(self, x_p, b_p):
        """b - A x (K10)."""
        return fused7_residual(*self._legs, x_p, b_p, *self._pin)

    def rich(self, x_p, b_p, g):
        """x + g D^-1 (b - A x): one Richardson sweep (K11)."""
        return fused7_rich(*self._legs, x_p, b_p, g, *self._pin)

    def cheb0(self, x_p, b_p, g):
        """(x', d') for the first Chebyshev step from x (K12)."""
        return fused7_cheb0(*self._legs, x_p, b_p, g, *self._pin)

    def cheb(self, x_p, b_p, d_p, ad, g):
        """(x', d') for a later Chebyshev step (K13)."""
        return fused7_cheb(*self._legs, x_p, b_p, d_p, ad, g, *self._pin)

    def pre2(self, b_p, s0, ad, g):
        """(x', d') for the first two Chebyshev steps from zero (K14)."""
        return fused7_pre2(*self._legs, b_p, s0, ad, g, *self._pin)

    def restrict(self, r_p, g, flegs=None):
        """r - g A_f (D^-1 r), the P^T smoothing pass (K15)."""
        return fused7_restrict(*self._legs, r_p, g, *self._pin, flegs=flegs)

    def prolong(self, t_p, g, flegs=None):
        """t - g D^-1 (A_f t), the P smoothing pass (K16)."""
        return fused7_prolong(*self._legs, t_p, g, *self._pin, flegs=flegs)


class PaddedTransfer:
    """StructuredTransfer adapter for a padded fine level.  Coarse fields
    stay true-shaped (VarStencil27 levels are unpadded)."""

    def __init__(self, inner):
        self.inner = inner  # StructuredTransfer
        # zero-padded per-axis aggregation matrices (sz, sy, sx): the
        # T-action einsums (the CPU twins) then produce/consume the padded
        # layout directly (the zero rows realize the pads); on the card they
        # give the kernels the layout
        nz, ny, nx = inner.fine_shape
        nzp, nyp, nxp = padded_shape(inner.fine_shape)
        self.mats = (
            F.pad(inner.sz, (0, 0, FACE, nzp - nz - FACE)),
            F.pad(inner.sy, (0, 0, 0, nyp - ny)),
            F.pad(inner.sx, (0, 0, 0, nxp - nx)),
        )

    @property
    def c_shape(self):
        return self.inner.c_shape

    @property
    def omega(self) -> float:
        return self.inner.omega

    @property
    def tnorm(self) -> torch.Tensor:
        return self.inner.tnorm

    @property
    def flegs(self):
        """(cx, cy, cz) of the filtered P-smoothing operator, or None."""
        fop = self.inner.fop
        return None if fop is None else (fop.cx, fop.cy, fop.cz)

    def t_apply_padded(self, e_c: torch.Tensor) -> torch.Tensor:
        """T e_c straight into the padded layout (zero faces/pads)."""
        inner = self.inner
        return agg_prolong(e_c, inner.tnorm, self.mats, inner.factor, inner.fine_shape, FACE)

    def tT_apply_padded(self, s_p: torch.Tensor) -> torch.Tensor:
        """T^T s from a padded field (the card's kernel skips the pads; the
        CPU's einsums contract them against zero rows)."""
        inner = self.inner
        return agg_restrict(s_p, inner.tnorm, self.mats, inner.factor, inner.fine_shape, FACE)

    def prolong(self, fine_op, dinv, e_c):
        if self.inner.fop is not None:
            fine_op = self.inner.fop  # threshold-filtered smoothing operator
        t_p = self.t_apply_padded(e_c)
        return t_p - self.inner.omega * dinv * fine_op.mv(t_p)

    def restrict(self, fine_op, dinv, r_p):
        if self.inner.fop is not None:
            fine_op = self.inner.fop
        s_p = r_p - self.inner.omega * fine_op.mv(dinv * r_p)
        return self.tT_apply_padded(s_p)

    def prolong_steps(self, fine_op: PaddedStar, e_c):
        """P e_c with the smoothing pass on K16: the unfused cycle's."""
        return fine_op.prolong(self.t_apply_padded(e_c), self.omega, self.flegs)

    def restrict_steps(self, fine_op: PaddedStar, r_p):
        """P^T r with the smoothing pass on K15: the unfused cycle's."""
        return self.tT_apply_padded(fine_op.restrict(r_p, self.omega, self.flegs))

"""The level-0 transfer of the z-sharded fine level — port of
``tpusparse/dist/seam.py`` on the port's z mesh.

The JAX package contracts each device's own block of the fine field against
the matching rows of the aggregation matrices, giving a coarse-shaped
partial that is zero outside the block's aggregates, and sums the partials
with one ``psum``.  Prolongation is the transpose: each device builds its
own fine block from the coarse field.  Here every shard lives on one
device, so the partials are summed in shard order (what stands in for the
``psum``), and the fine blocks are concatenated along z.  This keeps the
seam's rounding as the sharded JAX route has it, where the single-device
``StructuredTransfer`` contracts the whole field at once.

``restrict`` and ``prolong`` keep ``StructuredTransfer``'s formulas.
"""

from __future__ import annotations

import dataclasses

import torch

from tpusparse_torch.amg.transfer import StructuredTransfer
from tpusparse_torch.dist.mesh import ZMesh


@dataclasses.dataclass
class ShardedTransfer:
    """A level-0 ``StructuredTransfer`` whose T and T^T contract shard by
    shard over the z mesh."""

    inner: StructuredTransfer
    mesh: ZMesh

    @property
    def c_shape(self):
        return self.inner.c_shape

    @property
    def fine_shape(self):
        return self.inner.fine_shape

    @property
    def omega(self):
        return self.inner.omega

    @property
    def tnorm(self):
        return self.inner.tnorm

    @property
    def fop(self):
        return self.inner.fop

    def _rows(self):
        """The z rows of the aggregation matrix each shard contracts."""
        bz = self.inner.fine_shape[0] // self.mesh.p
        return [slice(i * bz, (i + 1) * bz) for i in range(self.mesh.p)]

    def tT_apply(self, r: torch.Tensor) -> torch.Tensor:
        """T^T r: each shard's block sums into a full coarse-shaped partial,
        and the partials are summed in shard order."""
        tr = self.inner
        total = None
        for rows in self._rows():
            x = torch.einsum("zyx,zc->cyx", r[rows], tr.sz[rows])
            x = torch.einsum("cyx,yd->cdx", x, tr.sy)
            x = torch.einsum("cdx,xe->cde", x, tr.sx)
            total = x if total is None else total + x
        return total * tr.tnorm

    def t_apply(self, e_c: torch.Tensor) -> torch.Tensor:
        """T e_c: each shard builds its own fine block from the coarse
        field."""
        tr = self.inner
        x = e_c * tr.tnorm
        blocks = []
        for rows in self._rows():
            y = torch.einsum("zc,cde->zde", tr.sz[rows], x)
            y = torch.einsum("yd,zde->zye", tr.sy, y)
            blocks.append(torch.einsum("xe,zye->zyx", tr.sx, y))
        return torch.cat(blocks, dim=0)

    def prolong(self, fine_op, dinv: torch.Tensor, e_c: torch.Tensor) -> torch.Tensor:
        """x_f = P e_c = (I - omega D^{-1} A) T e_c."""
        if self.inner.fop is not None:
            fine_op = self.inner.fop
        t = self.t_apply(e_c)
        return t - self.inner.omega * dinv * fine_op.mv(t)

    def restrict(self, fine_op, dinv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """r_c = P^T r = T^T (I - omega A D^{-1}) r   (A symmetric)."""
        if self.inner.fop is not None:
            fine_op = self.inner.fop
        s = r - self.inner.omega * fine_op.mv(dinv * r)
        return self.tT_apply(s)

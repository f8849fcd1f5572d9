"""The level-0 transfer on the (z, y) mesh — port of ``tpusparse/dist/seam.py``.

The JAX package contracts each device's own (z, y) block of the fine field
against the matching rows of the aggregation matrices, giving a
coarse-shaped partial that is zero outside the block's aggregates, and sums
the partials with one ``psum``; prolongation is the transpose, each device
building its own fine block from the replicated coarse field with no
communication.  Here each rank contracts its blocks, sums their partials in
block order, and all-reduces the sum over the ranks (``Mesh.allreduce``:
one coarse-sized all-reduce, n/27 values, at each restriction); it builds
its own blocks of the fine field from the coarse one, which every rank
holds whole.  On one rank the partials are summed in block order, what
stands in for the ``psum``, which keeps the seam's rounding as the sharded
route has it, where the single-device ``StructuredTransfer`` contracts the
whole field at once.

``restrict`` and ``prolong`` keep ``StructuredTransfer``'s formulas; their
fine-grid applies run on the sharded operator (or the sharded filtered
``fop``, ``dist/mesh.py::shard_hierarchy``).
"""

from __future__ import annotations

import dataclasses

import torch

from tpusparse_torch.amg.transfer import StructuredTransfer
from tpusparse_torch.dist.mesh import Mesh


@dataclasses.dataclass
class ShardedTransfer:
    """A level-0 ``StructuredTransfer`` whose T and T^T contract block by
    block over the mesh's blocks of this rank."""

    inner: StructuredTransfer
    mesh: Mesh

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

    def _rows(self, blk):
        """The rows of sz and sy that block ``blk`` contracts."""
        tr = self.inner
        return tr.sz[blk.gz0:blk.gz0 + blk.nz], tr.sy[blk.y0:blk.y0 + blk.ny]

    def tT_apply(self, r: torch.Tensor) -> torch.Tensor:
        """T^T r: each block of the rank's slab ``r`` sums into a full
        coarse-shaped partial; the partials are summed in block order, then
        over the ranks."""
        tr = self.inner
        total = None
        for blk in self.mesh.blocks(tr.fine_shape):
            sz, sy = self._rows(blk)
            x = torch.einsum("zyx,zc->cyx", r[blk.z0:blk.z0 + blk.nz, blk.y0:blk.y0 + blk.ny], sz)
            x = torch.einsum("cyx,yd->cdx", x, sy)
            x = torch.einsum("cdx,xe->cde", x, tr.sx)
            total = x if total is None else total + x
        return self.mesh.allreduce(total) * tr.tnorm

    def t_apply(self, e_c: torch.Tensor) -> torch.Tensor:
        """T e_c: each block of the rank's slab built from the coarse field."""
        tr = self.inner
        x = e_c * tr.tnorm
        out = x.new_empty(self.mesh.local_shape(tr.fine_shape))
        for blk in self.mesh.blocks(tr.fine_shape):
            sz, sy = self._rows(blk)
            y = torch.einsum("zc,cde->zde", sz, x)
            y = torch.einsum("yd,zde->zye", sy, y)
            out[blk.z0:blk.z0 + blk.nz, blk.y0:blk.y0 + blk.ny] = torch.einsum("xe,zye->zyx", tr.sx, y)
        return out

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

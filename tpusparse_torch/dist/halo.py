"""The star apply with an explicit halo exchange — port of
``tpusparse/dist/halo.py`` on the ranks of ``dist/mesh.py``.

PETSc's ``MatMult_MPIAIJ`` posts its neighbour exchanges, computes the
diagonal block from local data, then adds the ghost contributions; the
JAX package writes the same pattern with ``ppermute`` under ``shard_map``
(``halo.py:32-134``).  Here the rank ships its two boundary z-planes to
ranks r +- 1 (``Mesh.exchange``) and then applies the star to its whole
z-slab in one launch of kernel K1h (``kernels/stencil7.py::
star7_mv_halo``), with the two received planes as its z ghosts (None,
a zero face, at the domain boundary and on one rank).  A rank holds
whole z-rows of the mesh's blocks over every y, so its blocks' y
neighbours and the z neighbours between its blocks are in its own slab:
the (z, y) blocks need no launch and no ghost copy of their own.
``block_ghosts`` gives a block its four ghost planes, for driving K1h
block by block as the JAX package's shards apply it.

The pinned origin follows the JAX package exactly (``halo.py:84-96``):
the origin lives at local (0, 0, 0) of rank 0's slab, and is masked out
of x before any neighbour read, including the planes it ships (with a
one-plane slab the origin's plane IS the face sent up); its row keeps
diag x.

Fields of another dtype than f32 (the f64 outer operator, a bf16 level 0)
take the same apply in torch arithmetic (``star7_mv_halo_torch``), K1h's
twin: bit for bit the single-device apply on the global field.
"""

from __future__ import annotations

import dataclasses

import torch

from tpusparse_torch.dist.mesh import Mesh, check_divisible
from tpusparse_torch.kernels.stencil7 import star7_mv_halo, star7_mv_halo_torch
from tpusparse_torch.sparse.stencil import StarStencil3D


@dataclasses.dataclass(eq=False)
class HaloStar:
    """A ``StarStencil3D`` on the mesh: this rank's slab of the diagonal,
    the legs, and the GLOBAL grid shape (``grid_shape``, as the hierarchy
    reports it)."""

    diag: torch.Tensor          # the rank's slab (nz / W, ny, nx)
    cx: float
    cy: float
    cz: float
    pinned: bool
    mesh: Mesh
    shape: tuple[int, int, int]

    @classmethod
    def build(cls, op: StarStencil3D, mesh: Mesh) -> "HaloStar":
        if not isinstance(op, StarStencil3D):
            raise TypeError(f"the halo apply takes a StarStencil3D, not {type(op).__name__}")
        check_divisible(op.grid_shape, mesh)
        return cls(diag=mesh.local(op.diag), cx=op.cx, cy=op.cy, cz=op.cz, pinned=op.pinned, mesh=mesh,
                   shape=tuple(op.grid_shape))

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return self.shape

    @property
    def local_shape(self) -> tuple[int, int, int]:
        return tuple(self.diag.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.diag.dtype

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return halo_mv(self, x, self.mesh)

    def diagonal_field(self) -> torch.Tensor:
        return self.diag

    def gs_color_masks(self) -> list:
        """The red-black colouring of ``StarStencil3D.gs_color_masks`` on
        the rank's slab (global parities)."""
        nz, ny, nx = self.local_shape
        dev = self.diag.device
        k = torch.arange(nz, device=dev)[:, None, None] + self.mesh.rows(self.shape[0]).start
        p = (k + torch.arange(ny, device=dev)[None, :, None] + torch.arange(nx, device=dev)[None, None, :]) % 2
        return [p == 0, p == 1]


def _masked(plane: torch.Tensor) -> torch.Tensor:
    """A copy of a ghost plane holding the origin at its (0, 0), masked."""
    plane = plane.clone()
    plane[0, 0] = 0.0
    return plane


def block_ghosts(x: torch.Tensor, lo, hi, blk, origin_rank: bool):
    """(zlo, zhi, ylo, yhi) of block ``blk`` of the rank's slab ``x``: the
    neighbouring block's planes (copies), the received planes ``lo``/``hi``
    at the rank's z ends, None at the domain boundary.  ``origin_rank``:
    this rank holds the pinned origin (global plane 0, row 0), whose value
    a ghost must not carry."""
    nz_r, ny, _ = x.shape
    ys = slice(blk.y0, blk.y0 + blk.ny)
    zs = slice(blk.z0, blk.z0 + blk.nz)
    if blk.z0 > 0:
        zlo = x[blk.z0 - 1, ys]
        if origin_rank and blk.z0 == 1 and blk.y0 == 0:
            zlo = _masked(zlo)
    else:
        zlo = None if lo is None else lo[ys]
    if blk.z0 + blk.nz < nz_r:
        zhi = x[blk.z0 + blk.nz, ys]
    else:
        zhi = None if hi is None else hi[ys]
    ylo = None
    if blk.y0 > 0:
        ylo = x[zs, blk.y0 - 1].contiguous()
        if origin_rank and blk.z0 == 0 and blk.y0 == 1:
            ylo = _masked(ylo)
    yhi = x[zs, blk.y0 + blk.ny].contiguous() if blk.y0 + blk.ny < ny else None
    return zlo, zhi, ylo, yhi


def halo_mv(op: HaloStar, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """y = A @ x on this rank's slab ``x`` of a field on ``mesh``: the
    boundary planes exchanged with ranks r +- 1, then one K1h launch over
    the slab (f32), or its twin (other dtypes).  Equals ``op.mv`` of the
    global operator on the global field."""
    if tuple(x.shape) != op.local_shape:
        raise ValueError(f"x {tuple(x.shape)}: not this rank's slab {op.local_shape} of {op.shape}")
    x = x.contiguous()
    origin_rank = op.pinned and mesh.rank == 0
    hi_send = x[-1]
    if origin_rank and x.shape[0] == 1:
        hi_send = _masked(hi_send)   # the origin's plane is the face shipped up
    lo, hi = mesh.exchange(x[0], hi_send)
    apply = star7_mv_halo if x.dtype == torch.float32 else star7_mv_halo_torch
    return apply(op.diag, op.cx, op.cy, op.cz, x, lo, hi, None, None, 0 if origin_rank else -1)

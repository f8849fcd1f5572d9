"""The (z, y) mesh of a split solve: ranks, their blocks, their exchanges —
port of ``tpusparse/dist/mesh.py`` on ``torch.distributed``.

The JAX package shards a solve over a ``('z', 'y')`` device mesh as one
GSPMD program: XLA turns the stencil's shifts into halo exchanges and every
dot into a ``psum``.  PyTorch has no GSPMD; its idiom, and PETSc's, is one
process a card that holds its own block, ships boundary planes by
send/recv and all-reduces its dots.  Here a mesh of ``pz x py`` blocks
(``make_mesh`` factors p as JAX's ``_factor2`` does) is spread over the W
ranks of the process group: W divides pz, and rank r holds the blocks of
mesh z-rows [r pz/W, (r + 1) pz/W) over every y.  Its vectors are its own
z-slab (nz/W, ny, nx), whose blocks' neighbours between them are its own
planes (the halo apply reads them in place, ``dist/halo.py``); at its two
z ends ``exchange`` sends and receives planes with ranks r +- 1
(``batch_isend_irecv``); the domain boundary gets zero planes.  W = 1 (no
process group) is one process holding all p blocks, which is how the CPU
tests meet the JAX package's 8 virtual devices; W = p is one block a rank.

``make_z_mesh`` is the py = 1 mesh of the fused z route
(``dist/fused_sharded.py``), whose blocks hold at least FACE planes.

``shard_system`` and ``shard_hierarchy`` place a system and a hierarchy on
the mesh as the JAX package's do (``tpusparse/dist/mesh.py:95-163``): the
level-0 fields become the rank's slabs (the operators ``HaloStar``s,
``dist/halo.py``; the transfer a ``ShardedTransfer``, ``dist/seam.py``),
the coarse levels stay whole on every rank, as built.

Transport (``Transport``, which the block-row mesh of ``dist/general.py``
shares): the backend is the process group's (``dist/multihost.py`` picks
it from where the ranks sit).  Under gloo, planes and partials of CUDA
tensors travel through host copies made here: that is gloo's transport for
them, chosen from the backend, not a fallback.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist

from tpusparse_torch.kernels.stencil7 import FACE
from tpusparse_torch.solve.reduce import reductions

def _factor2(n: int) -> tuple[int, int]:
    """Split n into (pz, py) with pz >= py, as square as possible
    (``tpusparse/dist/mesh.py:33-39``)."""
    best = (n, 1)
    for py in range(1, math.isqrt(n) + 1):
        if n % py == 0:
            best = (n // py, py)
    return best


@dataclasses.dataclass(frozen=True)
class Block:
    """One block of the mesh held by this rank: its first plane ``z0`` in
    the rank's slab (``gz0`` in the grid), its first row ``y0``, and its
    extents."""

    z0: int
    gz0: int
    y0: int
    nz: int
    ny: int


class Transport:
    """The communication of a mesh over the ``world`` ranks of ``group``
    (None: one rank, this process), for a mesh dataclass with the fields
    ``group``, ``world`` and ``rank``: point-to-point pieces, all-reduce,
    all-gather and barrier.  Under gloo a CUDA tensor is staged through a
    host copy (``_staged``)."""

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)

    def _staged(self, t: torch.Tensor) -> bool:
        return t.device.type == "cuda" and self.backend == "gloo"

    def sendrecv(self, sends, recvs, like: torch.Tensor) -> list:
        """Ship each ``(peer, tensor)`` of ``sends`` and receive each
        ``(peer, numel)`` of ``recvs`` (vectors of ``like``'s dtype), all
        posted together: the received vectors on ``like``'s device, in
        ``recvs``' order.  A pair of ranks exchanges at most one message
        each way in a call."""
        staged = self._staged(like)
        ops, out = [], []
        for peer, t in sends:
            t = (t.cpu() if staged else t).contiguous()
            ops.append(dist.P2POp(dist.isend, t, peer, self.group))
        for peer, numel in recvs:
            buf = torch.empty(numel, dtype=like.dtype, device="cpu" if staged else like.device)
            ops.append(dist.P2POp(dist.irecv, buf, peer, self.group))
            out.append(buf)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [t.to(like.device) for t in out] if staged else out

    def allreduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (or maxed) over the ranks: reduced in place and
        returned, or ``t`` itself on one rank."""
        if self.group is None:
            return t
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host, rop, group=self.group)
            return t.copy_(host)
        dist.all_reduce(t, rop, group=self.group)
        return t

    def allgather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` (one length on every rank) concatenated in rank
        order along the first axis, or ``t`` itself on one rank."""
        if self.group is None:
            return t
        staged = self._staged(t)
        src = (t.cpu() if staged else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts)
        return out.to(t.device) if staged else out

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh(Transport):
    """``pz x py`` blocks over the ``world`` ranks of ``group`` (None: one
    rank, this process), each rank's fields on ``device``.  ``halo``: the
    least planes a block holds in z (FACE on the fused z route, whose
    kernels read FACE planes of each neighbour)."""

    pz: int
    py: int
    device: torch.device
    halo: int = 1
    group: object = None
    world: int = 1
    rank: int = 0

    @property
    def p(self) -> int:
        return self.pz * self.py

    # --- placement ------------------------------------------------------------
    def rows(self, nz: int) -> slice:
        """The grid planes this rank holds."""
        nz_r = nz // self.world
        return slice(self.rank * nz_r, (self.rank + 1) * nz_r)

    def local_shape(self, shape) -> tuple[int, int, int]:
        """The rank's slab of a (nz, ny, nx) field."""
        nz, ny, nx = shape
        return (nz // self.world, ny, nx)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's slab of the global field ``x``: ``x`` itself on one
        rank, a copy of its planes otherwise (so the whole can be freed)."""
        if self.world == 1:
            return x
        return x[self.rows(x.shape[0])].clone()

    def blocks(self, shape) -> list[Block]:
        """This rank's blocks of a ``shape`` field, z-row by z-row."""
        nz, ny, _ = shape
        bz, by = nz // self.pz, ny // self.py
        rows = self.pz // self.world
        first = self.rank * rows * bz
        return [
            Block(z0=iz * bz, gz0=first + iz * bz, y0=iy * by, nz=bz, ny=by)
            for iz in range(rows) for iy in range(self.py)
        ]

    # --- communication --------------------------------------------------------
    def exchange(self, lo_send: torch.Tensor, hi_send: torch.Tensor):
        """``(lo, hi)``: the planes of ranks r - 1 and r + 1 that face this
        rank, for ``lo_send`` and ``hi_send`` shipped to them (None at the
        domain boundary, and on one rank)."""
        if self.group is None:
            return None, None
        peers = [(peer, send) for peer, send in ((self.rank - 1, lo_send), (self.rank + 1, hi_send))
                 if 0 <= peer < self.world]
        got = iter(self.sendrecv(peers, [(peer, send.numel()) for peer, send in peers], lo_send))
        lo = next(got).view(lo_send.shape) if self.rank > 0 else None
        hi = next(got).view(hi_send.shape) if self.rank + 1 < self.world else None
        return lo, hi

    def reductions(self, shape):
        """The context of a solve on this rank's slabs of a ``shape`` field:
        its global reductions over the ranks (``solve/reduce.py``)."""
        if self.group is None:
            return contextlib.nullcontext()
        return reductions(_Comm(self, self.rows(shape[0]).start * shape[1] * shape[2]))


@dataclasses.dataclass(frozen=True)
class _Comm:
    mesh: Mesh
    offset: int

    def allreduce(self, t, op):
        return self.mesh.allreduce(t, op)


def process_group():
    """(group, world, rank) of the default process group, or (None, 1, 0)
    without one or with one rank."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return None, 1, 0
    return dist.group.WORLD, dist.get_world_size(), dist.get_rank()


def make_mesh(n_devices: int, shape: tuple[int, int] | None = None, device="cuda", *, halo: int = 1) -> Mesh:
    """A (z, y) mesh of ``n_devices`` blocks (``shape`` = (pz, py), or
    ``_factor2``'s) over the ranks of the default process group, this
    rank's fields on ``device``.  W ranks must divide pz."""
    if isinstance(device, (list, tuple)):
        raise ValueError(
            "a mesh takes this rank's one device: its ranks come from the torch.distributed process group"
            " (dist/multihost.py), one block row or more a rank"
        )
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one block, got {n_devices}")
    pz, py = shape if shape is not None else _factor2(n_devices)
    if pz * py != n_devices:
        raise ValueError(f"mesh shape {(pz, py)} != {n_devices} devices")
    group, world, rank = process_group()
    if pz % world:
        raise ValueError(
            f"{world} ranks do not divide the mesh's {pz} z-rows: each rank holds whole z-rows of blocks"
            f" (mesh {(pz, py)})"
        )
    return Mesh(pz=pz, py=py, device=torch.device(device), halo=halo, group=group, world=world, rank=rank)


def make_z_mesh(n_shards: int, device="cuda") -> Mesh:
    """The 1-D z mesh of ``n_shards`` z-slabs of at least FACE planes (the
    fused z route), over the ranks of the default process group."""
    return make_mesh(n_shards, (n_shards, 1), device, halo=FACE)


def check_divisible(field_shape, mesh: Mesh) -> None:
    """DMDA-style validation (``tpusparse/dist/mesh.py:71-80``): nz and ny
    must divide into the mesh's blocks, and each block must hold at least
    ``mesh.halo`` planes, the depth of the halo its neighbours read."""
    nz, ny = field_shape[0], field_shape[1]
    pz, py = mesh.pz, mesh.py
    if nz % pz or ny % py:
        raise ValueError(
            f"grid (nz={nz}, ny={ny}) not divisible by mesh (z={pz}, y={py});"
            f" choose a mesh shape that divides the grid, e.g."
            f" make_mesh(shape=(pz, py)) with nz % pz == ny % py == 0"
        )
    if nz // pz < mesh.halo:
        raise ValueError(
            f"{pz} z-shards of nz={nz} hold {nz // pz} planes each, fewer"
            f" than the {mesh.halo} halo planes a neighbour reads"
        )


def shard_system(op, b: torch.Tensor, exact: torch.Tensor, mesh: Mesh):
    """``(op, b, exact)`` on the mesh: the star as this rank's ``HaloStar``,
    the vectors as its slabs (``tpusparse/dist/mesh.py:95-103``)."""
    from tpusparse_torch.dist.halo import HaloStar

    check_divisible(b.shape, mesh)
    return HaloStar.build(op, mesh), mesh.local(b), mesh.local(exact)


def shard_hierarchy(hier, mesh: Mesh):
    """Level 0 on the mesh, the coarse levels whole on every rank
    (``tpusparse/dist/mesh.py:106-163``): its operator a ``HaloStar``, dinv
    the rank's slab, its transfer a ``ShardedTransfer`` whose filtered P
    smoother (``fop``, a fine-grid operator) is sharded like the operator.

    Level 0 is rebuilt from op, dinv, rho and transfer, as the JAX package
    rebuilds it: its block-Jacobi sub-PC (``bjac``) is dropped, so level 0
    smooths with point Jacobi under the bounds of rho(M_block^-1 A), what
    JAX's ``-devices p -pc_bjacobi_bs`` runs (ROADMAP §3)."""
    from tpusparse_torch.amg.hierarchy import Level
    from tpusparse_torch.dist.halo import HaloStar
    from tpusparse_torch.dist.seam import ShardedTransfer

    lev0 = hier.levels[0]
    check_divisible(lev0.dinv.shape, mesh)
    if lev0.transfer is None:
        raise ValueError("a one-level hierarchy has no sharded form: its level 0 is the coarse solve")
    tr = lev0.transfer
    if tr.fop is not None:
        tr = dataclasses.replace(tr, fop=HaloStar.build(tr.fop, mesh))
    new0 = Level(
        op=HaloStar.build(lev0.op, mesh), dinv=mesh.local(lev0.dinv), rho=lev0.rho,
        transfer=ShardedTransfer(tr, mesh),
    )
    return dataclasses.replace(hier, levels=[new0, *hier.levels[1:]])

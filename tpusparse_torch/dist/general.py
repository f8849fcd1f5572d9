"""The block-row executor for general matrices — port of
``tpusparse/dist/general.py``, PETSc's MPIAIJ on ``torch.distributed``.

PETSc's MPIAIJ is a block-row partition: each rank holds its rows, and the
off-block columns that its rows read arrive by a VecScatter planned at
setup before the off-block multiply (``MatMult_MPIAIJ``).  The JAX package
writes the same over a 1-D ``("rows",)`` device mesh: a DIA matrix's band
columns split by rows, the windows of x a shard reads beyond its rows
assembled by ``ppermute`` chains (multi-hop where the bands reach past one
shard), the dots reduced by GSPMD.

Here a row mesh of p blocks (``make_row_mesh``) is spread over the W ranks
of the process group: W divides p, and rank r holds the contiguous rows
[r n/W, (r + 1) n/W) of every sharded level.  W = 1 (no process group) is
one process holding all p blocks, which is how the CPU tests meet the JAX
package's 8 virtual devices.

- ``DistDIA.mv`` is two steps.  The window exchange (``window_plan``, PETSc's
  VecScatter plan): each rank sends only the entries that a peer's bands
  reach, straight from the rank that owns them however far the bands
  reach, and they arrive as that peer's low and high windows.  Then ONE
  launch of kernel K5h a rank over its rows (``kernels/diaband.py::
  dia_mv_window``), which reads its x and its two windows in place: the
  rows of every rank's launch together are bit for bit one K5 launch on
  the whole vector.  On W = 1 the windows are empty.
- ``DistHybridDIA``: the bands as a ``DistDIA``, the ELL remainder's rows
  against the all-gathered x.
- ``shard_unstructured_hierarchy`` places an unstructured AMG hierarchy as
  the JAX package does: level 0 and every level whose rows divide the mesh
  with at least ``min_shard_rows`` a block become ``DistDIA`` /
  ``DistHybridDIA`` with the rank's rows of dinv; the tail stays whole on
  every rank.  The transfers of a sharded level communicate explicitly
  where GSPMD hid it: the restriction sums the rank's own fine rows into a
  coarse vector, all-reduces it and keeps the coarse rows where the coarse
  level is sharded; the prolongation all-gathers a sharded coarse vector
  and applies T to the rank's rows.  A geometric transfer works on the fine
  planes that the rank's rows touch (its rows may cut a plane, or a row of
  one), a factored one on member tables built once per rank.

``hierarchy.vcycle`` runs the sharded hierarchy unchanged, and the Krylov
methods of ``solve/`` run on it inside ``RowMesh.reductions``.  Under gloo
the windows and partials of CUDA tensors travel through host copies
(``dist/mesh.py::Transport``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from tpusparse_torch.dist.mesh import Transport, _Comm, process_group
from tpusparse_torch.kernels.diaband import dia_mv_window, dia_mv_window_torch
from tpusparse_torch.solve.reduce import reductions
from tpusparse_torch.sparse.dia import DIA, HybridDIA
from tpusparse_torch.sparse.ell import ELL


@dataclasses.dataclass(frozen=True, eq=False)
class RowMesh(Transport):
    """``p`` blocks of rows over the ``world`` ranks of ``group`` (None: one
    rank, this process), each rank's rows on ``device``."""

    p: int
    device: torch.device
    group: object = None
    world: int = 1
    rank: int = 0

    def rows(self, n: int) -> slice:
        """The rows of an n-row level that this rank holds."""
        nl = n // self.world
        return slice(self.rank * nl, (self.rank + 1) * nl)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's rows of ``t`` along its last axis (a vector, a band
        stack (K, n), an ELL array (w, n)): ``t`` itself on one rank, a copy
        otherwise (so the whole can be freed)."""
        if self.world == 1:
            return t
        return t[..., self.rows(t.shape[-1])].clone(memory_format=torch.contiguous_format)

    def reductions(self, n: int):
        """The context of a solve on this rank's rows of n-row vectors: its
        global reductions over the ranks (``solve/reduce.py``), the rank's
        first row as the offset."""
        if self.group is None:
            return contextlib.nullcontext()
        return reductions(_Comm(self, self.rows(n).start))


def make_row_mesh(n_devices: int | None = None, device="cuda") -> RowMesh:
    """The 1-D row mesh of ``n_devices`` blocks (default: one a rank) over
    the ranks of the default process group, this rank's rows on
    ``device``.  The W ranks must divide the blocks."""
    group, world, rank = process_group()
    n_devices = world if n_devices is None else n_devices
    if n_devices < 1:
        raise ValueError(f"a row mesh needs at least one block, got {n_devices}")
    if n_devices % world:
        raise ValueError(f"{world} ranks do not divide the row mesh's {n_devices} blocks: each rank holds whole blocks")
    return RowMesh(p=n_devices, device=torch.device(device), group=group, world=world, rank=rank)


def shard_vector(x: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """The rank's rows of a global vector."""
    return mesh.local(x)


# --- the window exchange ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """One rank's part of the window exchange of an n-row level: ``sends``
    (peer, lo, hi), its own local rows [lo, hi) that the peer's bands
    reach; ``recvs`` (peer, side, lo, hi), the global rows [lo, hi) that
    arrive from the peer into the low ("lo") or high ("hi") window, in
    row order; ``hl``/``hh`` the windows' lengths."""

    sends: tuple
    recvs: tuple
    hl: int
    hh: int


def _pieces(a: int, b: int, nl: int) -> list:
    """The global rows [a, b) cut by owner: (owner, lo, hi)."""
    out = []
    while a < b:
        q = a // nl
        e = min(b, (q + 1) * nl)
        out.append((q, a, e))
        a = e
    return out


def window_plan(n: int, world: int, rank: int, halo: int) -> WindowPlan:
    """The window exchange of ``rank`` on an n-row level split in ``world``
    equal row blocks, whose bands reach ``halo`` rows: each window holds
    the ``halo`` rows next to the rank's own (fewer at the domain ends),
    each piece sent straight from the rank that owns it (PETSc's
    VecScatter plan; the JAX package chains ``ppermute`` hops instead)."""
    nl = n // world

    def windows(r):
        r0 = r * nl
        return {"lo": (max(0, r0 - halo), r0), "hi": (r0 + nl, min(n, r0 + nl + halo))}

    mine = windows(rank)
    recvs = tuple((q, side, lo, hi) for side in ("lo", "hi") for q, lo, hi in _pieces(*mine[side], nl))
    r0 = rank * nl
    sends = tuple(
        (q, lo - r0, hi - r0)
        for q in range(world) if q != rank
        for side in ("lo", "hi")
        for owner, lo, hi in _pieces(*windows(q)[side], nl) if owner == rank
    )
    (a, b), (c, d) = mine["lo"], mine["hi"]
    return WindowPlan(sends=sends, recvs=recvs, hl=b - a, hh=d - c)


def dia_halo(offsets) -> int:
    """The window half-width of bands at ``offsets``: max |offset| rounded
    up to 8, at least 8 (the JAX package's ``halo``)."""
    reach = max((abs(o) for o in offsets), default=0)
    return max(8, -(-reach // 8) * 8)


@dataclasses.dataclass(eq=False)
class DistDIA:
    """A block-row-sharded square DIA matrix: this rank's band columns
    ``bands`` (K, nl), the GLOBAL ``shape``, the window half-width
    ``halo`` and the rank's window plan."""

    bands: torch.Tensor
    offsets: tuple[int, ...]
    shape: tuple[int, int]
    halo: int
    mesh: RowMesh
    plan: WindowPlan

    @classmethod
    def shard(cls, a: DIA, mesh: RowMesh) -> "DistDIA":
        """Partition a square DIA over ``mesh`` (the JAX package's checks)."""
        n = a.n_rows
        p = mesh.p
        if a.shape[0] != a.shape[1]:
            raise ValueError("DistDIA shards square operators")
        if n % p:
            raise ValueError(
                f"n={n} rows not divisible by {p} shards; pad the system or"
                f" choose a divisor device count (DMDA-style validation)"
            )
        reach = max((abs(o) for o in a.offsets), default=0)
        if reach >= n:
            raise ValueError(f"max |offset| {reach} >= n={n}: not a banded operator")
        halo = dia_halo(a.offsets)
        return cls(
            bands=mesh.local(a.bands), offsets=tuple(a.offsets), shape=tuple(a.shape), halo=halo, mesh=mesh,
            plan=window_plan(n, mesh.world, mesh.rank, halo),
        )

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.bands.dtype

    def diagonal(self) -> torch.Tensor:
        """The rank's rows of the diagonal."""
        if 0 in self.offsets:
            return self.bands[self.offsets.index(0)]
        return torch.zeros(self.bands.shape[1], dtype=self.dtype, device=self.bands.device)

    def windows(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(xlo, xhi): the entries of x below and above the rank's rows that
        its bands reach, received from the ranks that own them while this
        rank sends what its peers read (empty on one rank)."""
        if self.mesh.group is None:
            empty = x.new_empty(0)
            return empty, empty
        plan = self.plan
        got = self.mesh.sendrecv([(q, x[lo:hi]) for q, lo, hi in plan.sends],
                                 [(q, hi - lo) for q, _, lo, hi in plan.recvs], x)
        out = []
        for side in ("lo", "hi"):
            parts = [g for g, r in zip(got, plan.recvs) if r[1] == side]
            out.append(x.new_empty(0) if not parts else parts[0] if len(parts) == 1 else torch.cat(parts))
        return out[0], out[1]

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x on the rank's rows (MatMult_MPIAIJ): the window
        exchange, then one K5h launch over the rows (f32), or its twin
        (other dtypes)."""
        nl = self.bands.shape[1]
        if tuple(x.shape) != (nl,):
            raise ValueError(f"x {tuple(x.shape)}: not this rank's {nl} rows of {self.n_rows}")
        x = x.contiguous()
        xlo, xhi = self.windows(x)
        apply = dia_mv_window if self.dtype == torch.float32 else dia_mv_window_torch
        return apply(self.bands, x, self.offsets, xlo, xhi, self.mesh.rows(self.n_rows).start, self.n_rows)

    def __matmul__(self, x):
        return self.mv(x)


def _shard_ell_rows(ell: ELL, mesh: RowMesh) -> ELL:
    """The rank's rows of an ELL (width-major (w, n_rows) arrays: the row
    axis is the last), its columns global."""
    if mesh.world == 1:
        return ell
    return ELL(cols=mesh.local(ell.cols), vals=mesh.local(ell.vals),
               shape=(ell.shape[0] // mesh.world, ell.shape[1]))


@dataclasses.dataclass(eq=False)
class DistHybridDIA:
    """Block-row HybridDIA: the bands through the ``DistDIA`` window
    exchange, the thin ELL remainder's rows (``rem``, global columns)
    against the all-gathered x.  Remainder levels are small coarse
    operators, so the all-gather is cheap."""

    dia: DistDIA
    rem: ELL

    @property
    def shape(self):
        return self.dia.shape

    @property
    def n_rows(self):
        return self.dia.n_rows

    @property
    def dtype(self):
        return self.dia.dtype

    def diagonal(self):
        return self.dia.diagonal()

    def mv(self, x):
        return self.dia.mv(x) + self.rem.mv(self.dia.mesh.allgather(x))

    def __matmul__(self, x):
        return self.mv(x)


# --- the transfers of a sharded level ----------------------------------------------

def _coarse_out(mesh: RowMesh, part: torch.Tensor, coarse_rows: bool) -> torch.Tensor:
    """The restriction's coarse vector from this rank's partial sums
    ``part`` (every coarse entry): summed over the ranks, then the rank's
    rows where the coarse level is sharded."""
    full = mesh.allreduce(part)
    return mesh.local(full) if coarse_rows else full


def local_member_table(members: torch.Tensor, r0: int, nl: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(table, touched): the member table (``amg/unstructured.py::
    member_table``) of the aggregates with a member in rows [r0, r0 + nl),
    ``touched`` their coarse ids, each member as a local row and every
    member outside the rows (and the padding) as ``nl``, the slot of an
    appended zero."""
    mine = (members >= r0) & (members < r0 + nl)
    touched = torch.nonzero(mine.any(dim=1)).flatten()
    table = torch.where(mine, members - r0, torch.full_like(members, nl))[touched]
    return table, touched


@dataclasses.dataclass(eq=False)
class RowFactoredTransfer:
    """``FactoredTransfer`` on a sharded fine level: the rank's rows of agg
    and w, its member table (``local_member_table``), and whether the
    coarse level is sharded (``coarse_rows``)."""

    agg: torch.Tensor
    w: torch.Tensor
    omega: float
    members: torch.Tensor
    touched: torch.Tensor
    n_coarse: int
    nsmooths: int
    mesh: RowMesh
    coarse_rows: bool

    @classmethod
    def build(cls, tr, mesh: RowMesh, coarse_rows: bool) -> "RowFactoredTransfer":
        n = tr.agg.shape[0]
        rows = mesh.rows(n)
        members, touched = local_member_table(tr.members, rows.start, rows.stop - rows.start)
        return cls(agg=mesh.local(tr.agg), w=mesh.local(tr.w), omega=tr.omega, members=members, touched=touched,
                   n_coarse=tr.n_coarse, nsmooths=tr.nsmooths, mesh=mesh, coarse_rows=coarse_rows)

    def prolong(self, fine_op, dinv, e_c):
        e = self.mesh.allgather(e_c) if self.coarse_rows else e_c
        t = self.w * e[self.agg]
        for _ in range(self.nsmooths):
            t = t - self.omega * (dinv * fine_op.mv(t))
        return t

    def restrict(self, fine_op, dinv, x):
        s = x
        for _ in range(self.nsmooths):
            s = s - self.omega * fine_op.mv(dinv * s)
        v = self.w * s
        v = torch.cat([v, v.new_zeros(1)])
        part = v[self.members].sum(dim=-1)
        if part.numel() != self.n_coarse:  # aggregates with no member here
            part = part.new_zeros(self.n_coarse).index_copy_(0, self.touched, part)
        return _coarse_out(self.mesh, part, self.coarse_rows)


@dataclasses.dataclass(frozen=True)
class GeoRows:
    """The fine planes [z0, z1) that a rank's rows [r0, r0 + nl) touch, the
    coarse planes [c0, c1) those belong to, and ``offset`` = r0 - z0 ny nx,
    where the rows start in the planes."""

    z0: int
    z1: int
    c0: int
    c1: int
    offset: int
    nl: int


def geo_rows(fine_shape, bs, world: int, rank: int) -> GeoRows:
    """``GeoRows`` of ``rank`` of ``world`` equal row blocks of a
    ``fine_shape`` grid aggregated in ``bs`` blocks."""
    nz, ny, nx = fine_shape
    q = ny * nx
    nl = nz * q // world
    r0 = rank * nl
    z0, z1 = r0 // q, -(-(r0 + nl) // q)
    return GeoRows(z0=z0, z1=z1, c0=z0 // bs[0], c1=-(-z1 // bs[0]), offset=r0 - z0 * q, nl=nl)


@dataclasses.dataclass(eq=False)
class RowGeoTransfer:
    """``GeoTransfer`` on a sharded fine level: the rank's rows of w and
    the rows of sz that its fine planes take (``geo_rows``), sy and sx
    whole; T and T^T act on the touched planes only, the rank's rows in
    them, other ranks' rows zero."""

    w: torch.Tensor
    omega: float
    sz: torch.Tensor
    sy: torch.Tensor
    sx: torch.Tensor
    fine_shape: tuple[int, int, int]
    coarse_shape: tuple[int, int, int]
    rows: GeoRows
    mesh: RowMesh
    coarse_rows: bool

    @classmethod
    def build(cls, tr, mesh: RowMesh, coarse_rows: bool) -> "RowGeoTransfer":
        g = geo_rows(tr.fine_shape, tr.bs, mesh.world, mesh.rank)
        return cls(w=mesh.local(tr.w), omega=tr.omega, sz=tr.sz[g.z0:g.z1, g.c0:g.c1], sy=tr.sy, sx=tr.sx,
                   fine_shape=tuple(tr.fine_shape), coarse_shape=tuple(tr.coarse_shape), rows=g, mesh=mesh,
                   coarse_rows=coarse_rows)

    @property
    def _plane(self) -> int:
        return self.fine_shape[1] * self.fine_shape[2]

    @property
    def _cplane(self) -> int:
        return self.coarse_shape[1] * self.coarse_shape[2]

    def prolong(self, fine_op, dinv, e_c):
        from tpusparse_torch.amg.geo import _up

        g = self.rows
        e = self.mesh.allgather(e_c) if self.coarse_rows else e_c
        t = _up(self.sz, self.sy, self.sx, e[g.c0 * self._cplane:g.c1 * self._cplane])
        t = self.w * t[g.offset:g.offset + g.nl]
        return t - self.omega * (dinv * fine_op.mv(t))

    def restrict(self, fine_op, dinv, x):
        from tpusparse_torch.amg.geo import _down

        g = self.rows
        v = self.w * (x - self.omega * fine_op.mv(dinv * x))
        span = (g.z1 - g.z0) * self._plane
        if g.offset or g.nl != span:
            # the rank's rows cut a plane: the planes they touch, others' rows 0
            buf = v.new_zeros(span)
            buf[g.offset:g.offset + g.nl] = v
            v = buf
        part = _down(self.sz, self.sy, self.sx, v.reshape(g.z1 - g.z0, *self.fine_shape[1:]))
        a, n_coarse = g.c0 * self._cplane, self.coarse_shape[0] * self._cplane
        if a or part.numel() != n_coarse:
            full = part.new_zeros(n_coarse)
            full[a:a + part.numel()] = part
            part = full
        return _coarse_out(self.mesh, part, self.coarse_rows)


@dataclasses.dataclass(eq=False)
class CoarseRowsTransfer:
    """The transfer of a level kept whole whose coarse level is sharded:
    the restriction's rows of the rank, the prolongation from the
    all-gathered coarse vector."""

    inner: object
    mesh: RowMesh

    def prolong(self, fine_op, dinv, e_c):
        return self.inner.prolong(fine_op, dinv, self.mesh.allgather(e_c))

    def restrict(self, fine_op, dinv, x):
        return self.mesh.local(self.inner.restrict(fine_op, dinv, x))


@dataclasses.dataclass(eq=False)
class RowBlockJacobi:
    """A level's block-Jacobi sub-PC on a sharded level: the whole apply on
    the all-gathered residual, the rank's rows of it (blocks may straddle
    ranks; the JAX package applies it to the global vector)."""

    inner: object
    mesh: RowMesh

    @property
    def bs(self) -> int:
        return self.inner.bs

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self.mesh.local(self.inner.apply(self.mesh.allgather(r)))


@dataclasses.dataclass(eq=False)
class RowCoarseInverse:
    """The dense coarse inverse of a sharded coarsest level: the rank's rows
    of the inverse against the all-gathered right-hand side
    (``hierarchy._coarse_direct`` calls ``apply``)."""

    rows: torch.Tensor
    mesh: RowMesh

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        full = self.mesh.allgather(b)
        return (self.rows @ full.to(self.rows.dtype)).to(b.dtype)


# --- the hierarchy ---------------------------------------------------------------------

def shard_unstructured_hierarchy(hier, mesh: RowMesh, min_shard_rows: int = 4096):
    """MPIAIJ-style placement of an unstructured AMG hierarchy (the JAX
    package's ``shard_unstructured_hierarchy``): level 0 and every DIA /
    HybridDIA / GridDIA level whose rows divide the mesh with at least
    ``min_shard_rows`` a block are block-row-sharded (``DistDIA`` /
    ``DistHybridDIA``, a GridDIA through its flat view), with the rank's
    rows of dinv and the sharded transfers; the tail stays whole on every
    rank (below that size a collective costs more than the redundant
    compute: PETSc's GAMG telescopes onto fewer ranks).  rho and the
    damping are Python floats, the same on every rank."""
    from tpusparse_torch.amg.geo import GeoTransfer
    from tpusparse_torch.amg.unstructured import FactoredTransfer
    from tpusparse_torch.sparse.griddia import GridDIA

    lev0 = hier.levels[0]
    if not isinstance(lev0.op, (DIA, GridDIA)):
        raise ValueError(
            "shard_unstructured_hierarchy needs DIA level-0 operators"
            " (gamg_setup_unstructured(device_format='dia'))"
        )
    if not isinstance(lev0.transfer, (FactoredTransfer, GeoTransfer)):
        raise ValueError("needs transfer_format='factored' or the geometric transfer")
    p = mesh.p

    def shardable(op):
        n = op.shape[0]
        return n % p == 0 and n // p >= min_shard_rows

    def shard_op(op):
        if isinstance(op, GridDIA):
            op = op.to_dia()  # the block-row exchange runs on the flat view
        if isinstance(op, DIA):
            return DistDIA.shard(op, mesh)
        if op.rem is None:
            return DistDIA.shard(op.dia, mesh)
        return DistHybridDIA(dia=DistDIA.shard(op.dia, mesh), rem=_shard_ell_rows(op.rem, mesh))

    def shard_transfer(tr, coarse_rows):
        if tr is None:
            return None
        if isinstance(tr, FactoredTransfer):
            return RowFactoredTransfer.build(tr, mesh, coarse_rows)
        if isinstance(tr, GeoTransfer):
            return RowGeoTransfer.build(tr, mesh, coarse_rows)
        raise ValueError("needs transfer_format='factored' or the geometric transfer")

    levels = hier.levels
    sharded = [(i == 0 or shardable(lev.op)) and isinstance(lev.op, (DIA, HybridDIA, GridDIA))
               for i, lev in enumerate(levels)]
    new_levels = []
    for i, lev in enumerate(levels):
        coarse_rows = i + 1 < len(levels) and sharded[i + 1]
        if sharded[i]:
            n = lev.op.shape[0]
            new_levels.append(dataclasses.replace(
                lev, op=shard_op(lev.op), dinv=mesh.local(lev.dinv), transfer=shard_transfer(lev.transfer, coarse_rows),
                bjac=None if lev.bjac is None else RowBlockJacobi(lev.bjac, mesh),
                coarse_inv=None if lev.coarse_inv is None else RowCoarseInverse(lev.coarse_inv[mesh.rows(n)], mesh),
            ))
        elif coarse_rows:
            new_levels.append(dataclasses.replace(lev, transfer=CoarseRowsTransfer(lev.transfer, mesh)))
        else:
            new_levels.append(lev)
    return dataclasses.replace(hier, levels=new_levels)


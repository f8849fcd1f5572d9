"""The z-sharded fused fine level — port of ``tpusparse/dist/fused_sharded.py``
on the ranks of ``dist/mesh.py``.

The JAX package runs the fused fine-level kernels once per z-shard under
``shard_map``: fields live in the stacked layout ``(p, nz_l + 2 FACE, ny,
nxp)`` (each shard's z-slab with its own FACE halo planes, zero between
launches), the halo planes of the operands a launch reads are refreshed
just before it, and the kernels mask in global z (``fused7_call``'s ``z0``,
``nzg``).  Here the p shards are spread over the W ranks of the z mesh
(``make_z_mesh``): a rank holds p/W consecutive shards stacked, ``(p/W,
nz_l + 2 FACE, ny, nxp)``; the exchange copies planes between its own
slabs and sends and receives FACE planes with ranks r +- 1, and one launch
a stroke runs K3z or K4z over the rank's slabs
(``kernels/fused7.py::fused7_descent_slab`` / ``fused7_ascent_slab``),
placed at the rank's first global plane.

The coarse hierarchy stays whole on every rank (the plain
``hierarchy.vcycle`` from level 1 down); the Krylov vectors are the
rank's z-slabs.  ``vcycle_fused_sharded`` stitches the two per cycle:
stack -> K3z over the rank's shards -> unstack -> T^T (``dist/seam.py``,
all-reduced) -> coarse cycle -> T -> stack -> K4z -> unstack.

Not ported: ``preflight_sharded``, Mosaic's slab-depth check (ROADMAP, Not
to port).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tpusparse_torch.amg.fused_cycle import _fine_scalars
from tpusparse_torch.amg.hierarchy import AMGParams, Hierarchy, coarse_cycle, plain_cycle_only
from tpusparse_torch.amg.transfer import StructuredTransfer
from tpusparse_torch.dist.mesh import Mesh, check_divisible
from tpusparse_torch.dist.seam import ShardedTransfer
from tpusparse_torch.kernels.fused7 import fused7_ascent_slab, fused7_descent_slab
from tpusparse_torch.kernels.stencil7 import FACE, padded_shape
from tpusparse_torch.sparse.stencil import StarStencil3D
from tpusparse_torch.utils.profiling import annotate


@dataclasses.dataclass
class FusedSharded:
    """The fine level's fused kernels over a z mesh.

    ``diag_st`` is the diagonal in the stacked layout with its halo planes
    already refreshed (it never changes, so it is exchanged once, at build)
    and every remaining zero (x pads, the global z faces) set to 1.0, so
    that 1 / diag is finite wherever the kernels evaluate it.
    """

    diag_st: torch.Tensor          # (p / W, nz_l + 2 FACE, ny, nxp)
    cx: float
    cy: float
    cz: float
    shape: tuple[int, int, int]    # the GLOBAL (nz, ny, nx)
    pinned: bool
    mesh: Mesh

    @property
    def p(self) -> int:
        return self.mesh.p

    @property
    def nz_l(self) -> int:
        return self.shape[0] // self.p

    @property
    def q(self) -> int:
        """The shards this rank holds."""
        return self.p // self.mesh.world

    @property
    def local_shape(self) -> tuple[int, int, int]:
        return (self.nz_l, self.shape[1], self.shape[2])

    @classmethod
    def build(cls, op: StarStencil3D, mesh: Mesh) -> "FusedSharded":
        """From the f32 plain operator (the whole grid's, as every rank
        holds it): this rank's diagonal stacked, its halos refreshed once,
        then its zeros set to 1.0 (``fused_sharded.py:97-125``).  A
        collective: every rank builds together."""
        if op.dtype != torch.float32:
            raise TypeError(f"the fused kernels take a float32 operator, not {op.dtype}")
        check_divisible(op.grid_shape, mesh)
        fs = cls(
            diag_st=op.diag.new_zeros(()), cx=op.cx, cy=op.cy, cz=op.cz,
            shape=tuple(op.grid_shape), pinned=op.pinned, mesh=mesh,
        )
        diag_st = fs.exchange_(fs.to_stacked(mesh.local(op.diag)))
        fs.diag_st = torch.where(diag_st == 0, torch.ones((), dtype=diag_st.dtype, device=diag_st.device), diag_st)
        return fs

    # --- layout -----------------------------------------------------------
    def to_stacked(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's slab (nz / W, ny, nx) -> the stacked layout, halo
        planes and pads zero."""
        _, ny, nx = self.shape
        nxp = padded_shape(self.shape)[2]
        x4 = x.reshape(self.q, self.nz_l, ny, nx)
        return F.pad(x4, (0, nxp - nx, 0, 0, FACE, FACE))

    def from_stacked(self, x_st: torch.Tensor) -> torch.Tensor:
        """The stacked layout -> the rank's slab (nz / W, ny, nx)."""
        _, ny, nx = self.shape
        return x_st[:, FACE:FACE + self.nz_l, :, :nx].reshape(self.q * self.nz_l, ny, nx)

    # --- halo exchange ------------------------------------------------------
    def exchange_(self, x_st: torch.Tensor) -> torch.Tensor:
        """Refresh the FACE halo planes of every shard in place: shard i's
        low halo gets shard i - 1's top FACE domain planes, its high halo
        shard i + 1's bottom ones, and the global faces stay zero (the
        ``ppermute`` pair of ``fused_sharded.py:141-161``).  Between the
        rank's own shards a copy; its first and last shards' halos come
        from ranks r -1 and r + 1.  Reads domain planes only and writes
        halo planes only (nz_l >= FACE)."""
        nz_l = self.nz_l
        lo, hi = self.mesh.exchange(x_st[0, FACE:2 * FACE], x_st[-1, nz_l:nz_l + FACE])
        x_st[1:, :FACE] = x_st[:-1, nz_l:nz_l + FACE]
        x_st[:-1, FACE + nz_l:] = x_st[1:, FACE:2 * FACE]
        x_st[0, :FACE] = 0.0 if lo is None else lo
        x_st[-1, FACE + nz_l:] = 0.0 if hi is None else hi
        return x_st

    # --- the fused launches, one a stroke over every shard --------------------
    def _slabs(self) -> dict:
        return dict(shape=self.local_shape, pinned=self.pinned, z0=self.mesh.rows(self.shape[0]).start,
                    nzg=self.shape[0])

    def descent(self, b_st: torch.Tensor, s0, ad, g, gw):
        """``(x1_st, s_st)``: the downstroke (K3z) on every shard in one
        call, after refreshing b's halos in place (the stroke's one stencil
        input)."""
        self.exchange_(b_st)
        return fused7_descent_slab(self.diag_st, self.cx, self.cy, self.cz, b_st, s0, ad, g, gw, **self._slabs())

    def ascent(self, t_st: torch.Tensor, b_st: torch.Tensor, x1_st: torch.Tensor, g, ad, g2, gw):
        """``x4_st``: the upstroke (K4z) on every shard in one call, after
        refreshing the halos of t, b and x1 in place (the operands it reads
        there)."""
        for f in (t_st, b_st, x1_st):
            self.exchange_(f)
        return fused7_ascent_slab(self.diag_st, self.cx, self.cy, self.cz, t_st, b_st, x1_st, g, ad, g2, gw,
                                  **self._slabs())


def _level0_cfg(params: AMGParams) -> tuple[str, int]:
    """(smoother, degree) of a hierarchy built with ``params`` at level 0
    (``Hierarchy.level_cfg``)."""
    for lv, sm, dg in params.level_spec:
        if lv == 0:
            return sm or params.smoother, dg or params.degree
    return params.smoother, params.degree


def sharded_route_refusal(*, mat_type: str, pc: str, structure_detect: bool = True,
                          aggregation: str = "auto") -> str | None:
    """The JAX driver's refusal of these options with ``n_devices > 1``, in
    its words, or None: a standalone SOR or block-Jacobi PC
    (``tpusparse/bench/driver.py:404-408``), and an aij matrix that does
    not reach the star lift (``:971-978``, ``:1146-1151``): the sharded
    general executor (``dist/general.py``) is a library API with no driver
    route, in the port as in the JAX package."""
    if mat_type == "stencil" and pc in ("sor", "bjacobi"):
        return (
            f"pc_type={pc!r} is single-device (its state is not wired"
            " through the sharding layer); use gamg/jacobi multi-device"
        )
    if mat_type == "aij" and not structure_detect:
        return (
            "mat_type=aij multi-device driver requires structure_detect"
            " (general path: use dist.general.DistDIA)"
        )
    if mat_type == "aij" and (pc != "gamg" or aggregation == "greedy"):
        return AIJ_UNLIFTED
    return None


# the JAX driver's refusal of a multi-device aij solve off the star lift
AIJ_UNLIFTED = (
    "mat_type=aij multi-device: the matrix did not prove star-"
    "structured (or pc/aggregation preclude the lift) — use "
    "dist.general.DistDIA for sharded general matrices"
)


def fused_route_ok(*, precision: str, pc: str, layout: str, pc_dtype: str, params: AMGParams,
                   grid_shape, n_devices: int, world: int, filtered: bool) -> bool:
    """Whether a solve on ``n_devices`` blocks takes the fused z route (the
    JAX driver's ``fused_sh``, ``tpusparse/bench/driver.py:396-431``, and
    its ``fused_sharded_supported`` check), else the (z, y) plain route:
    the mixed-precision solve under GAMG, off the plain layout and the
    plain-only options, with f32 levels whose level 0 the fused kernels
    take (a degree-2 Chebyshev or Richardson smoother, no filtered P
    smoother: ``filtered``), on z-slabs of at least FACE planes, p/W of
    them a rank.  Where the JAX driver's preflight declines the kernels it
    runs the plain cycle; here the shape decides the same way."""
    smoother, degree = _level0_cfg(params)
    nz = grid_shape[0]
    return (
        precision == "mixed" and pc == "gamg" and layout != "plain" and not plain_cycle_only(params)
        and pc_dtype == "f32" and smoother in ("chebyshev", "richardson") and degree == 2 and not filtered
        and nz % n_devices == 0 and nz // n_devices >= FACE and n_devices % world == 0
    )


def fused_sharded_supported(hier: Hierarchy) -> bool:
    """The level-0 configuration the sharded fused cycle runs
    (``fused_sharded.py:253-275``): a plain f32 star whose transfer is
    structured, bare or seam-wrapped, unfiltered (the port runs no filtered
    level 0 here: JAX's sharded route passes no filtered legs, ROADMAP §3),
    with a degree-2 Chebyshev or Richardson smoother."""
    lev = hier.levels[0]
    smoother, degree = hier.level_cfg(0)
    return (
        isinstance(lev.op, StarStencil3D)
        and isinstance(lev.transfer, (StructuredTransfer, ShardedTransfer))
        and lev.transfer.fop is None
        and smoother in ("chebyshev", "richardson")
        and degree == 2
        and lev.op.dtype == torch.float32
    )


def vcycle_fused_sharded(fs: FusedSharded, hier: Hierarchy, b: torch.Tensor, gamma: int = 1) -> torch.Tensor:
    """One cycle (V, or W for ``gamma`` 2) from a zero guess: the fused fine
    level per z-shard, the plain cycle from level 1 down.  ``hier`` is the
    PLAIN hierarchy; ``b`` a plain (nz, ny, nx) f32 field.  The math of
    ``amg/fused_cycle.py::vcycle_fused`` (the same kernels' functions, the
    same scalars)."""
    if not fused_sharded_supported(hier):
        raise ValueError(
            "the sharded fused cycle needs a plain f32 fine level with an"
            " unfiltered structured transfer and a degree-2 chebyshev or"
            " richardson point-Jacobi smoother"
        )
    lev = hier.levels[0]
    tr = lev.transfer if isinstance(lev.transfer, ShardedTransfer) else ShardedTransfer(lev.transfer, fs.mesh)
    s0, ad, g = _fine_scalars(hier, lev)

    with annotate("tpusparse:level0"):
        b_st = fs.to_stacked(b)
        # downstroke: pre-smooth x2 + residual + P^T smoothing pass, fused
        x1_st, s_st = fs.descent(b_st, s0, ad, g, tr.omega)
        e = coarse_cycle(hier, tr.tT_apply(fs.from_stacked(s_st)), 1, gamma)
        # upstroke: P smoothing + correction + post-smooth x2, fused (the g slot
        # carries s0 and the g2 slot g, as in vcycle_fused)
        t_st = fs.to_stacked(tr.t_apply(e))
        return fs.from_stacked(fs.ascent(t_st, b_st, x1_st, s0, ad, g, tr.omega))

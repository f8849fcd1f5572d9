"""The z-sharded fused fine level — port of ``tpusparse/dist/fused_sharded.py``
on one device.

The JAX package runs the fused fine-level kernels once per z-shard under
``shard_map``: fields live in the stacked layout ``(p, nz_l + 2 FACE, ny,
nxp)`` (each shard's z-slab with its own FACE halo planes, zero between
launches), the halo planes of the operands a launch reads are refreshed
just before it, and the kernels mask in global z (``fused7_call``'s ``z0``,
``nzg``).  Here the p shards all live on one device (``dist/mesh.py``): the
exchange is a copy of planes between slabs, and a launch a shard runs K3z
or K4z (``kernels/fused7.py::fused7_descent_slab`` / ``fused7_ascent_slab``).

The coarse hierarchy and the Krylov shell stay unsharded: plain fields and
the plain ``hierarchy.vcycle`` from level 1 down.  ``vcycle_fused_sharded``
stitches the two per cycle: stack -> K3z per shard -> unstack -> T^T
(``dist/seam.py``) -> coarse cycle -> T -> stack -> K4z per shard ->
unstack.

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
from tpusparse_torch.dist.mesh import ZMesh, check_divisible
from tpusparse_torch.dist.seam import ShardedTransfer
from tpusparse_torch.kernels.fused7 import fused7_ascent_slab, fused7_descent_slab
from tpusparse_torch.kernels.stencil7 import FACE, padded_shape
from tpusparse_torch.sparse.stencil import StarStencil3D


@dataclasses.dataclass
class FusedSharded:
    """The fine level's fused kernels over a z mesh.

    ``diag_st`` is the diagonal in the stacked layout with its halo planes
    already refreshed (it never changes, so it is exchanged once, at build)
    and every remaining zero (x pads, the global z faces) set to 1.0, so
    that 1 / diag is finite wherever the kernels evaluate it.
    """

    diag_st: torch.Tensor          # (p, nz_l + 2 FACE, ny, nxp)
    cx: float
    cy: float
    cz: float
    shape: tuple[int, int, int]    # the GLOBAL (nz, ny, nx)
    pinned: bool
    mesh: ZMesh

    @property
    def p(self) -> int:
        return self.mesh.p

    @property
    def nz_l(self) -> int:
        return self.shape[0] // self.p

    @property
    def local_shape(self) -> tuple[int, int, int]:
        return (self.nz_l, self.shape[1], self.shape[2])

    @classmethod
    def build(cls, op: StarStencil3D, mesh: ZMesh) -> "FusedSharded":
        """From the f32 plain operator: its diagonal stacked, its halos
        refreshed once, then its zeros set to 1.0 (``fused_sharded.py:97-125``)."""
        if op.dtype != torch.float32:
            raise TypeError(f"the fused kernels take a float32 operator, not {op.dtype}")
        check_divisible(op.grid_shape, mesh)
        fs = cls(
            diag_st=op.diag.new_zeros(()), cx=op.cx, cy=op.cy, cz=op.cz,
            shape=tuple(op.grid_shape), pinned=op.pinned, mesh=mesh,
        )
        diag_st = fs.exchange_(fs.to_stacked(op.diag))
        fs.diag_st = torch.where(diag_st == 0, torch.ones((), dtype=diag_st.dtype, device=diag_st.device), diag_st)
        return fs

    # --- layout -----------------------------------------------------------
    def to_stacked(self, x: torch.Tensor) -> torch.Tensor:
        """(nz, ny, nx) -> the stacked layout, halo planes and pads zero."""
        nz, ny, nx = self.shape
        nxp = padded_shape(self.shape)[2]
        x4 = x.reshape(self.p, self.nz_l, ny, nx)
        return F.pad(x4, (0, nxp - nx, 0, 0, FACE, FACE))

    def from_stacked(self, x_st: torch.Tensor) -> torch.Tensor:
        """The stacked layout -> (nz, ny, nx)."""
        nz, ny, nx = self.shape
        return x_st[:, FACE:FACE + self.nz_l, :, :nx].reshape(nz, ny, nx)

    # --- halo exchange ------------------------------------------------------
    def exchange_(self, x_st: torch.Tensor) -> torch.Tensor:
        """Refresh the FACE halo planes of every shard in place: shard i's
        low halo gets shard i - 1's top FACE domain planes, its high halo
        shard i + 1's bottom ones, and the global faces stay zero (the
        ``ppermute`` pair of ``fused_sharded.py:141-161``).  Reads domain
        planes only and writes halo planes only (nz_l >= FACE)."""
        nz_l = self.nz_l
        x_st[1:, :FACE] = x_st[:-1, nz_l:nz_l + FACE]
        x_st[:-1, FACE + nz_l:] = x_st[1:, FACE:2 * FACE]
        x_st[0, :FACE] = 0.0
        x_st[-1, FACE + nz_l:] = 0.0
        return x_st

    # --- the fused launches, one a shard -------------------------------------
    def _slab(self, i: int) -> dict:
        return dict(shape=self.local_shape, pinned=self.pinned, z0=i * self.nz_l, nzg=self.shape[0])

    def descent(self, b_st: torch.Tensor, s0, ad, g, gw):
        """``(x1_st, s_st)``: the downstroke (K3z) on each shard, after
        refreshing b's halos in place (the stroke's one stencil input)."""
        self.exchange_(b_st)
        x1_st, s_st = torch.empty_like(b_st), torch.empty_like(b_st)
        for i in range(self.p):
            fused7_descent_slab(self.diag_st[i], self.cx, self.cy, self.cz, b_st[i], s0, ad, g, gw,
                                out=(x1_st[i], s_st[i]), **self._slab(i))
        return x1_st, s_st

    def ascent(self, t_st: torch.Tensor, b_st: torch.Tensor, x1_st: torch.Tensor, g, ad, g2, gw):
        """``x4_st``: the upstroke (K4z) on each shard, after refreshing
        the halos of t, b and x1 in place (the operands it reads there)."""
        for f in (t_st, b_st, x1_st):
            self.exchange_(f)
        x4_st = torch.empty_like(t_st)
        for i in range(self.p):
            fused7_ascent_slab(self.diag_st[i], self.cx, self.cy, self.cz, t_st[i], b_st[i], x1_st[i],
                               g, ad, g2, gw, out=x4_st[i], **self._slab(i))
        return x4_st


def _level0_cfg(params: AMGParams) -> tuple[str, int]:
    """(smoother, degree) of a hierarchy built with ``params`` at level 0
    (``Hierarchy.level_cfg``)."""
    for lv, sm, dg in params.level_spec:
        if lv == 0:
            return sm or params.smoother, dg or params.degree
    return params.smoother, params.degree


def sharded_route_refusal(*, mat_type: str, precision: str, pc: str, layout: str, pc_dtype: str,
                          params: AMGParams) -> str | None:
    """Why these options have no z-sharded route in the port, or None.

    The route (the JAX driver's ``fused_sh``, ``tpusparse/bench/driver.py:
    404-431``) is the mixed-precision stencil solve under GAMG whose level 0
    the fused kernels take (``fused_sharded_supported``: a degree-2
    Chebyshev or Richardson point-Jacobi smoother, f32).  The JAX package
    runs every other ``n_devices > 1`` solve as a GSPMD program over a
    (z, y) mesh, which is ROADMAP queue 12."""
    smoother, degree = _level0_cfg(params)
    if mat_type != "stencil":
        return f"mat_type {mat_type}"
    if precision != "mixed":
        return f"precision {precision}"
    if pc != "gamg":
        return f"pc {pc}"
    if layout == "plain" or plain_cycle_only(params):
        return "the plain layout (or a plain-only smoother / coarse solve)"
    if pc_dtype != "f32":
        return f"pc_dtype {pc_dtype}"
    if smoother not in ("chebyshev", "richardson") or degree != 2:
        return f"a {smoother}({degree}) level-0 smoother (the fused kernels take degree 2)"
    return None


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

    b_st = fs.to_stacked(b)
    # downstroke: pre-smooth x2 + residual + P^T smoothing pass, fused
    x1_st, s_st = fs.descent(b_st, s0, ad, g, tr.omega)
    e = coarse_cycle(hier, tr.tT_apply(fs.from_stacked(s_st)), 1, gamma)
    # upstroke: P smoothing + correction + post-smooth x2, fused (the g slot
    # carries s0 and the g2 slot g, as in vcycle_fused)
    t_st = fs.to_stacked(tr.t_apply(e))
    return fs.from_stacked(fs.ascent(t_st, b_st, x1_st, s0, ad, g, tr.omega))

"""K2-K4, K6-K16: the fused7 kernels of the GAMG V-cycle and of the
full-fusion CG body — port of every mode of
``tpusparse/kernels/fused7.py::fused7_call``.

=========== ======================================================== =====
wrapper     computes                                                 dot
=========== ======================================================== =====
mvdot       y = A x                                                  <x,y>
descent_rr  u = (s0 b) D^-1;  x1 = u + ad u + g D^-1 (b - A u)       <b,b>
            r = b - A x1;  s = r - gw A (D^-1 r)
            out: (x1, s) — the degree-2 fine-level downstroke
ascent_rz   x2 = x1 + t - gw D^-1 (A t)                              <b,x4>
            d = g D^-1 (b - A x2);  x3 = x2 + d
            x4 = x3 + ad d + g2 D^-1 (b - A x3)
            out: x4 — the degree-2 fine-level upstroke
descent1_rr x1 = g D^-1 b;  r = b - A x1;  s = r - gw A (D^-1 r)     <b,b>
            out: (x1, s) — the degree-1 downstroke
ascent1_rz  x2 = x1 + t - gw D^-1 (A t);  x3 = x2 + g D^-1 (b - A x2) <b,x3>
            out: x3 — the degree-1 upstroke
cgmv        p' = z + beta p;  w = A p';  x' = x + alpha_prev p       <p',w>
            out: (w, p', x') — the full-fusion CG body's top half
descentu    r' = r - alpha ap, then descent_rr's math on r'          <r',r'>
            out: (x1, s, r') — its bottom half's downstroke
mv          y = A x: K1 (``stencil7.py::star7_mv_padded``)
residual    b - A x                                            (K10)
rich        x + g D^-1 (b - A x)                               (K11)
cheb0       d' = g D^-1 (b - A x);  x' = x + d'    out: (x', d') (K12)
cheb        d' = ad d + g D^-1 (b - A x);  x' = x + d'         (K13)
pre2        u = (s0 b) D^-1;  d' = ad u + g D^-1 (b - A u);    (K14)
            x' = u + d'            out: (x', d')
restrict    r - g A_f (D^-1 r)     (P^T smoothing)             (K15)
prolong     t - g D^-1 (A_f t)     (P smoothing)               (K16)
=========== ======================================================== =====

K10-K16 are the single steps of the unfused padded V-cycle
(``amg/hierarchy.py::vcycle`` on a ``PaddedStar`` level): a smoother of
another degree than 1 or 2, and the W-cycle's coarse re-entries run on them.

``flegs``: every P-smoothing stage (restrict, prolong, and the P^T / P
passes inside descent, ascent, descent1, ascent1 and descentu) takes the
legs (fcx, fcy, fcz) of the -pc_gamg_threshold filtered operator A_f
(``transfer.fop``), as ``fused7_call``'s ``flegs`` does; ``None`` means the
operator's own legs.

``descent``, ``ascent``, ``descent1`` and ``ascent1`` (K3'/K4'/K6'/K7')
are the same four without the dot: the same CUDA kernels with the dot
epilogue compiled out, for the V-cycle of the non-CG solvers.  The dots are
what CG needs next: ``<p, Ap>`` for alpha, ``||r||^2`` and ``<r, z>`` (the
cycle's input b IS the residual and its output IS z).

``descent_slab`` and ``ascent_slab`` (K3z/K4z) are K3' and K4' in
``fused7_call``'s z-slab form (its ``z0``/``nzg``, ``fused7.py:813-814``):
the fields are one z-shard of a grid of ``nzg`` planes, whose domain planes
are the global planes [z0, z0 + nz) and whose face planes hold the
neighbouring shards' planes (``dist/fused_sharded.py`` refreshes them).
The chained steps keep their values on those face planes where they lie
in the global domain, the pin is tested in global planes, and the outputs
are 0 on every face plane, the stacked layout's invariant.  Their twins
run the unsharded twins' math on ``star7_mv_padded_torch``'s global
placement and zero the output faces.

K8 (``cgmv``) and K9 (``descentu``) take their CG scalars (beta,
alpha_prev, alpha) as 0-d tensors, as CG computes them from the kernels'
dots: the CUDA kernels read them from device memory, so a CG iteration
reads nothing to the host but its residual norm.  A Python float is
accepted too.

D is ``diag`` (pads 1.0), inverted by true division.  All fields are in the
padded-resident layout (``kernels/stencil7.py::padded_shape``).

K2-K4, K6/K7, their dot-free forms, K9, K14 and K15 are one launch each
that marches a column tile of the (ny, nxp) plane up a z-chunk of planes
(``csrc/fused7.cu``); their launch plan — tiles, z-chunk, grid, shared
bytes, one dot partial a block — is ``zmarch_plan``, which the CPU tests
check and the CUDA entry points verify.

Each wrapper dispatches by tensor device only: a CPU tensor runs its plain
twin (the math of ``fused7_xla``, ``tpusparse/kernels/fused7.py:945-1023``),
a CUDA tensor launches ``csrc/fused7.cu`` (or raises).  The kernels' dots
come back as a 0-d device tensor summed in a fixed order from one partial
per block — no atomics, so a solve repeats its iteration counts.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from tpusparse_torch.kernels import LAUNCHES, _build
from tpusparse_torch.kernels.stencil7 import (
    FACE,
    check_fields,
    launch_args,
    padded_shape,
    star7_mv_padded,
    star7_mv_padded_torch,
)

P, I, F = _build.P, _build.I, _build.F
_ZMARCH_PLAN_ARGS = [I] * 5   # tiles_x, tiles_y, chunks, zchunk, smem_bytes
_MVDOT_ARGS = [P] * 4 + [I] * 4 + [F] * 3 + [I] + _ZMARCH_PLAN_ARGS + [P]
# ..., pinned, zg, nzg (the slab form's placement), the plan, the stream
_DESCENT_ARGS = [P] * 5 + [I] * 4 + [F] * 10 + [I] * 3 + _ZMARCH_PLAN_ARGS + [P]
_ASCENT_ARGS = [P] * 6 + [I] * 4 + [F] * 10 + [I] * 3 + _ZMARCH_PLAN_ARGS + [P]
_DESCENT1_ARGS = [P] * 5 + [I] * 4 + [F] * 8 + [I] + _ZMARCH_PLAN_ARGS + [P]
_ASCENT1_ARGS = [P] * 6 + [I] * 4 + [F] * 8 + [I] + _ZMARCH_PLAN_ARGS + [P]
_CGMV_ARGS = [P] * 10 + [I] * 4 + [F] * 3 + [I, P]
_DESCENTU_ARGS = [P] * 8 + [I] * 4 + [F] * 10 + [I] + _ZMARCH_PLAN_ARGS + [P]
_RESIDUAL_ARGS = [P] * 4 + [I] * 4 + [F] * 3 + [I, P]
_RICH_ARGS = [P] * 4 + [I] * 4 + [F] * 4 + [I, P]
_CHEB0_ARGS = [P] * 5 + [I] * 4 + [F] * 4 + [I, P]
_CHEB_ARGS = [P] * 6 + [I] * 4 + [F] * 5 + [I, P]
_PRE2_ARGS = [P] * 4 + [I] * 4 + [F] * 6 + [I] + _ZMARCH_PLAN_ARGS + [P]
_RESTRICT_ARGS = [P] * 3 + [I] * 4 + [F] * 4 + [I] + _ZMARCH_PLAN_ARGS + [P]
_PROLONG_ARGS = [P] * 3 + [I] * 4 + [F] * 4 + [I, P]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _partials(shape, device) -> torch.Tensor:
    """Scratch for one dot partial per thread block of K8 (one thread a
    cell)."""
    cells = 1
    for n in padded_shape(shape):
        cells *= n
    block = _build.block_size()
    return torch.empty((cells + block - 1) // block, dtype=torch.float32, device=device)


# --- the z-marching launch plan (K2-K4, K6/K7, K9, K14, K15) ----------------------
# csrc/fused7.cu's ZM_SX and ZM_TX: a block's region of 64 columns, one
# 4-cell quad a thread, and its output tile's 56 (the region adds a quad of
# columns a side, so that rows start on 16 bytes); its rows are the tile's
# and the kernel's halo H a side
ZM_REGION_X = 64
ZM_TILE_X = 56
# csrc/fused7.cu's ZM_RING_PLANES: the region planes of a kernel's shared
# rings, K6/K7's two rings of 3 and K3/K4/K9's three of 2 (K2/K14/K15: one
# of 2)
ZM_RING_PLANES = 6
# the most output planes a block marches through: a chunk loads 2 H planes
# more than it writes, so longer chunks read less twice; 48 gives 300^3 2.7
# (K6) and 4.0 (K7) waves of blocks and ran K6/K7 a few per cent faster
# than 32; for K3/K4 34-62 ran within 5% of each other (3.8 waves at 48;
# PERF.md §6)
ZM_ZCHUNK = 48


@dataclass(frozen=True)
class ZMarchKernel:
    """What the plan needs of one z-marching kernel (csrc/fused7.cu's
    ``ZM*_SY``, ``ZM*_AHEAD``, ``ZM*_MIN_BLOCKS`` and ``Staging*``): its
    halo H (the stencil applies it chains: H rows, H planes and one quad of
    columns a side), its region's rows (a thread a quad), the planes each
    staged input field keeps, and the blocks an SM must hold
    (``__launch_bounds__``), what a wave of blocks is; the region planes of
    its shared rings, and the most planes a z-chunk writes."""

    halo: int
    rows: int
    stages: tuple
    blocks_per_sm: int
    ring_planes: int = ZM_RING_PLANES
    zchunk: int = ZM_ZCHUNK

    @property
    def region(self) -> tuple[int, int]:
        return self.rows, ZM_REGION_X

    @property
    def tile(self) -> tuple[int, int]:
        return self.rows - 2 * self.halo, ZM_TILE_X

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared bytes a block: the rings and the staging ring."""
        return (self.ring_planes + sum(self.stages)) * self.rows * ZM_REGION_X * 4


ZM_KERNELS = {
    "descent": ZMarchKernel(halo=3, rows=40, stages=(8, 8), blocks_per_sm=1),
    "ascent": ZMarchKernel(halo=3, rows=40, stages=(2, 2, 4, 4), blocks_per_sm=1),
    "descent1": ZMarchKernel(halo=2, rows=16, stages=(6, 6), blocks_per_sm=3),
    "ascent1": ZMarchKernel(halo=2, rows=16, stages=(5, 5, 5, 5), blocks_per_sm=2),
    # K3's region, staged 1 ahead: r 4, diag 8 and ap 2 planes deep
    "descentu": ZMarchKernel(halo=3, rows=40, stages=(4, 8, 2), blocks_per_sm=1),
    # one ring of 2 planes; 4 blocks an SM and chunks of at most 40 planes:
    # at 300^3 132 tiles times 8 chunks of 39, 2 whole waves
    "restrict": ZMarchKernel(halo=1, rows=16, stages=(5, 5), blocks_per_sm=4, ring_planes=2, zchunk=40),
}
# K2 and K14 march on K15's machinery: the same two staged fields, ring and plan
ZM_KERNELS["mvdot"] = ZM_KERNELS["pre2"] = ZM_KERNELS["restrict"]
H100_SMS = 132


@dataclass(frozen=True)
class ZMarchPlan:
    """The grid of one z-marching launch: ``tiles_x`` x ``tiles_y`` column
    tiles of ``tile`` output cells in the (ny, nxp) plane times ``chunks``
    z-chunks of ``zchunk`` padded planes, one block of a thread a quad of
    its ``region`` each; ``smem_bytes`` of dynamic shared memory a block,
    of which an SM holds ``blocks_per_sm`` blocks."""

    region: tuple[int, int]
    tile: tuple[int, int]
    tiles_x: int
    tiles_y: int
    chunks: int
    zchunk: int
    smem_bytes: int
    blocks_per_sm: int

    @property
    def blocks(self) -> int:
        """Thread blocks, and dot partials (one a block)."""
        return self.tiles_x * self.tiles_y * self.chunks

    def waves(self, sms: int = H100_SMS) -> float:
        """Blocks over the blocks ``sms`` SMs hold at once."""
        return self.blocks / (sms * self.blocks_per_sm)

    def ranges(self, shape) -> tuple[list, list, list]:
        """The padded-field output ranges of the blocks along z, y and x,
        as the kernel computes them from ``blockIdx``: chunk c writes planes
        [c zchunk, min((c + 1) zchunk, nzp)), tile t of y rows [t TY,
        min((t + 1) TY, ny)), and likewise in x up to nxp."""
        nzp, ny, nxp = padded_shape(shape)
        ty, tx = self.tile

        def cut(n, step, parts):
            return [(c * step, min((c + 1) * step, n)) for c in range(parts)]

        return cut(nzp, self.zchunk, self.chunks), cut(ny, ty, self.tiles_y), cut(nxp, tx, self.tiles_x)

    def launch_args(self) -> tuple[int, int, int, int, int]:
        return self.tiles_x, self.tiles_y, self.chunks, self.zchunk, self.smem_bytes


def zmarch_plan(shape, kernel: str) -> ZMarchPlan:
    """The launch plan of ``kernel`` ("descent": K3/K3', "ascent": K4/K4',
    "descent1": K6/K6', "ascent1": K7/K7', "descentu": K9, "restrict": K15,
    "mvdot": K2, "pre2": K14)
    for a (nz, ny, nx) field: tiles to cover the padded plane, chunks of at
    most the kernel's ``zchunk`` planes, of equal length but the last, to
    cover the padded depth, and the shared bytes of its rings and staging
    ring."""
    nzp, ny, nxp = padded_shape(shape)
    spec = ZM_KERNELS[kernel]
    ty, tx = spec.tile
    chunks = -(-nzp // spec.zchunk)
    zchunk = -(-nzp // chunks)
    return ZMarchPlan(
        region=spec.region, tile=spec.tile, tiles_x=-(-nxp // tx), tiles_y=-(-ny // ty), chunks=-(-nzp // zchunk),
        zchunk=zchunk, smem_bytes=spec.smem_bytes, blocks_per_sm=spec.blocks_per_sm,
    )


# --- plain twins -------------------------------------------------------------

def _mv(diag_p, cx, cy, cz, shape, pinned, z0=0, nzg=None):
    return lambda v: star7_mv_padded_torch(diag_p, cx, cy, cz, v, shape, pinned, z0, nzg)


def _legs(cx, cy, cz, flegs):
    """The P-smoothing legs: ``flegs``, or the operator's own."""
    return (cx, cy, cz) if flegs is None else tuple(flegs)


def fused7_mvdot_torch(diag_p, cx, cy, cz, x_p, shape, pinned: bool):
    y = star7_mv_padded_torch(diag_p, cx, cy, cz, x_p, shape, pinned)
    return y, _dot(x_p, y)


def fused7_descent_torch(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned: bool, flegs=None,
                         z0=0, nzg=None):
    mv = _mv(diag_p, cx, cy, cz, shape, pinned, z0, nzg)
    fmv = _mv(diag_p, *_legs(cx, cy, cz, flegs), shape, pinned, z0, nzg)
    dinv = 1.0 / diag_p
    u = (s0 * b_p) * dinv
    x1 = u + ad * u + g * (dinv * (b_p - mv(u)))
    r = b_p - mv(x1)
    s = r - gw * fmv(dinv * r)
    return x1, s


def fused7_descent_rr_torch(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned: bool, flegs=None):
    x1, s = fused7_descent_torch(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned, flegs)
    return x1, s, _dot(b_p, b_p)


def fused7_ascent_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned: bool, flegs=None,
                        z0=0, nzg=None):
    mv = _mv(diag_p, cx, cy, cz, shape, pinned, z0, nzg)
    fmv = _mv(diag_p, *_legs(cx, cy, cz, flegs), shape, pinned, z0, nzg)
    dinv = 1.0 / diag_p
    x2 = x1_p + t_p - gw * (dinv * fmv(t_p))
    d = g * (dinv * (b_p - mv(x2)))
    x3 = x2 + d
    return x3 + ad * d + g2 * (dinv * (b_p - mv(x3)))


def fused7_ascent_rz_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned: bool, flegs=None):
    x4 = fused7_ascent_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned, flegs)
    return x4, _dot(b_p, x4)


def _zero_faces(f_p: torch.Tensor, shape) -> torch.Tensor:
    """``f_p`` with its FACE planes on each z face set to 0."""
    nz = shape[0]
    f_p[:FACE] = 0.0
    f_p[FACE + nz:] = 0.0
    return f_p


def fused7_descent_slab_torch(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned: bool, z0: int, nzg: int):
    """Plain twin of K3z: K3''s twin on the slab placed at global plane
    ``z0`` of ``nzg``, its outputs' face planes 0."""
    x1, s = fused7_descent_torch(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned, None, z0, nzg)
    return _zero_faces(x1, shape), _zero_faces(s, shape)


def fused7_ascent_slab_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned: bool, z0: int,
                             nzg: int):
    """Plain twin of K4z: K4''s twin on the slab, its output's face planes 0."""
    x4 = fused7_ascent_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned, None, z0, nzg)
    return _zero_faces(x4, shape)


def fused7_descent1_torch(diag_p, cx, cy, cz, b_p, g, gw, shape, pinned: bool, flegs=None):
    mv = _mv(diag_p, cx, cy, cz, shape, pinned)
    fmv = _mv(diag_p, *_legs(cx, cy, cz, flegs), shape, pinned)
    dinv = 1.0 / diag_p
    x1 = g * (dinv * b_p)
    r = b_p - mv(x1)
    s = r - gw * fmv(dinv * r)
    return x1, s


def fused7_descent1_rr_torch(diag_p, cx, cy, cz, b_p, g, gw, shape, pinned: bool, flegs=None):
    x1, s = fused7_descent1_torch(diag_p, cx, cy, cz, b_p, g, gw, shape, pinned, flegs)
    return x1, s, _dot(b_p, b_p)


def fused7_ascent1_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned: bool, flegs=None):
    mv = _mv(diag_p, cx, cy, cz, shape, pinned)
    fmv = _mv(diag_p, *_legs(cx, cy, cz, flegs), shape, pinned)
    dinv = 1.0 / diag_p
    x2 = x1_p + t_p - gw * (dinv * fmv(t_p))
    return x2 + g * (dinv * (b_p - mv(x2)))


def fused7_ascent1_rz_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned: bool, flegs=None):
    x3 = fused7_ascent1_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned, flegs)
    return x3, _dot(b_p, x3)


def fused7_cgmv_torch(diag_p, cx, cy, cz, z_p, p_p, x_p, beta, alpha_prev, shape, pinned: bool):
    pn = z_p + beta * p_p
    w = star7_mv_padded_torch(diag_p, cx, cy, cz, pn, shape, pinned)
    xn = x_p + alpha_prev * p_p
    return w, pn, xn, _dot(pn, w)


def fused7_descentu_torch(diag_p, cx, cy, cz, r_p, ap_p, s0, ad, g, gw, alpha, shape, pinned: bool,
                          flegs=None):
    r = r_p - alpha * ap_p
    x1, s = fused7_descent_torch(diag_p, cx, cy, cz, r, s0, ad, g, gw, shape, pinned, flegs)
    return x1, s, r, _dot(r, r)


def fused7_residual_torch(diag_p, cx, cy, cz, x_p, b_p, shape, pinned: bool):
    return b_p - star7_mv_padded_torch(diag_p, cx, cy, cz, x_p, shape, pinned)


def fused7_rich_torch(diag_p, cx, cy, cz, x_p, b_p, g, shape, pinned: bool):
    dinv = 1.0 / diag_p
    return x_p + g * (dinv * (b_p - star7_mv_padded_torch(diag_p, cx, cy, cz, x_p, shape, pinned)))


def fused7_cheb0_torch(diag_p, cx, cy, cz, x_p, b_p, g, shape, pinned: bool):
    dinv = 1.0 / diag_p
    d = g * (dinv * (b_p - star7_mv_padded_torch(diag_p, cx, cy, cz, x_p, shape, pinned)))
    return x_p + d, d


def fused7_cheb_torch(diag_p, cx, cy, cz, x_p, b_p, d_p, ad, g, shape, pinned: bool):
    dinv = 1.0 / diag_p
    d = ad * d_p + g * (dinv * (b_p - star7_mv_padded_torch(diag_p, cx, cy, cz, x_p, shape, pinned)))
    return x_p + d, d


def fused7_pre2_torch(diag_p, cx, cy, cz, b_p, s0, ad, g, shape, pinned: bool):
    dinv = 1.0 / diag_p
    u = (s0 * b_p) * dinv
    d = ad * u + g * (dinv * (b_p - star7_mv_padded_torch(diag_p, cx, cy, cz, u, shape, pinned)))
    return u + d, d


def fused7_restrict_torch(diag_p, cx, cy, cz, r_p, g, shape, pinned: bool, flegs=None):
    fmv = _mv(diag_p, *_legs(cx, cy, cz, flegs), shape, pinned)
    return r_p - g * fmv((1.0 / diag_p) * r_p)


def fused7_prolong_torch(diag_p, cx, cy, cz, t_p, g, shape, pinned: bool, flegs=None):
    fmv = _mv(diag_p, *_legs(cx, cy, cz, flegs), shape, pinned)
    return t_p - g * ((1.0 / diag_p) * fmv(t_p))


# --- kernel launches -----------------------------------------------------------
# Each launcher takes its counter's name and ``dot``: with it the kernels
# write block partials and the launcher returns their sum last; without it
# the entry point gets a null partials pointer (the dot-free form).  The
# composite entry points take the operator's legs, then the P-smoothing
# legs (``_legs``).

def _check_aligned(*fields: torch.Tensor) -> None:
    """The z-marching kernels move a field's rows as float4: each must start
    on 16 bytes."""
    for f in fields:
        if f.data_ptr() % 16:
            raise ValueError("the z-marching kernels need fields that start on 16 bytes")


# the z-marching wrappers in csrc/fused7.cu's ``tps_zmarch_attributes`` order,
# then the slab forms K3z/K4z (their kernels' too)
ZMARCH_WRAPPERS = (
    "fused7_descent_rr", "fused7_descent", "fused7_ascent_rz", "fused7_ascent",
    "fused7_descent1_rr", "fused7_descent1", "fused7_ascent1_rz", "fused7_ascent1",
    "fused7_descentu", "fused7_restrict", "fused7_mvdot", "fused7_pre2",
)
SLAB_WRAPPERS = ("fused7_descent_slab", "fused7_ascent_slab")


def zmarch_attributes(name: str) -> dict:
    """The compiled kernel of z-marching wrapper ``name`` (on the card):
    its registers a thread, spilled bytes a thread and static shared bytes
    a block."""
    fn = _build.library().tps_zmarch_attributes
    fn.argtypes = [I, P, P, P]
    fn.restype = I
    regs, local, static = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = fn((ZMARCH_WRAPPERS + SLAB_WRAPPERS).index(name), ctypes.byref(regs), ctypes.byref(local),
            ctypes.byref(static))
    if rc != 0:
        raise RuntimeError(f"tps_zmarch_attributes: CUDA error {rc}")
    return {"registers": regs.value, "spilled_bytes": local.value, "static_smem_bytes": static.value}


def _zmarch_partials(plan: ZMarchPlan, dot: bool, device):
    """One dot partial a block of ``plan``, or None for the dot-free form."""
    return torch.empty(plan.blocks, dtype=torch.float32, device=device) if dot else None


def _launch_descent(name, dot, diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned, flegs,
                    z0=0, nzg=None, out=None):
    x1, s = out if out is not None else (torch.empty_like(b_p), torch.empty_like(b_p))
    _check_aligned(diag_p, b_p, x1, s)
    plan = zmarch_plan(shape, "descent")
    partials = _zmarch_partials(plan, dot, b_p.device)
    _build.launch(
        "tps_descent", _DESCENT_ARGS, b_p.device,
        b_p.data_ptr(), diag_p.data_ptr(), x1.data_ptr(), s.data_ptr(),
        partials.data_ptr() if dot else None,
        *launch_args(shape, cx, cy, cz, *_legs(cx, cy, cz, flegs)),
        float(s0), float(ad), float(g), float(gw), int(pinned), int(z0), shape[0] if nzg is None else int(nzg),
        *plan.launch_args(),
    )
    LAUNCHES[name] += 1
    return (x1, s, partials.sum()) if dot else (x1, s)


def _launch_ascent(name, dot, diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned, flegs,
                   z0=0, nzg=None, out=None):
    x4 = out if out is not None else torch.empty_like(t_p)
    _check_aligned(diag_p, t_p, b_p, x1_p, x4)
    plan = zmarch_plan(shape, "ascent")
    partials = _zmarch_partials(plan, dot, t_p.device)
    _build.launch(
        "tps_ascent", _ASCENT_ARGS, t_p.device,
        t_p.data_ptr(), b_p.data_ptr(), x1_p.data_ptr(), diag_p.data_ptr(),
        x4.data_ptr(), partials.data_ptr() if dot else None,
        *launch_args(shape, cx, cy, cz, *_legs(cx, cy, cz, flegs)),
        float(g), float(ad), float(g2), float(gw), int(pinned), int(z0), shape[0] if nzg is None else int(nzg),
        *plan.launch_args(),
    )
    LAUNCHES[name] += 1
    return (x4, partials.sum()) if dot else x4


def _launch_descent1(name, dot, diag_p, cx, cy, cz, b_p, g, gw, shape, pinned, flegs):
    _check_aligned(diag_p, b_p)
    x1, s = torch.empty_like(b_p), torch.empty_like(b_p)
    plan = zmarch_plan(shape, "descent1")
    partials = _zmarch_partials(plan, dot, b_p.device)
    _build.launch(
        "tps_descent1", _DESCENT1_ARGS, b_p.device,
        b_p.data_ptr(), diag_p.data_ptr(), x1.data_ptr(), s.data_ptr(),
        partials.data_ptr() if dot else None,
        *launch_args(shape, cx, cy, cz, *_legs(cx, cy, cz, flegs)),
        float(g), float(gw), int(pinned), *plan.launch_args(),
    )
    LAUNCHES[name] += 1
    return (x1, s, partials.sum()) if dot else (x1, s)


def _launch_ascent1(name, dot, diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned, flegs):
    _check_aligned(diag_p, t_p, b_p, x1_p)
    x3 = torch.empty_like(t_p)
    plan = zmarch_plan(shape, "ascent1")
    partials = _zmarch_partials(plan, dot, t_p.device)
    _build.launch(
        "tps_ascent1", _ASCENT1_ARGS, t_p.device,
        t_p.data_ptr(), b_p.data_ptr(), x1_p.data_ptr(), diag_p.data_ptr(),
        x3.data_ptr(), partials.data_ptr() if dot else None,
        *launch_args(shape, cx, cy, cz, *_legs(cx, cy, cz, flegs)),
        float(g), float(gw), int(pinned), *plan.launch_args(),
    )
    LAUNCHES[name] += 1
    return (x3, partials.sum()) if dot else x3


# --- kernel wrappers -----------------------------------------------------------

def fused7_mvdot(diag_p, cx, cy, cz, x_p, shape, pinned: bool):
    """``(A x, <x, A x>)`` in one z-marching launch (K2)."""
    shape = tuple(shape)
    check_fields(shape, diag_p, x_p)
    if x_p.device.type == "cpu":
        return fused7_mvdot_torch(diag_p, cx, cy, cz, x_p, shape, pinned)
    _check_aligned(diag_p, x_p)
    y = torch.empty_like(x_p)
    plan = zmarch_plan(shape, "mvdot")
    partials = _zmarch_partials(plan, True, x_p.device)
    _build.launch(
        "tps_mvdot", _MVDOT_ARGS, x_p.device,
        x_p.data_ptr(), diag_p.data_ptr(), y.data_ptr(), partials.data_ptr(),
        *launch_args(shape, cx, cy, cz), int(pinned), *plan.launch_args(),
    )
    LAUNCHES["fused7_mvdot"] += 1
    return y, partials.sum()


def fused7_descent_rr(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned: bool, flegs=None):
    """``(x1, s, <b, b>)``: the degree-2 downstroke (K3), in one launch
    that keeps u and D^-1 r in shared memory and r in registers."""
    shape = tuple(shape)
    check_fields(shape, diag_p, b_p)
    if b_p.device.type == "cpu":
        return fused7_descent_rr_torch(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned, flegs)
    return _launch_descent("fused7_descent_rr", True, diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned,
                           flegs)


def fused7_descent(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned: bool, flegs=None):
    """``(x1, s)``: K3 without its dot (K3')."""
    shape = tuple(shape)
    check_fields(shape, diag_p, b_p)
    if b_p.device.type == "cpu":
        return fused7_descent_torch(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned, flegs)
    return _launch_descent("fused7_descent", False, diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned,
                           flegs)


def fused7_ascent_rz(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned: bool, flegs=None):
    """``(x4, <b, x4>)``: the degree-2 upstroke (K4), in one launch that
    keeps x2 and x3 in shared memory and d in registers."""
    shape = tuple(shape)
    check_fields(shape, diag_p, t_p, b_p, x1_p)
    if t_p.device.type == "cpu":
        return fused7_ascent_rz_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned, flegs)
    return _launch_ascent("fused7_ascent_rz", True, diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape,
                          pinned, flegs)


def fused7_ascent(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned: bool, flegs=None):
    """``x4``: K4 without its dot (K4')."""
    shape = tuple(shape)
    check_fields(shape, diag_p, t_p, b_p, x1_p)
    if t_p.device.type == "cpu":
        return fused7_ascent_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned, flegs)
    return _launch_ascent("fused7_ascent", False, diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape,
                          pinned, flegs)


def _check_slab(shape, z0, nzg, out, *fields) -> None:
    """Raise unless the slab (``shape``, ``z0``) lies in a grid of ``nzg``
    planes and each ``out`` field is a field of the slab."""
    if not (0 <= z0 and z0 + shape[0] <= nzg):
        raise ValueError(f"slab of {shape[0]} planes at global plane {z0} is not inside a grid of {nzg}")
    if out is not None:
        check_fields(shape, *fields, *out)


def fused7_descent_slab(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned: bool, z0: int, nzg: int,
                        out=None):
    """``(x1, s)``: K3' on one z-slab of a grid of ``nzg`` planes whose
    domain planes are global planes [z0, z0 + nz), b's face planes holding
    its neighbours' planes (K3z); x1 and s are 0 on the face planes.
    ``out``: the two output fields to write (fresh ones by default)."""
    shape = tuple(shape)
    check_fields(shape, diag_p, b_p)
    _check_slab(shape, z0, nzg, out, diag_p)
    if b_p.device.type == "cpu":
        got = fused7_descent_slab_torch(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned, z0, nzg)
        return got if out is None else tuple(o.copy_(v) for o, v in zip(out, got))
    return _launch_descent("fused7_descent_slab", False, diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned,
                           None, z0, nzg, out)


def fused7_ascent_slab(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned: bool, z0: int,
                       nzg: int, out=None):
    """``x4``: K4' on one z-slab (K4z), its t, b and x1 holding the
    neighbours' planes on their face planes; x4 is 0 on the face planes.
    ``out``: the output field to write (a fresh one by default)."""
    shape = tuple(shape)
    check_fields(shape, diag_p, t_p, b_p, x1_p)
    _check_slab(shape, z0, nzg, None if out is None else (out,), diag_p)
    if t_p.device.type == "cpu":
        got = fused7_ascent_slab_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned, z0, nzg)
        return got if out is None else out.copy_(got)
    return _launch_ascent("fused7_ascent_slab", False, diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape,
                          pinned, None, z0, nzg, out)


def fused7_descent1_rr(diag_p, cx, cy, cz, b_p, g, gw, shape, pinned: bool, flegs=None):
    """``(x1, s, <b, b>)``: the degree-1 downstroke (K6), in one launch
    that keeps the residual r in shared memory."""
    shape = tuple(shape)
    check_fields(shape, diag_p, b_p)
    if b_p.device.type == "cpu":
        return fused7_descent1_rr_torch(diag_p, cx, cy, cz, b_p, g, gw, shape, pinned, flegs)
    return _launch_descent1("fused7_descent1_rr", True, diag_p, cx, cy, cz, b_p, g, gw, shape, pinned, flegs)


def fused7_descent1(diag_p, cx, cy, cz, b_p, g, gw, shape, pinned: bool, flegs=None):
    """``(x1, s)``: K6 without its dot (K6')."""
    shape = tuple(shape)
    check_fields(shape, diag_p, b_p)
    if b_p.device.type == "cpu":
        return fused7_descent1_torch(diag_p, cx, cy, cz, b_p, g, gw, shape, pinned, flegs)
    return _launch_descent1("fused7_descent1", False, diag_p, cx, cy, cz, b_p, g, gw, shape, pinned, flegs)


def fused7_ascent1_rz(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned: bool, flegs=None):
    """``(x3, <b, x3>)``: the degree-1 upstroke (K7), in one launch that
    keeps x2 in shared memory."""
    shape = tuple(shape)
    check_fields(shape, diag_p, t_p, b_p, x1_p)
    if t_p.device.type == "cpu":
        return fused7_ascent1_rz_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned, flegs)
    return _launch_ascent1("fused7_ascent1_rz", True, diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned,
                           flegs)


def fused7_ascent1(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned: bool, flegs=None):
    """``x3``: K7 without its dot (K7')."""
    shape = tuple(shape)
    check_fields(shape, diag_p, t_p, b_p, x1_p)
    if t_p.device.type == "cpu":
        return fused7_ascent1_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned, flegs)
    return _launch_ascent1("fused7_ascent1", False, diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned,
                           flegs)


def _device_scalar(v, device) -> torch.Tensor:
    """``v`` (a 0-d tensor or a Python float) as a one-element f32 tensor on
    ``device``: no copy for a 0-d f32 tensor already there."""
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(1)


def fused7_cgmv(diag_p, cx, cy, cz, z_p, p_p, x_p, beta, alpha_prev, shape, pinned: bool):
    """``(A p', p', x', <p', A p'>)`` with p' = z + beta p and the deferred
    x' = x + alpha_prev p: the full-fusion CG body's top half in one launch
    (K8)."""
    shape = tuple(shape)
    check_fields(shape, diag_p, z_p, p_p, x_p)
    if z_p.device.type == "cpu":
        return fused7_cgmv_torch(diag_p, cx, cy, cz, z_p, p_p, x_p, beta, alpha_prev, shape, pinned)
    beta_d = _device_scalar(beta, z_p.device)
    alpha_d = _device_scalar(alpha_prev, z_p.device)
    w, pn, xn = (torch.empty_like(z_p) for _ in range(3))
    partials = _partials(shape, z_p.device)
    _build.launch(
        "tps_cgmv", _CGMV_ARGS, z_p.device,
        z_p.data_ptr(), p_p.data_ptr(), x_p.data_ptr(), diag_p.data_ptr(),
        beta_d.data_ptr(), alpha_d.data_ptr(), w.data_ptr(), pn.data_ptr(),
        xn.data_ptr(), partials.data_ptr(), *launch_args(shape, cx, cy, cz), int(pinned),
    )
    LAUNCHES["fused7_cgmv"] += 1
    return w, pn, xn, partials.sum()


def fused7_descentu(diag_p, cx, cy, cz, r_p, ap_p, s0, ad, g, gw, alpha, shape, pinned: bool, flegs=None):
    """``(x1, s, r', <r', r'>)``: the residual update r' = r - alpha ap and
    the degree-2 downstroke on r' (K9), in one launch of K3's kernel that
    forms r' once a cell as it stages the plane."""
    shape = tuple(shape)
    check_fields(shape, diag_p, r_p, ap_p)
    if r_p.device.type == "cpu":
        return fused7_descentu_torch(diag_p, cx, cy, cz, r_p, ap_p, s0, ad, g, gw, alpha, shape, pinned, flegs)
    _check_aligned(diag_p, r_p, ap_p)
    alpha_d = _device_scalar(alpha, r_p.device)
    x1, s, r_new = (torch.empty_like(r_p) for _ in range(3))
    plan = zmarch_plan(shape, "descentu")
    partials = _zmarch_partials(plan, True, r_p.device)
    _build.launch(
        "tps_descentu", _DESCENTU_ARGS, r_p.device,
        r_p.data_ptr(), ap_p.data_ptr(), alpha_d.data_ptr(), diag_p.data_ptr(),
        x1.data_ptr(), s.data_ptr(), r_new.data_ptr(), partials.data_ptr(),
        *launch_args(shape, cx, cy, cz, *_legs(cx, cy, cz, flegs)),
        float(s0), float(ad), float(g), float(gw), int(pinned), *plan.launch_args(),
    )
    LAUNCHES["fused7_descentu"] += 1
    return x1, s, r_new, partials.sum()


# --- the single-step modes (K10-K16) -------------------------------------------

def fused7_mv(diag_p, cx, cy, cz, x_p, shape, pinned: bool):
    """``A x``: mode ``mv`` is K1's function on K1's layout, so it launches
    K1 (``star7_mv_padded``, counted there)."""
    return star7_mv_padded(diag_p, cx, cy, cz, x_p, shape, pinned)


def fused7_residual(diag_p, cx, cy, cz, x_p, b_p, shape, pinned: bool):
    """``b - A x`` in one launch (K10)."""
    shape = tuple(shape)
    check_fields(shape, diag_p, x_p, b_p)
    if x_p.device.type == "cpu":
        return fused7_residual_torch(diag_p, cx, cy, cz, x_p, b_p, shape, pinned)
    r = torch.empty_like(x_p)
    _build.launch(
        "tps_residual", _RESIDUAL_ARGS, x_p.device,
        x_p.data_ptr(), b_p.data_ptr(), diag_p.data_ptr(), r.data_ptr(),
        *launch_args(shape, cx, cy, cz), int(pinned),
    )
    LAUNCHES["fused7_residual"] += 1
    return r


def fused7_rich(diag_p, cx, cy, cz, x_p, b_p, g, shape, pinned: bool):
    """``x + g D^-1 (b - A x)``: one Richardson sweep in one launch (K11)."""
    shape = tuple(shape)
    check_fields(shape, diag_p, x_p, b_p)
    if x_p.device.type == "cpu":
        return fused7_rich_torch(diag_p, cx, cy, cz, x_p, b_p, g, shape, pinned)
    out = torch.empty_like(x_p)
    _build.launch(
        "tps_rich", _RICH_ARGS, x_p.device,
        x_p.data_ptr(), b_p.data_ptr(), diag_p.data_ptr(), out.data_ptr(),
        *launch_args(shape, cx, cy, cz), float(g), int(pinned),
    )
    LAUNCHES["fused7_rich"] += 1
    return out


def fused7_cheb0(diag_p, cx, cy, cz, x_p, b_p, g, shape, pinned: bool):
    """``(x', d')`` with d' = g D^-1 (b - A x), x' = x + d': the first
    Chebyshev step from a nonzero x in one launch (K12)."""
    shape = tuple(shape)
    check_fields(shape, diag_p, x_p, b_p)
    if x_p.device.type == "cpu":
        return fused7_cheb0_torch(diag_p, cx, cy, cz, x_p, b_p, g, shape, pinned)
    xo, d = torch.empty_like(x_p), torch.empty_like(x_p)
    _build.launch(
        "tps_cheb0", _CHEB0_ARGS, x_p.device,
        x_p.data_ptr(), b_p.data_ptr(), diag_p.data_ptr(), xo.data_ptr(), d.data_ptr(),
        *launch_args(shape, cx, cy, cz), float(g), int(pinned),
    )
    LAUNCHES["fused7_cheb0"] += 1
    return xo, d


def fused7_cheb(diag_p, cx, cy, cz, x_p, b_p, d_p, ad, g, shape, pinned: bool):
    """``(x', d')`` with d' = ad d + g D^-1 (b - A x), x' = x + d': one
    later Chebyshev step in one launch (K13)."""
    shape = tuple(shape)
    check_fields(shape, diag_p, x_p, b_p, d_p)
    if x_p.device.type == "cpu":
        return fused7_cheb_torch(diag_p, cx, cy, cz, x_p, b_p, d_p, ad, g, shape, pinned)
    xo, d = torch.empty_like(x_p), torch.empty_like(x_p)
    _build.launch(
        "tps_cheb", _CHEB_ARGS, x_p.device,
        x_p.data_ptr(), b_p.data_ptr(), d_p.data_ptr(), diag_p.data_ptr(), xo.data_ptr(),
        d.data_ptr(), *launch_args(shape, cx, cy, cz), float(ad), float(g), int(pinned),
    )
    LAUNCHES["fused7_cheb"] += 1
    return xo, d


def fused7_pre2(diag_p, cx, cy, cz, b_p, s0, ad, g, shape, pinned: bool):
    """``(x', d')``: both Chebyshev pre-smoothing steps from a zero guess,
    u = (s0 b) D^-1, d' = ad u + g D^-1 (b - A u), x' = u + d', in one
    z-marching launch (K14)."""
    shape = tuple(shape)
    check_fields(shape, diag_p, b_p)
    if b_p.device.type == "cpu":
        return fused7_pre2_torch(diag_p, cx, cy, cz, b_p, s0, ad, g, shape, pinned)
    _check_aligned(diag_p, b_p)
    xo, d = torch.empty_like(b_p), torch.empty_like(b_p)
    _build.launch(
        "tps_pre2", _PRE2_ARGS, b_p.device,
        b_p.data_ptr(), diag_p.data_ptr(), xo.data_ptr(), d.data_ptr(),
        *launch_args(shape, cx, cy, cz), float(s0), float(ad), float(g), int(pinned),
        *zmarch_plan(shape, "pre2").launch_args(),
    )
    LAUNCHES["fused7_pre2"] += 1
    return xo, d


def fused7_restrict(diag_p, cx, cy, cz, r_p, g, shape, pinned: bool, flegs=None):
    """``r - g A_f (D^-1 r)``: the P^T smoothing pass in one z-marching
    launch (K15)."""
    shape = tuple(shape)
    check_fields(shape, diag_p, r_p)
    if r_p.device.type == "cpu":
        return fused7_restrict_torch(diag_p, cx, cy, cz, r_p, g, shape, pinned, flegs)
    _check_aligned(diag_p, r_p)
    s = torch.empty_like(r_p)
    _build.launch(
        "tps_restrict", _RESTRICT_ARGS, r_p.device,
        r_p.data_ptr(), diag_p.data_ptr(), s.data_ptr(),
        *launch_args(shape, *_legs(cx, cy, cz, flegs)), float(g), int(pinned),
        *zmarch_plan(shape, "restrict").launch_args(),
    )
    LAUNCHES["fused7_restrict"] += 1
    return s


def fused7_prolong(diag_p, cx, cy, cz, t_p, g, shape, pinned: bool, flegs=None):
    """``t - g D^-1 (A_f t)``: the P smoothing pass in one launch (K16)."""
    shape = tuple(shape)
    check_fields(shape, diag_p, t_p)
    if t_p.device.type == "cpu":
        return fused7_prolong_torch(diag_p, cx, cy, cz, t_p, g, shape, pinned, flegs)
    out = torch.empty_like(t_p)
    _build.launch(
        "tps_prolong", _PROLONG_ARGS, t_p.device,
        t_p.data_ptr(), diag_p.data_ptr(), out.data_ptr(),
        *launch_args(shape, *_legs(cx, cy, cz, flegs)), float(g), int(pinned),
    )
    LAUNCHES["fused7_prolong"] += 1
    return out

"""The launch plan and the schedule of the z-marching kernels
(``csrc/fused7.cu``: K3 ``descent_kernel``, K4 ``ascent_kernel``, K6
``descent1_kernel``, K7 ``ascent1_kernel``, K9 ``descent_kernel`` with the
residual update, and the halo-1 march of K15 ``restrict_kernel``, K2
``mvdot_kernel`` and K14 ``pre2_kernel``), on the CPU.

``zmarch_plan`` is what the CUDA entry points launch: its tiles and z-chunks
must cover every padded cell exactly once (faces and pads included, since
the kernels write every output cell), its partials count must be its block
count, its shared memory must fit a block and the blocks an SM must hold,
and 300^3 must fill the H100.  K3z/K4z's one launch over the stacked
slabs (``zmarch_slab_plan``) covers every slab exactly once, with its
z-chunks chosen by the plan's wave model.

The kernels themselves run only on the card (``test_torch_cuda.py``).  Here
``_emulate`` replays their schedule block by block with torch on the CPU:
the same loaded region, the three-plane shared rings rotated once a plane,
the lag of each step (one step behind the first in K2/K14/K15, two in
K6/K7, three in K3/K4/K9), the halo each step covers, and the masks by global
coordinates;
ring cells a step leaves unwritten are NaN, fresh at every rotation, so a
step that read one would show.  It must compute the plain twins' function
(which ``test_torch_kernels.py`` holds against the JAX package): K6's x1
bit for bit, the other outputs within the kernels' tolerances, every face
and pad cell 0.
"""

import math

import numpy as np
import pytest
import torch

from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil_device
from tpusparse_torch.kernels.fused7 import (
    H100_SMS,
    ZM_KERNELS,
    fused7_ascent1_rz_torch,
    fused7_ascent_rz_torch,
    fused7_descent1_rr_torch,
    fused7_descent_rr_torch,
    fused7_descentu_torch,
    fused7_mvdot_torch,
    fused7_pre2_torch,
    fused7_restrict_torch,
    zmarch_plan,
    zmarch_slab_plan,
)
from tpusparse_torch.kernels.stencil7 import FACE, padded_shape
from tpusparse_torch.sparse.padded import PaddedStar, pad_field

# the fused-kernel scalars of tests/test_fused7.py:32-36
G, AD, S0, GW, G2 = 0.731, 0.377, 1.618, 0.243, 0.519
# K9's alpha, as tests/test_torch_cuda.py hands it over
ALPHA = 0.37
KINDS = ["descent1", "ascent1", "descent", "ascent", "descentu", "restrict", "mvdot", "pre2"]
# the halo-1 kernels, one march (K15, K2, K14), and those of KINDS that take
# no filtered legs (they have no P-smoothing stage)
HALO1 = ("restrict", "mvdot", "pre2")
NO_FLEGS = ("mvdot", "pre2")
PLAN_SHAPES = [(1, 1, 1), (3, 2, 5), (2, 3, 1), (7, 5, 9), (40, 11, 13), (33, 25, 121),
               (64, 64, 64), (300, 300, 300)]
# H100: 227 KB of shared memory a block can have
SMEM_LIMIT = 232448


@pytest.mark.parametrize("kernel", KINDS)
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_zmarch_plan_covers_each_padded_cell_once(shape, kernel):
    plan = zmarch_plan(shape, kernel)
    nzp, ny, nxp = padded_shape(shape)
    axes = plan.ranges(shape)
    assert [len(r) for r in axes] == [plan.chunks, plan.tiles_y, plan.tiles_x]
    for n, ranges in zip((nzp, ny, nxp), axes):
        hits = np.zeros(n, dtype=np.int64)
        for lo, hi in ranges:
            assert lo < hi
            hits[lo:hi] += 1
        assert (hits == 1).all()
    if math.prod((nzp, ny, nxp)) <= 1 << 20:
        hits = np.zeros((nzp, ny, nxp), dtype=np.int64)
        for z0, z1 in axes[0]:
            for y0, y1 in axes[1]:
                for x0, x1 in axes[2]:
                    hits[z0:z1, y0:y1, x0:x1] += 1
        assert (hits == 1).all()


@pytest.mark.parametrize("kernel", KINDS)
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_zmarch_plan_partials_and_shared_memory(shape, kernel):
    plan = zmarch_plan(shape, kernel)
    spec = ZM_KERNELS[kernel]
    assert plan.blocks == plan.tiles_x * plan.tiles_y * plan.chunks
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    # the rings and the staging ring, each plane a region of f32 (64
    # columns, one quad a thread)
    assert plan.smem_bytes == (spec.ring_planes + sum(spec.stages)) * math.prod(plan.region) * 4
    assert plan.region == (spec.rows, 64) and plan.tile == (spec.rows - 2 * spec.halo, 56)
    assert plan.launch_args() == (plan.tiles_x, plan.tiles_y, plan.chunks, plan.zchunk, plan.smem_bytes)


@pytest.mark.parametrize("kernel", KINDS)
def test_zmarch_plan_fills_the_h100_at_300(kernel):
    plan = zmarch_plan((300, 300, 300), kernel)
    assert plan.waves(H100_SMS) >= 2
    # the blocks an SM must hold fit its 228 KB, 1 KB of it reserved per
    # block, with their static shared memory (a float a warp)
    warps = math.prod(plan.region) // 4 // 32
    assert plan.blocks_per_sm * (plan.smem_bytes + 4 * warps + 1024) <= 228 * 1024
    # and their registers: 64 K a SM, at most 255 a thread
    assert 65536 // (plan.blocks_per_sm * 32 * warps) >= 64
    # a chunk re-reads 2 H halo planes: at most a seventh more input bytes
    assert plan.zchunk >= 7 * 2 * ZM_KERNELS[kernel].halo


def test_unsharded_k3_k4_plans_are_unchanged_at_300():
    """K3/K4 (and K3'/K4') keep their plan: 7 chunks of 44 of the 306
    padded planes, 6 x 9 tiles, 378 blocks."""
    for kernel in ("descent", "ascent"):
        plan = zmarch_plan((300, 300, 300), kernel)
        assert (plan.tiles_x, plan.tiles_y, plan.chunks, plan.zchunk, plan.shards) == (6, 9, 7, 44, 1)
        assert plan.blocks == 378


# K3z/K4z's stacked slabs: (global shape, z-shards) of tests/test_torch_cuda.py's
# SLAB_SHAPES and 300^3 over 2 and 4 shards
SLAB_PLAN_CASES = [((12, 11, 13), 4), ((8, 2, 5), 2), ((40, 21, 61), 2), ((150, 13, 7), 2),
                   ((300, 300, 300), 2), ((300, 300, 300), 4)]


@pytest.mark.parametrize("kernel", ["descent", "ascent"])
@pytest.mark.parametrize("shape, p", SLAB_PLAN_CASES)
def test_zmarch_slab_plan_covers_each_slab_cell_once(shape, p, kernel):
    """One launch over the p stacked slabs: its blocks, decoded as the
    kernel decodes blockIdx.z (slab i = z // chunks), write every cell of
    the stack (p slabs of nz_l + 2 FACE planes) exactly once, and each block
    only cells of its own slab; the plan has K3'/K4''s tiles and shared
    bytes, and p times the chunks of one slab."""
    nz, ny, nx = shape
    local = (nz // p, ny, nx)
    plan = zmarch_slab_plan(local, kernel, p)
    one = zmarch_plan(local, kernel)
    assert (plan.tiles_x, plan.tiles_y, plan.smem_bytes, plan.region) == (
        one.tiles_x, one.tiles_y, one.smem_bytes, one.region)
    assert plan.shards == p and plan.blocks == one.tiles_x * one.tiles_y * plan.chunks * p
    nzp, _, nxp = padded_shape(local)
    assert plan.chunks == -(-nzp // plan.zchunk)   # what tps_descent / tps_ascent check
    zr, yr, xr = plan.ranges(local)
    assert len(zr) == p * plan.chunks
    hits = np.zeros(p * nzp, dtype=np.int64)
    for bz, (lo, hi) in enumerate(zr):
        i = bz // plan.chunks
        assert i * nzp <= lo < hi <= (i + 1) * nzp
        hits[lo:hi] += 1
    assert (hits == 1).all()
    for n, ranges in ((ny, yr), (nxp, xr)):
        hits = np.zeros(n, dtype=np.int64)
        for lo, hi in ranges:
            hits[lo:hi] += 1
        assert (hits == 1).all()


def _slab_cost(blocks_per_chunk, chunks, zchunk, halo=3):
    """The slab plan's model: waves (rounded up) times planes marched."""
    return -(-blocks_per_chunk * chunks // H100_SMS) * (zchunk + 2 * halo)


@pytest.mark.parametrize("kernel", ["descent", "ascent"])
def test_zmarch_slab_plan_fills_whole_waves_at_300_over_4(kernel):
    """At 300^3 over 4 shards (nz_l = 75, 81 padded planes a slab, 54
    tiles) the rule takes 3 chunks of 27: 648 blocks, 4.91 waves of one
    block an SM, cost 5 x 33 = 165 against 188 for a slab's own 2 chunks of
    41 (4 waves of 47) and 174 for 1 chunk of 81 (2 of 87); no chunk count
    costs less.  One slab alone (q = 1) keeps 2 chunks of 41."""
    plan = zmarch_slab_plan((75, 300, 300), kernel, 4)
    assert (plan.chunks, plan.zchunk, plan.blocks) == (3, 27, 648)
    assert plan.waves(H100_SMS) == pytest.approx(648 / 132)
    per_chunk = plan.tiles_x * plan.tiles_y * 4
    assert _slab_cost(per_chunk, 3, 27) == 165
    assert (_slab_cost(per_chunk, 2, 41), _slab_cost(per_chunk, 1, 81)) == (188, 174)
    for n in range(1, 82):
        zchunk = -(-81 // n)
        assert _slab_cost(per_chunk, -(-81 // zchunk), zchunk) >= 165
    single = zmarch_slab_plan((75, 300, 300), kernel, 1)
    assert (single.chunks, single.zchunk, single.blocks) == (2, 41, 108)


# --- the schedule, replayed ---------------------------------------------------

def _system(shape, pinned):
    nz, ny, nx = shape
    star = poisson_stencil_device(Grid3D(nx, ny, nz), pin=pinned, dtype=torch.float32, device="cpu")[0]
    op = PaddedStar.from_star(star)
    rng = np.random.default_rng(7)
    t, b, x1 = (pad_field(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)))
                for _ in range(3))
    return op, t, b, x1


class _Ring:
    """Three shared planes of the region, rotated as the kernel's ``Ring``;
    the plane a rotation makes writable starts as NaN."""

    def __init__(self, region):
        self.region = region
        self.slots = [torch.full(region, float("nan")) for _ in range(3)]

    def rotate(self):
        self.slots = self.slots[1:] + [torch.full(self.region, float("nan"))]

    def plane(self, n):
        return self.slots[n]


def _star(ring, center, k, j, i, legs, pin, sl):
    """``quad_star`` on the region cells ``sl`` (a pair of slices), reading
    the ring's planes with no domain masks (the ring holds 0 off the
    domain) and testing the pinned origin only where ``pin``; (k, j, i)
    are global, j and i region-shaped."""
    lo, mid, hi = (ring.plane(n) for n in range(3))
    ys, xs = sl
    jj, ii = j[sl], i[sl]
    zero = torch.zeros(())

    def nb(dy, dx):
        return mid[ys.start + dy:ys.stop + dy, xs.start + dx:xs.stop + dx]

    xm, xp, ym, yp, zm, zp = nb(0, -1), nb(0, 1), nb(-1, 0), nb(1, 0), lo[sl], hi[sl]
    if pin:
        xm = torch.where((k == 0) & (jj == 0) & (ii == 1), zero, xm)
        ym = torch.where((k == 0) & (jj == 1) & (ii == 0), zero, ym)
        zm = torch.where((k == 1) & (jj == 0) & (ii == 0), zero, zm)
    cx, cy, cz = legs
    w = center + cx * (xp + xm) + cy * (yp + ym) + cz * (zp + zm)
    if pin:
        w = torch.where((k == 0) & (jj == 0) & (ii == 0), center, w)
    return w


def _emulate(kind, op, fields, shape, pinned, flegs):
    """K3 (``kind`` "descent", fields (b,)), K4 ("ascent", fields (t, b,
    x1)), K6 ("descent1", (b,)), K7 ("ascent1", (t, b, x1)), K9
    ("descentu", (r, ap): K3 on r' = r - ALPHA ap, formed at step 0 and
    written there on the tile as a third output), K15 ("restrict", (r,)),
    K2 ("mvdot", (x,)) or K14 ("pre2", (b,): outputs x' and d') as the
    kernel schedules it: (outputs..., dot; K15's and K14's 0).  Per plane p
    of a block's march, H + 1 steps: step 0 on plane p over the whole
    region, step n on plane p - n
    over the tile plus H - n cells a side (``cells(n)``), reading its
    stencil from step n - 1's ring.  The kernel's threads compute whole
    quads of step n's rows, whose cells outside ``cells(n)`` no step reads
    (here they stay NaN).  What a thread carries across the lag (its D^-1,
    K3's r, K4's d) or reads again from staging (b, diag) is the plane's
    own: ``planes[q]``; K2's centre term is diag x, K14's s0 b and K15's r."""
    nz, ny, nx = shape
    nzp, _, nxp = padded_shape(shape)
    spec = ZM_KERNELS[kind]
    h = spec.halo
    plan = zmarch_plan(shape, kind)
    ty, tx = plan.tile
    region = plan.region
    hx = (region[1] - tx) // 2

    def cells(n):
        return slice(n, region[0] - n), slice(hx - h + n, hx + tx + h - n)

    tile = cells(h)
    zero = torch.zeros(())
    a = (float(op.cx), float(op.cy), float(op.cz))
    f = a if flegs is None else flegs
    k3 = kind in ("descent", "descentu")
    n_outs = {"descent": 2, "descent1": 2, "descentu": 3, "pre2": 2}.get(kind, 1)
    outs = [torch.full((nzp, ny, nxp), float("nan")) for _ in range(n_outs)]
    partials = []
    zr, yr, xr = plan.ranges(shape)
    for z0, z1 in zr:
        for y0, _ in yr:
            for x0, _ in xr:
                j = torch.arange(y0 - h, y0 - h + region[0])[:, None].expand(region)
                i = torch.arange(x0 - hx, x0 - hx + region[1])[None, :].expand(region)
                dom = (j >= 0) & (j < ny) & (i >= 0) & (i < nx)
                field = (j[tile] < ny) & (i[tile] < nxp)     # the last step's writes

                def dp(q):
                    return FACE <= q < FACE + nz

                def load(fld, q):
                    v = torch.zeros(region)
                    if dp(q):
                        v[dom] = fld[q][j[dom], i[dom]]
                    return v

                def write(o, q, val):
                    o[q][j[tile][field], i[tile][field]] = val[field]

                def sel(q, sl, v):
                    return torch.where((dom & dp(q))[sl], v, zero)

                # pins_origin: the first tile, and a chunk whose march
                # reaches domain plane 1
                pin = pinned and (y0, x0) == (0, 0) and z0 - h <= FACE + 1

                def star(ring, q, legs, sl):
                    center = planes[q]["d"][sl] * ring.plane(1)[sl]
                    return _star(ring, center, q - FACE, j, i, legs, pin, sl)

                rings = [_Ring(region) for _ in range(h)]
                planes = {}
                dot = torch.zeros(())
                for p in range(z0 - h, z1 + h):
                    for ring in rings:
                        ring.rotate()
                    d = torch.where(dom & dp(p), load(op.diag, p), torch.ones(()))
                    v = planes[p] = dict(d=d, dinv=1.0 / d)
                    planes.pop(p - h - 1, None)
                    if kind in HALO1:
                        v["b"] = load(fields[0], p)             # r, x or b
                        rings[0].slots[2] = {"restrict": v["b"] * v["dinv"], "mvdot": v["b"],
                                             "pre2": (S0 * v["b"]) * v["dinv"]}[kind]
                    elif kind.startswith("descent"):
                        v["b"] = load(fields[0], p)
                        if kind == "descentu":
                            v["b"] = v["b"] - ALPHA * load(fields[1], p)
                            if z0 <= p < z1:
                                write(outs[2], p, v["b"][tile])
                        if z0 <= p < z1:
                            dot += (v["b"][tile][field] ** 2).sum()
                        if kind == "descent1":
                            rings[0].slots[2] = G * (v["b"] * v["dinv"])
                        else:
                            rings[0].slots[2] = (S0 * v["b"]) * v["dinv"]
                    else:
                        v.update(t=load(fields[0], p), b=load(fields[1], p), x1=load(fields[2], p))
                        rings[0].slots[2] = v["t"]
                    for n in range(1, h + 1):
                        q = p - n
                        if q < z0 - h + n:
                            continue
                        sl = cells(n)
                        c, prev = planes[q], rings[n - 1]
                        mid = prev.plane(1)[sl]
                        if kind == "restrict":
                            # the centre term is r itself (diag D^-1 r == r)
                            w = _star(prev, c["b"][sl], q - FACE, j, i, f, pin, sl)
                            write(outs[0], q, sel(q, sl, c["b"][sl] - GW * w))
                        elif kind == "mvdot":
                            y = sel(q, sl, star(prev, q, a, sl))
                            dot += (c["b"][sl] * y).sum()
                            write(outs[0], q, y)
                        elif kind == "pre2":
                            w = _star(prev, S0 * c["b"][sl], q - FACE, j, i, a, pin, sl)
                            dd = sel(q, sl, AD * mid + G * (c["dinv"][sl] * (c["b"][sl] - w)))
                            write(outs[0], q, sel(q, sl, mid + dd))
                            write(outs[1], q, dd)
                        elif kind == "descent1" and n == 1:
                            c["r"] = sel(q, sl, c["b"][sl] - star(prev, q, a, sl))
                            rings[1].slots[2][sl] = c["r"] * c["dinv"][sl]
                        elif kind == "descent1":
                            r = c["r"][1:-1, 1:-1]              # step 1's cells, cut to the tile
                            write(outs[0], q, rings[0].plane(0)[sl])
                            write(outs[1], q, sel(q, sl, r - GW * star(prev, q, f, sl)))
                        elif kind == "ascent1" and n == 1:
                            x2 = c["x1"][sl] + mid - GW * (c["dinv"][sl] * star(prev, q, f, sl))
                            rings[1].slots[2][sl] = sel(q, sl, x2)
                        elif kind == "ascent1":
                            x3 = sel(q, sl, mid + G * (c["dinv"][sl] * (c["b"][sl] - star(prev, q, a, sl))))
                            dot += (c["b"][sl] * x3).sum()
                            write(outs[0], q, x3)
                        elif k3 and n == 1:
                            x1 = mid + AD * mid + G * (c["dinv"][sl] * (c["b"][sl] - star(prev, q, a, sl)))
                            rings[1].slots[2][sl] = sel(q, sl, x1)
                        elif k3 and n == 2:
                            c["r"] = sel(q, sl, c["b"][sl] - star(prev, q, a, sl))
                            rings[2].slots[2][sl] = c["r"] * c["dinv"][sl]
                        elif k3:
                            r = c["r"][1:-1, 1:-1]              # step 2's cells, cut to the tile
                            write(outs[0], q, rings[1].plane(0)[sl])
                            write(outs[1], q, sel(q, sl, r - GW * star(prev, q, f, sl)))
                        elif n == 1:                           # ascent
                            x2 = c["x1"][sl] + mid - GW * (c["dinv"][sl] * star(prev, q, f, sl))
                            rings[1].slots[2][sl] = sel(q, sl, x2)
                        elif n == 2:
                            c["dd"] = sel(q, sl, G * (c["dinv"][sl] * (c["b"][sl] - star(prev, q, a, sl))))
                            rings[2].slots[2][sl] = sel(q, sl, mid + c["dd"])
                        else:
                            x4 = sel(q, sl, mid + AD * c["dd"][1:-1, 1:-1]
                                     + G2 * (c["dinv"][sl] * (c["b"][sl] - star(prev, q, a, sl))))
                            dot += (c["b"][sl] * x4).sum()
                            write(outs[0], q, x4)
                partials.append(dot)
    assert len(partials) == plan.blocks
    return (*outs, torch.stack(partials).sum())


def _in_domain(shape):
    nz, ny, nx = shape
    nzp, _, nxp = padded_shape(shape)
    m = torch.zeros((nzp, ny, nxp), dtype=torch.bool)
    m[FACE:FACE + nz, :, :nx] = True
    return m


# ragged shapes: several tiles in y and x, several chunks, and depths,
# heights and widths of 1-3 cells (not one cell alone: its Neumann row is
# zero, and D^-1 with it); ny = 21 and 57 cut both tiles (26 and 12 rows)
# raggedly, nz = 60, 75 and 100 the z-chunks
SCHEDULE_SHAPES = [(1, 2, 1), (3, 2, 5), (2, 3, 1), (2, 1, 3), (40, 13, 61), (70, 25, 3), (75, 21, 13),
                   (100, 21, 61), (60, 57, 13)]


# (kind, shape, pinned, flegs), the filtered legs only for the kernels that
# take them
SCHEDULE_CASES = [
    pytest.param(kind, shape, pinned, flegs, id=f"{kind}-shape{n}-{pinned}-{flegs}")
    for kind in KINDS for n, shape in enumerate(SCHEDULE_SHAPES) for pinned in (True, False)
    for flegs in ((None,) if kind in NO_FLEGS else (None, "z"))
]


@pytest.mark.parametrize("kind, shape, pinned, flegs", SCHEDULE_CASES)
def test_zmarch_schedule_computes_the_twin(kind, shape, pinned, flegs):
    op, t, b, x1 = _system(shape, pinned)
    legs = None if flegs is None else (float(op.cx), float(op.cy), 0.0)
    args = (op.diag, op.cx, op.cy, op.cz)
    if kind == "descent1":
        got = _emulate(kind, op, (b,), shape, pinned, legs)
        want = fused7_descent1_rr_torch(*args, b, G, GW, shape, pinned, legs)
        # x1: the same two products of the same IEEE reciprocal
        assert torch.equal(got[0], want[0])
    elif kind == "descent":
        got = _emulate(kind, op, (b,), shape, pinned, legs)
        want = fused7_descent_rr_torch(*args, b, S0, AD, G, GW, shape, pinned, legs)
    elif kind == "descentu":
        # r = b, ap = t
        got = _emulate(kind, op, (b, t), shape, pinned, legs)
        want = fused7_descentu_torch(*args, b, t, S0, AD, G, GW, ALPHA, shape, pinned, legs)
    elif kind == "restrict":
        got = _emulate(kind, op, (b,), shape, pinned, legs)[:1]
        want = (fused7_restrict_torch(*args, b, GW, shape, pinned, legs),)
    elif kind == "mvdot":
        # x = t
        got = _emulate(kind, op, (t,), shape, pinned, legs)
        want = fused7_mvdot_torch(*args, t, shape, pinned)
    elif kind == "pre2":
        got = _emulate(kind, op, (b,), shape, pinned, legs)[:2]
        want = fused7_pre2_torch(*args, b, S0, AD, G, shape, pinned)
    elif kind == "ascent1":
        got = _emulate(kind, op, (t, b, x1), shape, pinned, legs)
        want = fused7_ascent1_rz_torch(*args, t, b, x1, G, GW, shape, pinned, legs)
    else:
        got = _emulate(kind, op, (t, b, x1), shape, pinned, legs)
        want = fused7_ascent_rz_torch(*args, t, b, x1, G, AD, G2, GW, shape, pinned, legs)
    dotless = kind in ("restrict", "pre2")
    fields = got if dotless else got[:-1]
    outside = ~_in_domain(shape)
    for g_, w_ in zip(fields, want):
        assert not torch.isnan(g_).any()           # every cell written
        assert (g_[outside] == 0).all()            # faces and pads exactly 0
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-6 * w_.abs().max().item())
    if dotless:
        return
    # K4's <b, x4> at a handful of cells can cancel to 1% of its terms:
    # held, as chip_smoke.py::_dot_agrees holds it, to 1e-5 of the sum of
    # their magnitudes
    scale = (b * want[0]).abs().sum() if kind == "ascent" else want[-1].abs()
    assert abs(got[-1].item() - want[-1].item()) <= 1e-5 * scale.item()

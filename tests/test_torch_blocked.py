"""The launch plan and the schedule of the z-marching K6/K7 kernels
(``csrc/fused7.cu``: ``descent1_kernel``, ``ascent1_kernel``), on the CPU.

``zmarch_plan`` is what the CUDA entry points launch: its tiles and z-chunks
must cover every padded cell exactly once (faces and pads included, since
the kernels write every output cell), its partials count must be its block
count, its shared memory must fit a block, and 300^3 must fill the H100.

The kernels themselves run only on the card (``test_torch_cuda.py``).  Here
``_emulate`` replays their schedule block by block with torch on the CPU:
the same loaded region, the three-plane shared rings rotated once a plane,
the lags of steps 2 and 3, the halo each step covers, and the masks by
global coordinates; ring cells a step leaves unwritten start as NaN, so a
step that read one would show.  It must compute the plain twins' function
(which ``test_torch_kernels.py`` holds against the JAX package): x1 bit for
bit, s and x3 within the kernels' tolerances, every face and pad cell 0.
"""

import math

import numpy as np
import pytest
import torch

from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil_device
from tpusparse_torch.kernels.fused7 import (
    H100_SMS,
    ZM_HALO,
    ZM_TILE,
    fused7_ascent1_rz_torch,
    fused7_descent1_rr_torch,
    zmarch_plan,
)
from tpusparse_torch.kernels.stencil7 import FACE, padded_shape
from tpusparse_torch.sparse.padded import PaddedStar, pad_field

# the fused-kernel scalars of tests/test_fused7.py:32-36
G, GW = 0.731, 0.243
PLAN_SHAPES = [(1, 1, 1), (3, 2, 5), (2, 3, 1), (7, 5, 9), (40, 11, 13), (33, 25, 121),
               (64, 64, 64), (300, 300, 300)]
# H100: 227 KB of shared memory a block can have
SMEM_LIMIT = 232448


@pytest.mark.parametrize("kernel", ["descent1", "ascent1"])
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


@pytest.mark.parametrize("kernel", ["descent1", "ascent1"])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_zmarch_plan_partials_and_shared_memory(shape, kernel):
    plan = zmarch_plan(shape, kernel)
    assert plan.blocks == plan.tiles_x * plan.tiles_y * plan.chunks
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    assert plan.launch_args() == (plan.tiles_x, plan.tiles_y, plan.chunks, plan.zchunk, plan.smem_bytes)


@pytest.mark.parametrize("kernel", ["descent1", "ascent1"])
def test_zmarch_plan_fills_the_h100_at_300(kernel):
    plan = zmarch_plan((300, 300, 300), kernel)
    assert plan.waves(H100_SMS) >= 2
    # the blocks an SM must hold fit its 228 KB, 1 KB of it reserved per
    # block, with their 32 bytes of static shared memory
    assert plan.blocks_per_sm * (plan.smem_bytes + 32 + 1024) <= 228 * 1024
    # a chunk re-reads 4 halo planes: at most an eighth more input bytes
    assert plan.zchunk >= 28


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
    """Three shared planes of the region, rotated as the kernel's ``Ring``."""

    def __init__(self, region):
        self.slots = [torch.full(region, float("nan")) for _ in range(3)]

    def rotate(self):
        self.slots = self.slots[1:] + self.slots[:1]

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
    """K6 (``kind`` "descent1", fields (b,)) or K7 ("ascent1", fields (t, b,
    x1)) as the kernel schedules it: (outputs..., dot).  Step 2 covers the
    tile plus a cell a side (``s1``), step 3 the tile (``s0``); the kernel's
    threads compute whole quads of step 2's rows, whose cells outside
    ``s1`` no step reads (here they stay NaN)."""
    nz, ny, nx = shape
    nzp, _, nxp = padded_shape(shape)
    plan = zmarch_plan(shape, kind)
    ty, tx = ZM_TILE
    hy, hx = ZM_HALO
    region = (ty + 2 * hy, tx + 2 * hx)
    s1 = (slice(hy - 1, hy + ty + 1), slice(hx - 1, hx + tx + 1))
    s0 = (slice(hy, hy + ty), slice(hx, hx + tx))
    zero = torch.zeros(())
    a = (float(op.cx), float(op.cy), float(op.cz))
    f = a if flegs is None else flegs
    outs = [torch.full((nzp, ny, nxp), float("nan")) for _ in range(2 if kind == "descent1" else 1)]
    partials = []
    zr, yr, xr = plan.ranges(shape)
    for z0, z1 in zr:
        for y0, _ in yr:
            for x0, _ in xr:
                j = torch.arange(y0 - hy, y0 + ty + hy)[:, None].expand(region)
                i = torch.arange(x0 - hx, x0 + tx + hx)[None, :].expand(region)
                dom = (j >= 0) & (j < ny) & (i >= 0) & (i < nx)
                field = (j[s0] < ny) & (i[s0] < nxp)     # step 3's writes

                def load(fld, p):
                    v = torch.zeros(region)
                    if FACE <= p < FACE + nz:
                        v[dom] = fld[p][j[dom], i[dom]]
                    return v

                def write(o, p, val):
                    o[p][j[s0][field], i[s0][field]] = val[field]

                # pins_origin: the first tile, and a chunk whose march reaches
                # domain plane 1
                pin = pinned and (y0, x0) == (0, 0) and z0 - 2 <= FACE + 1
                r_a, r_b = _Ring(region), _Ring(region)
                dot = torch.zeros(())
                lag = {}
                for p in range(z0 - 2, z1 + 2):
                    k1, k2 = p - 1 - FACE, p - 2 - FACE
                    dp1, dp2 = (FACE <= q < FACE + nz for q in (p - 1, p - 2))
                    r_a.rotate()
                    r_b.rotate()
                    d0 = torch.where(dom & (FACE <= p < FACE + nz), load(op.diag, p), torch.ones(()))
                    dinv0 = 1.0 / d0
                    if kind == "descent1":
                        b0 = load(fields[0], p)
                        x10 = G * (b0 * dinv0)
                        r_a.slots[2] = x10.clone()
                        if z0 <= p < z1:
                            dot += (b0[s0][field] ** 2).sum()
                        r1 = torch.zeros(region)
                        if p - 1 >= z0 - 1:
                            w = _star(r_a, (lag[1]["d"] * lag[1]["x1"])[s1], k1, j, i, a, pin, s1)
                            r1[s1] = torch.where((dom & dp1)[s1], lag[1]["b"][s1] - w, zero)
                            r_b.slots[2][s1] = (r1 * lag[1]["dinv"])[s1]
                        if p - 2 >= z0:
                            w = _star(r_b, lag[2]["d"][s0] * r_b.plane(1)[s0], k2, j, i, f, pin, s0)
                            s = torch.where((dom & dp2)[s0], lag[2]["r"][s0] - GW * w, zero)
                            write(outs[0], p - 2, lag[2]["x1"][s0])
                            write(outs[1], p - 2, s)
                        lag[2] = dict(d=lag.get(1, {}).get("d"), r=r1, x1=lag.get(1, {}).get("x1"))
                        lag[1] = dict(b=b0, d=d0, dinv=dinv0, x1=x10)
                    else:
                        r_a.slots[2] = load(fields[0], p)
                        if p - 1 >= z0 - 1:
                            tc = r_a.plane(1)[s1]
                            w = _star(r_a, lag[1]["d"][s1] * tc, k1, j, i, f, pin, s1)
                            x2 = lag[1]["x1"][s1] + tc - GW * (lag[1]["dinv"][s1] * w)
                            r_b.slots[2][s1] = torch.where((dom & dp1)[s1], x2, zero)
                        if p - 2 >= z0:
                            x2 = r_b.plane(1)[s0]
                            w = _star(r_b, lag[2]["d"][s0] * x2, k2, j, i, a, pin, s0)
                            b2 = lag[2]["b"][s0]
                            x3 = torch.where((dom & dp2)[s0], x2 + G * (lag[2]["dinv"][s0] * (b2 - w)), zero)
                            dot += (b2 * x3).sum()
                            write(outs[0], p - 2, x3)
                        lag[2] = lag.get(1)
                        lag[1] = dict(x1=load(fields[2], p), d=d0, dinv=dinv0, b=load(fields[1], p))
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
# zero, and D^-1 with it)
SCHEDULE_SHAPES = [(1, 2, 1), (3, 2, 5), (2, 3, 1), (2, 1, 3), (40, 13, 61), (70, 25, 3)]


@pytest.mark.parametrize("flegs", [None, "z"])
@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("shape", SCHEDULE_SHAPES)
@pytest.mark.parametrize("kind", ["descent1", "ascent1"])
def test_zmarch_schedule_computes_the_twin(kind, shape, pinned, flegs):
    op, t, b, x1 = _system(shape, pinned)
    legs = None if flegs is None else (float(op.cx), float(op.cy), 0.0)
    args = (op.diag, op.cx, op.cy, op.cz)
    if kind == "descent1":
        got = _emulate(kind, op, (b,), shape, pinned, legs)
        want = fused7_descent1_rr_torch(*args, b, G, GW, shape, pinned, legs)
        # x1: the same two products of the same IEEE reciprocal
        assert torch.equal(got[0], want[0])
    else:
        got = _emulate(kind, op, (t, b, x1), shape, pinned, legs)
        want = fused7_ascent1_rz_torch(*args, t, b, x1, G, GW, shape, pinned, legs)
    outside = ~_in_domain(shape)
    for g_, w_ in zip(got[:-1], want[:-1]):
        assert not torch.isnan(g_).any()           # every cell written
        assert (g_[outside] == 0).all()            # faces and pads exactly 0
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-6 * w_.abs().max().item())
    assert abs(got[-1].item() - want[-1].item()) <= 1e-5 * abs(want[-1].item())

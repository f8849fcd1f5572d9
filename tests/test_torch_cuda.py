"""On the card: every CUDA kernel of ``tpusparse_torch`` against its plain
PyTorch twin at small ragged shapes (the P-smoothing stages also with
filtered legs; the z-marching K2-K4, K6/K7, their dot-free forms, K9, K14
and K15 also at shapes of 1-3 cells and several tiles and z-chunks, with
their face and pad cells),
small stencil (padded, full-fusion, plain layout, the
unfused padded cycle, W-cycle, threshold schedule, the plain-only GAMG
options and the standalone PCs, the z-sharded route), aij (structure-blind and lifted),
uniform-precision aij, bf16-hierarchy and reference-config solves on the
card against the same solves on the CPU, ``bench.itprof`` at 24^3, and
K1p over a stack (``star7_mv_batched``) with the ``KSP`` object's solve,
reuse and ``mat_solve`` at 18^3 against the CPU, and K5 over a stack
(``dia_mv_batched``) with the file route, ``mat_solve`` on a DIA operator
and the structure-blind aij route in uniform precision against the CPU,
and K5 with 49-192 bands, ELL and the factored transfer (same bits twice),
and the greedy, banded and block-Jacobi-level aij routes at 16^3 against
the CPU.

These tests need a CUDA device and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m requires_cuda --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from tpusparse_torch import KSP, kernels
from tpusparse_torch.kernels import _build
from tpusparse_torch.amg.hierarchy import AMGParams
from tpusparse_torch.bench import itprof
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.bench.driver import solve_from_file
from tpusparse_torch.grid.poisson import assemble_poisson, poisson_dia_device, poisson_stencil_device
from tpusparse_torch.kernels.diaband import dia_mv, dia_mv_batched, dia_mv_torch
from tpusparse_torch.sparse.dia import DIA
from tpusparse_torch.sparse.io import save_petsc_mat, save_petsc_vec
from tpusparse_torch.dist.fused_sharded import FusedSharded
from tpusparse_torch.dist.mesh import make_z_mesh
from tpusparse_torch.kernels.fused7 import (
    _ASCENT_ARGS,
    _DESCENT1_ARGS,
    _DESCENT_ARGS,
    _DESCENTU_ARGS,
    _MVDOT_ARGS,
    _PRE2_ARGS,
    _RESTRICT_ARGS,
    ZMARCH_WRAPPERS,
    fused7_ascent,
    fused7_ascent1,
    fused7_ascent1_rz,
    fused7_ascent1_rz_torch,
    fused7_ascent1_torch,
    fused7_ascent_rz,
    fused7_ascent_rz_torch,
    fused7_ascent_slab,
    fused7_ascent_slab_torch,
    fused7_ascent_torch,
    fused7_cgmv,
    fused7_cgmv_torch,
    fused7_descent,
    fused7_descent1,
    fused7_descent1_rr,
    fused7_descent1_rr_torch,
    fused7_descent1_torch,
    fused7_descent_rr,
    fused7_descent_rr_torch,
    fused7_descent_slab,
    fused7_descent_slab_torch,
    fused7_descent_torch,
    fused7_cheb,
    fused7_cheb0,
    fused7_cheb0_torch,
    fused7_cheb_torch,
    fused7_descentu,
    fused7_descentu_torch,
    fused7_mvdot,
    fused7_mvdot_torch,
    fused7_pre2,
    fused7_pre2_torch,
    fused7_prolong,
    fused7_prolong_torch,
    fused7_residual,
    fused7_residual_torch,
    fused7_restrict,
    fused7_restrict_torch,
    fused7_rich,
    fused7_rich_torch,
    zmarch_plan,
    zmarch_slab_plan,
)
from tpusparse_torch.kernels.stencil7 import (
    FACE,
    launch_args,
    padded_shape,
    star7_mv,
    star7_mv_batched,
    star7_mv_padded,
    star7_mv_padded_torch,
    star7_mv_torch,
)
from tpusparse_torch.sparse.padded import PaddedStar, crop_field, pad_field

pytestmark = pytest.mark.requires_cuda

# the fused-kernel scalars of tests/test_fused7.py:32-36
G, AD, S0, GW, G2 = 0.731, 0.377, 1.618, 0.243, 0.519

CASES = {
    "star7_mv_padded": (star7_mv_padded, star7_mv_padded_torch),
    "fused7_mvdot": (fused7_mvdot, fused7_mvdot_torch),
    "fused7_descent_rr": (fused7_descent_rr, fused7_descent_rr_torch),
    "fused7_ascent_rz": (fused7_ascent_rz, fused7_ascent_rz_torch),
    "fused7_descent": (fused7_descent, fused7_descent_torch),
    "fused7_ascent": (fused7_ascent, fused7_ascent_torch),
    "fused7_descent1_rr": (fused7_descent1_rr, fused7_descent1_rr_torch),
    "fused7_ascent1_rz": (fused7_ascent1_rz, fused7_ascent1_rz_torch),
    "fused7_descent1": (fused7_descent1, fused7_descent1_torch),
    "fused7_ascent1": (fused7_ascent1, fused7_ascent1_torch),
    "fused7_cgmv": (fused7_cgmv, fused7_cgmv_torch),
    "fused7_descentu": (fused7_descentu, fused7_descentu_torch),
    "star7_mv": (star7_mv, star7_mv_torch),
    "fused7_residual": (fused7_residual, fused7_residual_torch),
    "fused7_rich": (fused7_rich, fused7_rich_torch),
    "fused7_cheb0": (fused7_cheb0, fused7_cheb0_torch),
    "fused7_cheb": (fused7_cheb, fused7_cheb_torch),
    "fused7_pre2": (fused7_pre2, fused7_pre2_torch),
    "fused7_restrict": (fused7_restrict, fused7_restrict_torch),
    "fused7_prolong": (fused7_prolong, fused7_prolong_torch),
}
# the kernels with P-smoothing stages, which take the filtered legs
FLEGS = (
    "fused7_descent_rr", "fused7_ascent_rz", "fused7_descent", "fused7_ascent",
    "fused7_descent1_rr", "fused7_ascent1_rz", "fused7_descent1", "fused7_ascent1",
    "fused7_descentu", "fused7_restrict", "fused7_prolong",
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


def _args(name, shape, pinned, device):
    nz, ny, nx = shape
    star = poisson_stencil_device(Grid3D(nx, ny, nz), pin=pinned, dtype=torch.float32, device=device)[0]
    op = PaddedStar.from_star(star)
    rng = np.random.default_rng(7)
    x, b, x1 = (
        pad_field(torch.tensor(rng.standard_normal(shape, dtype=np.float32), device=device))
        for _ in range(3)
    )
    # the CG scalars of K8/K9 as 0-d device tensors, as cg hands them over
    beta, alpha = (torch.tensor(v, dtype=torch.float32, device=device) for v in (0.61, 0.37))
    legs = (op.diag, op.cx, op.cy, op.cz)
    return {
        "star7_mv": (star.diag, star.cx, star.cy, star.cz, b[3:3 + nz, :, :nx].contiguous(), pinned),
        "fused7_cgmv": (*legs, x, b, x1, beta, alpha, shape, pinned),
        "fused7_descentu": (*legs, b, x, S0, AD, G, GW, alpha, shape, pinned),
        "star7_mv_padded": (*legs, x, shape, pinned),
        "fused7_mvdot": (*legs, x, shape, pinned),
        "fused7_descent_rr": (*legs, b, S0, AD, G, GW, shape, pinned),
        "fused7_ascent_rz": (*legs, x, b, x1, G, AD, G2, GW, shape, pinned),
        "fused7_descent": (*legs, b, S0, AD, G, GW, shape, pinned),
        "fused7_ascent": (*legs, x, b, x1, G, AD, G2, GW, shape, pinned),
        "fused7_descent1_rr": (*legs, b, G, GW, shape, pinned),
        "fused7_ascent1_rz": (*legs, x, b, x1, G, GW, shape, pinned),
        "fused7_descent1": (*legs, b, G, GW, shape, pinned),
        "fused7_ascent1": (*legs, x, b, x1, G, GW, shape, pinned),
        "fused7_residual": (*legs, x, b, shape, pinned),
        "fused7_rich": (*legs, x, b, G, shape, pinned),
        "fused7_cheb0": (*legs, x, b, G, shape, pinned),
        "fused7_cheb": (*legs, x, b, x1, AD, G, shape, pinned),
        "fused7_pre2": (*legs, b, S0, AD, G, shape, pinned),
        "fused7_restrict": (*legs, x, GW, shape, pinned),
        "fused7_prolong": (*legs, x, GW, shape, pinned),
    }[name]


def _close(got, want, device):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g_, w_ in zip(got, want):
        assert g_.device == device and g_.shape == w_.shape
        if w_.dim() == 0:
            assert abs(g_.item() - w_.item()) <= 1e-5 * abs(w_.item())
        else:
            # tests/test_fused7.py:53-69, atol from each output's own range
            atol = 1e-6 * w_.abs().max().item()
            torch.testing.assert_close(g_, w_, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("shape", [(40, 11, 13), (7, 5, 9), (12, 12, 12), (3, 2, 1)])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_twin(cuda, name, shape, pinned):
    kernel, twin = CASES[name]
    args = _args(name, shape, pinned, cuda)
    before = kernels.LAUNCHES[name]
    got, want = kernel(*args), twin(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    _close(got, want, cuda)


@pytest.mark.parametrize("drop", ["z", "xy"])
@pytest.mark.parametrize("shape", [(40, 11, 13), (7, 5, 9)])
@pytest.mark.parametrize("name", FLEGS)
def test_kernel_with_filtered_legs_matches_twin(cuda, name, shape, drop):
    """The P-smoothing stages with the threshold schedule's filtered legs
    (z dropped, or y and x)."""
    kernel, twin = CASES[name]
    args = _args(name, shape, True, cuda)
    _, cx, cy, cz = args[:4]
    flegs = (cx, cy, 0.0) if drop == "z" else (0.0, 0.0, cz)
    got, want = kernel(*args, flegs=flegs), twin(*args, flegs=flegs)
    torch.cuda.synchronize()
    _close(got, want, cuda)


# the z-marching kernels, at shapes of 1-3 cells a side (never one cell
# alone: its Neumann row is zero), x not a multiple of 4, and several tiles
# and z-chunks (ny = 21 and 57 cut both tiles raggedly, nz = 60, 75 and
# 100 the chunks)
ZMARCH = ZMARCH_WRAPPERS
ZMARCH_SHAPES = [(1, 2, 1), (3, 2, 5), (2, 3, 1), (2, 1, 3), (40, 13, 61), (70, 25, 3), (33, 25, 121),
                 (75, 21, 13), (100, 21, 61), (60, 57, 13)]


# (name, shape, pinned, flegs), the filtered legs only for the kernels that
# take them (K2 and K14 have no P-smoothing stage)
ZMARCH_CASES = [
    pytest.param(name, shape, pinned, flegs, id=f"{name}-shape{n}-{pinned}-{flegs}")
    for name in ZMARCH for n, shape in enumerate(ZMARCH_SHAPES) for pinned in (True, False)
    for flegs in ((False, True) if name in FLEGS else (False,))
]


@pytest.mark.parametrize("name, shape, pinned, flegs", ZMARCH_CASES)
def test_zmarch_kernel_matches_twin(cuda, name, shape, pinned, flegs):
    """One launch a call; K6's x1 bit-equal to the twin's (the same IEEE
    1/d and two products), the other fields at the kernels' tolerances, the
    dot to 1e-5 of itself (K9's <r', r'> is a sum of squares; K2's <x, A x>
    a positive form), K4's <b, x4>
    to 1e-5 of the sum of its terms' magnitudes (chip_smoke.py::_dot_agrees: at a handful of cells it
    cancels to 1% of them, and K4 sums it in another block order than its
    twin), and every face and pad cell of each output exactly 0."""
    kernel, twin = CASES[name]
    args = _args(name, shape, pinned, cuda)
    kw = {"flegs": (args[1], args[2], 0.0) if flegs else None} if name in FLEGS else {}
    before = kernels.LAUNCHES[name]
    got, want = kernel(*args, **kw), twin(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    if name == "fused7_ascent_rz":
        _close(got[:-1], want[:-1], cuda)
        assert got[-1].device == cuda and got[-1].shape == want[-1].shape
        terms = (args[5] * want[0]).abs().sum().item()   # |b x4|, b = args[5]
        assert abs(got[-1].item() - want[-1].item()) <= 1e-5 * terms
    else:
        _close(got, want, cuda)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if name.startswith("fused7_descent1"):
        assert torch.equal(got[0], want[0])
    nz, _, nx = shape
    outside = torch.ones(padded_shape(shape), dtype=torch.bool, device=cuda)
    outside[FACE:FACE + nz, :, :nx] = False
    for field in got:
        if field.dim():
            assert (field[outside] == 0).all()


def test_zmarch_entry_point_refuses_a_plan_that_misses_cells(cuda):
    shape = (40, 13, 61)
    args = _args("fused7_descent1", shape, True, cuda)
    diag, cx, cy, cz, b = args[:5]
    x1, s = torch.empty_like(b), torch.empty_like(b)
    plan = zmarch_plan(shape, "descent1")
    short = (plan.tiles_x - 1, *plan.launch_args()[1:])
    with pytest.raises(RuntimeError, match="tps_descent1"):
        _build.launch(
            "tps_descent1", _DESCENT1_ARGS, cuda,
            b.data_ptr(), diag.data_ptr(), x1.data_ptr(), s.data_ptr(), None,
            *launch_args(shape, cx, cy, cz, cx, cy, cz), G, GW, 1, *short,
        )


@pytest.mark.parametrize("kind", ["descent", "ascent"])
def test_zmarch_entry_points_of_k3_k4_refuse_a_wrong_plan(cuda, kind):
    """A plan that misses a tile in x, or has K6/K7's tile, or one plane of
    shared memory too few, is refused before a launch (ny = 21: K3/K4's
    and K6/K7's tiles cut it into different counts of rows)."""
    shape = (40, 21, 61)
    args = _args(f"fused7_{kind}", shape, True, cuda)
    diag, cx, cy, cz = args[:4]
    fields = args[4:5] if kind == "descent" else args[4:7]
    out = [torch.empty_like(fields[0]) for _ in range(2 if kind == "descent" else 1)]
    plan = zmarch_plan(shape, kind)
    wrong = [
        (plan.tiles_x - 1, *plan.launch_args()[1:]),
        (*zmarch_plan(shape, f"{kind}1").launch_args()[:4], plan.smem_bytes),
        (*plan.launch_args()[:4], plan.smem_bytes - 4 * math.prod(plan.region)),
    ]
    name, argtypes = ("tps_descent", _DESCENT_ARGS) if kind == "descent" else ("tps_ascent", _ASCENT_ARGS)
    if kind == "descent":
        ptrs = (fields[0].data_ptr(), diag.data_ptr(), *(o.data_ptr() for o in out), None)
    else:
        ptrs = (*(f.data_ptr() for f in fields), diag.data_ptr(), out[0].data_ptr(), None)
    for bad in wrong:
        with pytest.raises(RuntimeError, match=name):
            _build.launch(name, argtypes, cuda, *ptrs, *launch_args(shape, cx, cy, cz, cx, cy, cz),
                          G, AD, S0, GW, 1, 0, shape[0], 1, *bad)


@pytest.mark.parametrize("kind", ["descentu", "restrict", "mvdot", "pre2"])
def test_zmarch_entry_points_of_k9_k15_refuse_a_wrong_plan(cuda, kind):
    """As K3/K4's, for K9 and the halo-1 kernels K15, K2 and K14: a plan
    that misses a tile in x, or has another kernel's tile (K6's for K9,
    K3's for the others), or one plane of shared memory too few, is refused
    before a launch."""
    shape = (40, 21, 61)
    args = _args(f"fused7_{kind}", shape, True, cuda)
    diag, cx, cy, cz, r = args[:5]
    plan = zmarch_plan(shape, kind)
    other = zmarch_plan(shape, "descent1" if kind == "descentu" else "descent")
    wrong = [
        (plan.tiles_x - 1, *plan.launch_args()[1:]),
        (*other.launch_args()[:4], plan.smem_bytes),
        (*plan.launch_args()[:4], plan.smem_bytes - 4 * math.prod(plan.region)),
    ]
    if kind == "descentu":
        ap, alpha = args[5], args[10].reshape(1)
        out = [torch.empty_like(r) for _ in range(3)]
        partials = torch.empty(plan.blocks, dtype=torch.float32, device=cuda)
        head = (r.data_ptr(), ap.data_ptr(), alpha.data_ptr(), diag.data_ptr(), *(o.data_ptr() for o in out),
                partials.data_ptr(), *launch_args(shape, cx, cy, cz, cx, cy, cz), S0, AD, G, GW, 1)
        name, argtypes = "tps_descentu", _DESCENTU_ARGS
    elif kind == "mvdot":
        y = torch.empty_like(r)
        partials = torch.empty(plan.blocks, dtype=torch.float32, device=cuda)
        head = (r.data_ptr(), diag.data_ptr(), y.data_ptr(), partials.data_ptr(),
                *launch_args(shape, cx, cy, cz), 1)
        name, argtypes = "tps_mvdot", _MVDOT_ARGS
    elif kind == "pre2":
        xo, d = torch.empty_like(r), torch.empty_like(r)
        head = (r.data_ptr(), diag.data_ptr(), xo.data_ptr(), d.data_ptr(),
                *launch_args(shape, cx, cy, cz), S0, AD, G, 1)
        name, argtypes = "tps_pre2", _PRE2_ARGS
    else:
        s = torch.empty_like(r)
        head = (r.data_ptr(), diag.data_ptr(), s.data_ptr(), *launch_args(shape, cx, cy, cz), GW, 1)
        name, argtypes = "tps_restrict", _RESTRICT_ARGS
    for bad in wrong:
        with pytest.raises(RuntimeError, match=name):
            _build.launch(name, argtypes, cuda, *head, *bad)


# K3z/K4z: (global shape, z-shards) with nz_l = 3, 4, 20 and 75 (several
# z-chunks a slab, down to chunks of 1 plane); ny = 21 cuts the tiles
# raggedly
SLAB_SHAPES = [((12, 11, 13), 4), ((8, 2, 5), 2), ((40, 21, 61), 2), ((150, 13, 7), 2)]


@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("shape, p", SLAB_SHAPES)
def test_slab_kernels_match_twins_and_one_unsharded_launch(cuda, shape, p, pinned):
    """K3z and K4z on the exchanged stacked fields, one launch a call over
    all p slabs (q = p) and one a slab (q = 1), against their twins (every
    face and pad cell 0); each slab's domain planes bit-equal between the
    two and to one K3'/K4' launch on the whole field: the same arithmetic
    on the same values."""
    nz, ny, nx = shape
    star = poisson_stencil_device(Grid3D(nx, ny, nz), pin=pinned, dtype=torch.float32, device=cuda)[0]
    fs = FusedSharded.build(star, make_z_mesh(p, cuda))
    rng = np.random.default_rng(7)
    plain = [torch.tensor(rng.standard_normal(shape, dtype=np.float32), device=cuda) for _ in range(3)]
    b, t, x1 = (fs.exchange_(fs.to_stacked(f)) for f in plain)
    local, nz_l = fs.local_shape, fs.nz_l

    def cases(sl, z0):
        legs = (fs.diag_st[sl], fs.cx, fs.cy, fs.cz)
        place = (local, pinned, z0, nz)
        return {
            "descent": (fused7_descent_slab, fused7_descent_slab_torch, (*legs, b[sl], S0, AD, G, GW, *place)),
            "ascent": (fused7_ascent_slab, fused7_ascent_slab_torch,
                       (*legs, t[sl], b[sl], x1[sl], G, AD, G2, GW, *place)),
        }

    def run(sl, z0):
        outs = {}
        for mode, (kernel, twin, args) in cases(sl, z0).items():
            before = kernels.LAUNCHES[f"fused7_{mode}_slab"]
            got, want = kernel(*args), twin(*args)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES[f"fused7_{mode}_slab"] == before + 1
            _close(got, want, cuda)
            got = got if isinstance(got, tuple) else (got,)
            for field in got:
                outside = torch.ones_like(field, dtype=torch.bool)
                outside[..., FACE:FACE + nz_l, :, :nx] = False
                assert (field[outside] == 0).all()
            outs[mode] = got
        return outs

    stacked = run(slice(None), 0)
    single = [run(i, i * nz_l) for i in range(p)]
    op = PaddedStar.from_star(star)
    pl = (op.diag, op.cx, op.cy, op.cz)
    bp, tp, x1p = (pad_field(f) for f in plain)
    whole = {
        "descent": fused7_descent(*pl, bp, S0, AD, G, GW, shape, pinned),
        "ascent": (fused7_ascent(*pl, tp, bp, x1p, G, AD, G2, GW, shape, pinned),),
    }
    for mode, fields in stacked.items():
        for k, want in enumerate(whole[mode]):
            assert torch.equal(fields[k], torch.stack([o[mode][k] for o in single]))
            assert torch.equal(fields[k][:, FACE:FACE + nz_l, :, :nx].reshape(shape), crop_field(want, shape))


def test_slab_entry_points_refuse_a_dot_or_a_slab_outside_the_grid(cuda):
    """The slab form is dot-free, and its slabs must lie in the global grid:
    one slab, or the last of q stacked ones."""
    shape = (12, 11, 13)
    args = _args("fused7_descent", shape, True, cuda)
    diag, cx, cy, cz, b = args[:5]
    stack, diag_st = torch.zeros((4, *b.shape), dtype=b.dtype, device=cuda), diag.expand(4, *b.shape).contiguous()
    x1, s = torch.empty_like(stack), torch.empty_like(stack)
    plan = zmarch_slab_plan(shape, "descent", 4)
    partials = torch.empty(plan.blocks, dtype=torch.float32, device=cuda)
    head = (stack.data_ptr(), diag_st.data_ptr(), x1.data_ptr(), s.data_ptr())
    for dot, zg, nzg, q in ((partials.data_ptr(), 12, 48, 1), (None, 40, 48, 1), (None, -1, 48, 1),
                            (None, 12, 48, 4), (None, 0, 47, 4), (None, 0, 48, 0)):
        with pytest.raises(RuntimeError, match="tps_descent"):
            _build.launch("tps_descent", _DESCENT_ARGS, cuda, *head, dot,
                          *launch_args(shape, cx, cy, cz, cx, cy, cz), S0, AD, G, GW, 1, zg, nzg, q,
                          *plan.launch_args())
    # the same four slabs from global plane 0 fill the grid of 48
    _build.launch("tps_descent", _DESCENT_ARGS, cuda, *head, None, *launch_args(shape, cx, cy, cz, cx, cy, cz),
                  S0, AD, G, GW, 1, 0, 48, 4, *plan.launch_args())
    torch.cuda.synchronize()


def test_sharded_solve_on_card_matches_cpu(cuda, monkeypatch):
    """``n_devices=4`` at 16^3 (nz_l = 4): K3z/K4z alike, one launch a
    stroke (``FusedSharded.descent`` / ``ascent``), and K1p; no K2-K4 or
    K3'/K4'; the CPU's outcome."""
    kw = dict(rtol=1e-8, atol=1e-12, pc="gamg", warmup=False, n_devices=4)
    strokes = {"descent": 0, "ascent": 0}

    def counted(name):
        fn = getattr(FusedSharded, name)

        def stroke(self, *args):
            strokes[name] += 1
            return fn(self, *args)
        return stroke

    for name in strokes:
        monkeypatch.setattr(FusedSharded, name, counted(name))
    kernels.reset_launches()
    gpu = solve_poisson(16, device=cuda, **kw)
    used = dict(kernels.LAUNCHES)
    assert used["fused7_descent_slab"] == strokes["descent"] == strokes["ascent"] == used["fused7_ascent_slab"] > 0
    assert used["star7_mv"] > 0
    assert all(n == 0 for name, n in used.items()
               if name not in ("fused7_descent_slab", "fused7_ascent_slab", "star7_mv"))
    cpu = solve_poisson(16, device="cpu", **kw)
    assert (gpu.reason, gpu.outer_iters) == (cpu.reason, cpu.outer_iters) == (2, 2)
    assert abs(gpu.iters - cpu.iters) <= 1
    assert abs(gpu.linf_error - cpu.linf_error) < 1e-6


def _box27(ny, nx):
    return tuple(sorted({dz * ny * nx + dy * nx + dx for dz in (-1, 0, 1)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)}))


@pytest.mark.parametrize(
    "n, offsets",
    [
        (40 * 11 * 13, (-143, -13, -1, 0, 1, 13, 143)),       # ragged star, K = 7
        (40 * 11 * 13, _box27(11, 13)),                        # K = 27
        (1000, (-1500, -999, -7, 0, 3, 999, 1200)),           # beyond both ends
        (7, (-3, 0, 2)),                                       # less than a warp
        (5000, tuple(range(-24, 24))),                         # K = 48
    ],
)
def test_dia_mv_matches_twin(cuda, n, offsets):
    rng = np.random.default_rng(11)
    bands = torch.tensor(rng.standard_normal((len(offsets), n), dtype=np.float32), device=cuda)
    x = torch.tensor(rng.standard_normal(n, dtype=np.float32), device=cuda)
    before = kernels.LAUNCHES["dia_mv"]
    got, want = dia_mv(bands, x, offsets), dia_mv_torch(bands, x, offsets)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dia_mv"] == before + 1
    assert got.device == cuda and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * want.abs().max().item())


def test_twins_do_not_count(cuda):
    before = dict(kernels.LAUNCHES)
    star7_mv_padded_torch(*_args("star7_mv_padded", (6, 5, 7), True, cuda))
    assert kernels.LAUNCHES == before


def test_small_solve_on_card_matches_cpu(cuda):
    kw = dict(rtol=1e-8, atol=1e-12, pc="gamg", warmup=False)
    kernels.reset_launches()
    gpu = solve_poisson(16, device=cuda, **kw)
    stencil = ("star7_mv_padded", "fused7_mvdot", "fused7_descent_rr", "fused7_ascent_rz")
    assert all(kernels.LAUNCHES[name] > 0 for name in stencil)
    assert all(n == 0 for name, n in kernels.LAUNCHES.items() if name not in stencil)
    cpu = solve_poisson(16, device="cpu", **kw)
    assert (gpu.reason, gpu.outer_iters) == (cpu.reason, cpu.outer_iters) == (2, 2)
    assert abs(gpu.iters - cpu.iters) <= 1
    assert abs(gpu.linf_error - cpu.linf_error) < 1e-6


def test_small_aij_solve_on_card_matches_cpu(cuda):
    """The structure-blind aij route (``structure_detect=False``): K5 only."""
    kw = dict(rtol=1e-8, atol=1e-12, pc="gamg", warmup=False, mat_type="aij", structure_detect=False)
    kernels.reset_launches()
    gpu = solve_poisson(16, device=cuda, **kw)
    assert kernels.LAUNCHES["dia_mv"] > 0
    assert all(n == 0 for name, n in kernels.LAUNCHES.items() if name != "dia_mv")
    cpu = solve_poisson(16, device="cpu", **kw)
    assert (gpu.reason, gpu.outer_iters) == (cpu.reason, cpu.outer_iters)
    assert gpu.reason == 2
    assert abs(gpu.iters - cpu.iters) <= 1
    assert abs(gpu.linf_error - cpu.linf_error) < 1e-6


REFERENCE = AMGParams(smoother="richardson", degree=1)   # the reference config's smoother


@pytest.mark.parametrize(
    "ksp, used, window",
    [("cg", ("fused7_descent1_rr", "fused7_ascent1_rz"), 0.03),
     ("bcgs", ("fused7_descent1", "fused7_ascent1"), 0.10)],
)
def test_small_reference_config_solve_on_card_matches_cpu(cuda, ksp, used, window):
    """The reference config (Richardson(1), rtol 1e-14) at 16^3 on the card
    against the same solve on the CPU: the degree-1 kernels (K6/K7 for CG,
    K6'/K7' for the other methods) and no degree-2 one.  With Richardson(1)
    the inner count follows the dots' summation order: CG within 3%,
    BiCGStab within 10% (135 on the card vs 142 on the CPU here; at 24^3
    the JAX package's own two cycles take 228 and 292)."""
    kw = dict(rtol=1e-14, atol=1e-12, amg_params=REFERENCE, ksp=ksp, warmup=False)
    kernels.reset_launches()
    gpu = solve_poisson(16, device=cuda, **kw)
    assert all(kernels.LAUNCHES[name] > 0 for name in used)
    assert all(kernels.LAUNCHES[name] == 0 for name in ("fused7_descent_rr", "fused7_ascent_rz",
                                                          "fused7_descent", "fused7_ascent"))
    cpu = solve_poisson(16, device="cpu", **kw)
    assert (gpu.reason, gpu.outer_iters) == (cpu.reason, cpu.outer_iters)
    assert gpu.reason > 0
    assert abs(gpu.iters - cpu.iters) <= window * cpu.iters + 1
    assert abs(gpu.linf_error - cpu.linf_error) < 1e-9


def test_gmres_solve_on_card_launches_the_dot_free_kernels(cuda):
    kernels.reset_launches()
    gpu = solve_poisson(16, device=cuda, rtol=1e-8, atol=1e-12, ksp="gmres", warmup=False)
    assert kernels.LAUNCHES["fused7_descent"] > 0 and kernels.LAUNCHES["fused7_ascent"] > 0
    assert kernels.LAUNCHES["fused7_descent_rr"] == kernels.LAUNCHES["fused7_mvdot"] == 0
    cpu = solve_poisson(16, device="cpu", rtol=1e-8, atol=1e-12, ksp="gmres", warmup=False)
    assert (gpu.reason, gpu.outer_iters) == (cpu.reason, cpu.outer_iters) == (2, 2)
    assert abs(gpu.iters - cpu.iters) <= 1


@pytest.mark.parametrize(
    "extra, used",
    [
        # the full-fusion CG body: K8, K9 and K4, never K2 or K3
        (dict(cg_fusion=True), {"fused7_cgmv", "fused7_descentu", "fused7_ascent_rz"}),
        # the plain layout: K1p and no padded kernel
        (dict(layout="plain"), {"star7_mv"}),
    ],
)
def test_fusion_and_plain_solves_on_card_match_cpu(cuda, extra, used):
    """At 18^3, where every inner solve stops at ~0.3 of its tolerance.  At
    16^3 the plain route's second inner solve follows the rounding of the
    first sweep (15 inner on the CPU, 19 on the card and in JAX): its
    right-hand side is that sweep's residual, 1e-5 of ||b||, and any two
    roundings of it lie ~14% apart (tests/test_torch_plain.py::
    test_plain_second_inner_solve_matches_jax_on_one_rhs)."""
    kw = dict(rtol=1e-8, atol=1e-12, pc="gamg", warmup=False, **extra)
    kernels.reset_launches()
    gpu = solve_poisson(18, device=cuda, **kw)
    assert all(kernels.LAUNCHES[name] > 0 for name in used)
    unused = {"fused7_mvdot", "fused7_descent_rr"} if extra.get("cg_fusion") else {
        name for name in kernels.LAUNCHES if name.startswith("fused7") or name == "star7_mv_padded"
    }
    assert all(kernels.LAUNCHES[name] == 0 for name in unused)
    cpu = solve_poisson(18, device="cpu", **kw)
    assert (gpu.reason, gpu.outer_iters) == (cpu.reason, cpu.outer_iters) == (2, 2)
    assert abs(gpu.iters - cpu.iters) <= 1
    assert abs(gpu.linf_error - cpu.linf_error) < 1e-6


# name: (solve_poisson kwargs, kernels launched, kernels not launched).  At
# 18^3 (test_fusion_and_plain_solves_on_card_match_cpu's size)
SOLVES = {
    # the unfused padded cycle: Chebyshev(3) from pre2/cheb, post cheb0/cheb
    "chebyshev3": (dict(amg_params=AMGParams(degree=3)),
                   {"fused7_pre2", "fused7_cheb", "fused7_cheb0", "fused7_residual",
                    "fused7_restrict", "fused7_prolong", "fused7_mvdot"},
                   {"fused7_descent_rr", "fused7_ascent_rz", "fused7_rich"}),
    "richardson3": (dict(amg_params=AMGParams(smoother="richardson", degree=3)),
                    {"fused7_rich", "fused7_residual", "fused7_restrict", "fused7_prolong"},
                    {"fused7_descent_rr", "fused7_cheb"}),
    "w_cycle": (dict(mg_cycle="w"), {"fused7_descent_rr", "fused7_ascent_rz"}, {"fused7_residual"}),
    "threshold": (dict(amg_params=AMGParams(threshold=0.05), extent=(1.0, 1.0, 3.0)),
                  {"fused7_descent_rr", "fused7_ascent_rz"}, {"fused7_residual"}),
    "sor_smoother": (dict(amg_params=AMGParams(smoother="sor")), {"star7_mv"}, {"fused7_mvdot"}),
    "lu_coarse": (dict(amg_params=AMGParams(coarse_solve="lu")), {"star7_mv"}, {"fused7_mvdot"}),
    "xline_bjacobi": (dict(amg_params=AMGParams(bjacobi_bs=18)), {"star7_mv"}, {"fused7_mvdot"}),
    "pc_jacobi": (dict(pc="jacobi"), {"fused7_mvdot"}, {"fused7_descent_rr", "fused7_residual"}),
    "pc_sor": (dict(pc="sor"), {"star7_mv"}, {"fused7_mvdot"}),
    "aij_lu": (dict(mat_type="aij", structure_detect=False, amg_params=AMGParams(coarse_solve="lu")),
               {"dia_mv"}, {"star7_mv"}),
    # the default aij route: the matrix proved a star, solved on K1-K4
    "aij_lifted": (dict(mat_type="aij"),
                   {"star7_mv_padded", "fused7_mvdot", "fused7_descent_rr", "fused7_ascent_rz"},
                   {"dia_mv", "star7_mv"}),
    # uniform precision through the lift: the plain f32 route (K1p)
    "aij_f32": (dict(mat_type="aij", precision="f32", rtol=1e-6), {"star7_mv"}, {"dia_mv", "fused7_mvdot"}),
    # the bf16 hierarchy on the plain layout: K1p for the f32 inner operator
    "bf16_plain": (dict(layout="plain", pc_dtype="bf16"), {"star7_mv"}, {"fused7_mvdot", "dia_mv"}),
}


@pytest.mark.parametrize("name", list(SOLVES))
def test_gamg_options_on_card_match_cpu(cuda, name):
    extra, used, unused = SOLVES[name]
    kw = {"rtol": 1e-8, "atol": 1e-12, "warmup": False, **extra}
    kernels.reset_launches()
    gpu = solve_poisson(18, device=cuda, **kw)
    assert all(kernels.LAUNCHES[k] > 0 for k in used), kernels.LAUNCHES
    assert all(kernels.LAUNCHES[k] == 0 for k in unused), kernels.LAUNCHES
    cpu = solve_poisson(18, device="cpu", **kw)
    assert (gpu.reason, gpu.outer_iters) == (cpu.reason, cpu.outer_iters)
    assert gpu.reason == 2
    # the standalone PCs' 150-200 f32 CG iterations on the pinned operator
    # follow the dots' summation order (196 on the H100 against 153 on the
    # CPU for Jacobi here; at 24^3 the CPU alone moves -pc_type none from 280
    # on one thread to 201 on two): held to 35%
    weak = name in ("pc_jacobi", "pc_sor")
    assert abs(gpu.iters - cpu.iters) <= (0.35 * cpu.iters if weak else 1)
    assert abs(gpu.linf_error - cpu.linf_error) < 1e-6


def test_itprof_runs_on_card(cuda, capsys):
    itprof.main(["24", "3"])
    out = capsys.readouterr().out
    assert "FULL CG+AMG iteration" in out and "FULL fused-CG iteration" in out


@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("shape, k", [((40, 11, 13), 3), ((7, 5, 9), 1), ((3, 2, 1), 2), ((12, 12, 12), 4)])
def test_star7_mv_batched_matches_twin_and_k1p(cuda, shape, k, pinned):
    """K1p over a stack: one launch, the twin's values, and each column bit
    for bit one K1p launch on it."""
    nz, ny, nx = shape
    star = poisson_stencil_device(Grid3D(nx, ny, nz), pin=pinned, dtype=torch.float32, device=cuda)[0]
    x = torch.tensor(np.random.default_rng(7).standard_normal((k, *shape), dtype=np.float32), device=cuda)
    args = (star.diag, star.cx, star.cy, star.cz, x, pinned)
    before = kernels.LAUNCHES["star7_mv_batched"]
    got, want = star7_mv_batched(*args), star7_mv_torch(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["star7_mv_batched"] == before + 1
    _close(got, want, cuda)
    for c in range(k):
        assert torch.equal(got[c], star7_mv(*args[:4], x[c], pinned))


def _ksp_run(device):
    """A KSP solve at 18^3, its reuse for 2b, and mat_solve of three
    columns, with the launches of the solve and of mat_solve."""
    op, b, exact = poisson_stencil_device(Grid3D(18, 18, 18), device=device)
    ksp = KSP(rtol=1e-8, atol=1e-12).set_operators(op)
    kernels.reset_launches()
    first = ksp.solve(b)
    solve_used = dict(kernels.LAUNCHES)
    hier = ksp._pc_state
    second = ksp.solve(2.0 * b)
    assert ksp._pc_state is hier  # KSPSetReusePreconditioner
    assert torch.equal(second.x, 2.0 * first.x)
    kernels.reset_launches()
    block = ksp.mat_solve(torch.stack([b, 5.0 * b, -b]))
    return first, (first.x - exact).abs().max().item(), block, solve_used, dict(kernels.LAUNCHES)


def test_ksp_object_on_card_matches_cpu(cuda):
    """The object API on the card: the solve on K1-K4 (the padded route),
    mat_solve on the batched K1p and no fused7 kernel, each held to the
    same run on the CPU (inner within 1, as the solves above)."""
    gpu, gpu_linf, gpu_block, solve_used, block_used = _ksp_run(cuda)
    assert all(solve_used[name] > 0 for name in
               ("star7_mv_padded", "fused7_mvdot", "fused7_descent_rr", "fused7_ascent_rz"))
    assert block_used["star7_mv_batched"] > 0
    assert all(n == 0 for name, n in block_used.items() if name.startswith("fused7"))
    cpu, cpu_linf, cpu_block, _, _ = _ksp_run("cpu")
    assert (gpu.reason, gpu.outer_iters) == (cpu.reason, cpu.outer_iters) == (2, 2)
    assert abs(gpu.iters - cpu.iters) <= 1
    assert abs(gpu_linf - cpu_linf) < 1e-6
    assert gpu_block.reason.tolist() == cpu_block.reason.tolist() == [2, 2, 2]
    assert gpu_block.outer_iters.tolist() == cpu_block.outer_iters.tolist()
    assert (gpu_block.iters.cpu() - cpu_block.iters).abs().max().item() <= 1
    torch.testing.assert_close(gpu_block.x.cpu(), cpu_block.x, rtol=0, atol=1e-6 * cpu_block.x.abs().max().item())


@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("shape, k", [((40, 11, 13), 3), ((7, 5, 9), 1), ((3, 2, 2), 2), ((12, 12, 12), 6)])
def test_dia_mv_batched_matches_twin_and_k5(cuda, shape, k, pinned):
    """K5 over a stack of the Poisson bands: one launch, the twin's values,
    and each column bit for bit one K5 launch on it."""
    nz, ny, nx = shape
    op = poisson_dia_device(Grid3D(nx, ny, nz), pin=pinned, device=cuda)[1]
    x = torch.tensor(np.random.default_rng(7).standard_normal((k, op.n_rows), dtype=np.float32), device=cuda)
    before = dict(kernels.LAUNCHES)
    got, want = dia_mv_batched(op.bands, x, op.offsets), dia_mv_torch(op.bands, x, op.offsets)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dia_mv_batched"] == before["dia_mv_batched"] + 1
    assert kernels.LAUNCHES["dia_mv"] == before["dia_mv"]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * want.abs().max().item())
    for c in range(k):
        assert torch.equal(got[c], dia_mv(op.bands, x[c], op.offsets))
    assert torch.equal(op.mv(x), got)


def test_dia_mv_batched_on_random_bands(cuda):
    """The 27-band set and offsets past both ends, k = 5, bit for bit K5."""
    n, offsets = 40 * 11 * 13, (-(40 * 11 * 13) + 1, *_box27(11, 13)[1:-1], 40 * 11 * 13 - 1)
    rng = np.random.default_rng(11)
    bands = torch.tensor(rng.standard_normal((len(offsets), n), dtype=np.float32), device=cuda)
    x = torch.tensor(rng.standard_normal((5, n), dtype=np.float32), device=cuda)
    got = dia_mv_batched(bands, x, offsets)
    torch.testing.assert_close(got, dia_mv_torch(bands, x, offsets), rtol=1e-5, atol=1e-5)
    assert all(torch.equal(got[c], dia_mv(bands, x[c], offsets)) for c in range(5))


def test_f64_dia_mv_launches_no_k5(cuda):
    """An f64 DIA applies in plain torch on the card, as on the CPU; K5
    itself refuses f64."""
    op = poisson_dia_device(Grid3D(9, 8, 7), device=cuda)[1]
    op64 = DIA(op.bands.double(), op.offsets, op.shape)
    x = torch.tensor(np.random.default_rng(3).standard_normal((2, op.n_rows)), device=cuda)
    kernels.reset_launches()
    y, ys = op64.mv(x[0]), op64.mv(x)
    assert not any(kernels.LAUNCHES.values())
    want = dia_mv_torch(op64.bands.cpu(), x.cpu(), op.offsets)
    torch.testing.assert_close(ys.cpu(), want, rtol=1e-14, atol=0)
    assert torch.equal(ys[0], y)
    with pytest.raises(TypeError):
        dia_mv(op64.bands, x[0], op.offsets)


def _file_run(device, path):
    """solve_from_file of ``path`` and mat_solve of three columns through
    KSP on its matrix, with the launches of each."""
    kernels.reset_launches()
    rep = solve_from_file(path, device=device, rtol=1e-8, atol=1e-12)
    file_used = dict(kernels.LAUNCHES)
    a, b, _ = assemble_poisson(Grid3D(16, 16, 16))
    ksp = KSP(rtol=1e-8, atol=1e-12).set_operators(a, device=device)
    ksp.setup()
    b = torch.tensor(b, device=device)
    kernels.reset_launches()
    block = ksp.mat_solve(torch.stack([b, 5.0 * b, -b]))
    return rep, file_used, block, dict(kernels.LAUNCHES)


def test_file_route_and_dia_mat_solve_on_card_match_cpu(cuda, tmp_path):
    """The -f route on K5 and mat_solve on the batched K5 (no single K5
    launch), each held to the same run on the CPU, at 16^3 (at 14^3 the
    second sweep's inner count sits on the small-grid knife edge, ROADMAP
    section 3: 26 on the card, 34 on the CPU)."""
    a, b, exact = assemble_poisson(Grid3D(16, 16, 16))
    path = str(tmp_path / "p16.petsc")
    save_petsc_mat(path, a)
    save_petsc_vec(path, b, append=True)
    save_petsc_vec(path, exact, append=True)
    gpu, file_used, gpu_block, block_used = _file_run(cuda, path)
    assert file_used["dia_mv"] > 0
    assert all(n == 0 for name, n in file_used.items() if name != "dia_mv")
    assert block_used["dia_mv_batched"] > 0 and block_used["dia_mv"] == 0
    cpu, _, cpu_block, _ = _file_run("cpu", path)
    assert (gpu.reason, gpu.outer_iters) == (cpu.reason, cpu.outer_iters) == (2, 2)
    assert abs(gpu.iters - cpu.iters) <= 1
    assert abs(gpu.linf_error - cpu.linf_error) < 1e-6
    assert gpu_block.reason.tolist() == cpu_block.reason.tolist() == [2, 2, 2]
    assert gpu_block.outer_iters.tolist() == cpu_block.outer_iters.tolist()
    assert (gpu_block.iters.cpu() - cpu_block.iters).abs().max().item() <= 1
    torch.testing.assert_close(gpu_block.x.cpu(), cpu_block.x, rtol=0, atol=1e-6 * cpu_block.x.abs().max().item())


@pytest.mark.parametrize("precision, rtol, k5", [("f64", 1e-8, False), ("f32", 1e-6, True)])
def test_uniform_aij_on_card_matches_cpu(cuda, precision, rtol, k5):
    """The structure-blind aij route in uniform precision: f32 levels on
    K5, f64 levels in plain torch (no kernel)."""
    kw = dict(rtol=rtol, atol=1e-12, warmup=False, mat_type="aij", structure_detect=False, precision=precision)
    kernels.reset_launches()
    gpu = solve_poisson(16, device=cuda, **kw)
    assert (kernels.LAUNCHES["dia_mv"] > 0) == k5
    assert all(n == 0 for name, n in kernels.LAUNCHES.items() if name != "dia_mv")
    cpu = solve_poisson(16, device="cpu", **kw)
    assert gpu.reason == cpu.reason == 2
    assert abs(gpu.iters - cpu.iters) <= 1
    assert abs(gpu.linf_error - cpu.linf_error) < (1e-6 if precision == "f64" else 2e-5)


@pytest.mark.parametrize("k", [49, 65, 192])
def test_k5_past_48_bands_matches_twin_and_k5(cuda, k):
    """K5 and the batched K5 with 49-192 bands (the DIA family's cap) on a
    ragged n, offsets past both ends: K5 and its twin (which rounds each
    product and sum apart, where K5 rounds once a term with __fmaf_rn)
    within the f32 error bound of the f64 sum, and each batched column
    bit for bit a K5 launch."""
    n = 40 * 11 * 13 + 7
    rng = np.random.default_rng(k)
    offsets = tuple(sorted(rng.choice(np.arange(-n + 1, n), k, replace=False).tolist()))
    bands = torch.tensor(rng.standard_normal((k, n), dtype=np.float32), device=cuda)
    x = torch.tensor(rng.standard_normal((3, n), dtype=np.float32), device=cuda)
    kernels.reset_launches()
    y = dia_mv(bands, x[0], offsets)
    ys = dia_mv_batched(bands, x, offsets)
    assert kernels.LAUNCHES["dia_mv"] == kernels.LAUNCHES["dia_mv_batched"] == 1
    # within the f32 sum's error bound, K u sum_k |b_k x|, of the f64 sum,
    # as the twin is
    exact = dia_mv_torch(bands.double(), x.double(), offsets)
    bound = k * 2.0**-24 * dia_mv_torch(bands.abs().double(), x.abs().double(), offsets)
    for out in (ys, dia_mv_torch(bands, x, offsets)):
        assert bool(((out.double() - exact).abs() <= bound).all())
    assert torch.equal(ys[0], y)
    assert all(torch.equal(ys[c], dia_mv(bands, x[c], offsets)) for c in range(3))


def test_ell_and_factored_transfer_on_card(cuda):
    """ELL.mv and rmv on the card against the CPU; FactoredTransfer's
    restrict gives the same bits twice (no float atomics)."""
    import scipy.sparse as sp

    from tpusparse_torch.amg.unstructured import gamg_setup_unstructured
    from tpusparse_torch.sparse.csr import HostCSR
    from tpusparse_torch.sparse.ell import ELL

    rng = np.random.default_rng(5)
    a = sp.random(3000, 2500, density=0.004, random_state=rng, format="csr")
    a.data = rng.standard_normal(a.nnz) + 1.0
    h = HostCSR.from_scipy(a)
    ell_c, ell_g = ELL.from_csr(h, dtype=np.float32, device="cpu"), ELL.from_csr(h, dtype=np.float32, device=cuda)
    x = torch.tensor(rng.standard_normal(2500), dtype=torch.float32)
    y = torch.tensor(rng.standard_normal(3000), dtype=torch.float32)
    torch.testing.assert_close(ell_g.mv(x.to(cuda)).cpu(), ell_c.mv(x), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ell_g.rmv(y.to(cuda)).cpu(), ell_c.rmv(y), rtol=1e-5, atol=1e-5)
    assert torch.equal(ell_g.rmv(y.to(cuda)), ell_g.rmv(y.to(cuda)))
    a16, _, _ = assemble_poisson(Grid3D(16, 16, 16))
    hier = gamg_setup_unstructured(a16, AMGParams(), dtype=np.float32, aggregation="greedy", device=cuda)
    lev = hier.levels[0]
    r = torch.tensor(rng.standard_normal(a16.shape[0]), dtype=torch.float32, device=cuda)
    first = lev.transfer.restrict(lev.op, lev.dinv, r)
    assert all(torch.equal(first, lev.transfer.restrict(lev.op, lev.dinv, r)) for _ in range(5))


@pytest.mark.parametrize(
    "kw", [dict(aggregation="greedy"), dict(aggregation="banded", structure_detect=False),
           dict(structure_detect=False, amg_params=AMGParams(bjacobi_bs=16))],
    ids=["greedy", "banded", "bjacobi"],
)
def test_item_9_2_routes_on_card_match_cpu(cuda, kw):
    """The greedy, banded and block-Jacobi-level aij routes at 16^3 on K5:
    the card's counts within 2 inner of the CPU's, outer equal, and two
    card runs give the same counts."""
    kw = dict(rtol=1e-8, atol=1e-12, mat_type="aij", **kw)
    kernels.reset_launches()
    gpu = solve_poisson(16, device=cuda, **kw)
    assert kernels.LAUNCHES["dia_mv"] > 0
    again = solve_poisson(16, device=cuda, **kw)
    cpu = solve_poisson(16, device="cpu", **kw)
    assert gpu.reason == cpu.reason == 2 and gpu.outer_iters == cpu.outer_iters
    assert abs(gpu.iters - cpu.iters) <= 2
    assert (again.iters, again.outer_iters) == (gpu.iters, gpu.outer_iters)
    assert abs(gpu.linf_error - cpu.linf_error) < 1e-6

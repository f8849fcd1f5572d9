"""The grid transfers' kernels, ``kernels/transfer.py`` (T: ``agg_prolong``,
T^T: ``agg_restrict``).

On the CPU: ``StructuredTransfer.{t_apply, tT_apply}`` and
``PaddedTransfer.{t_apply_padded, tT_apply_padded}`` are the three einsums
they always were, bit for bit, and launch nothing, at ragged shapes
(7 x 8 x 10, 80^3 -> 27^3), under factors with a 1 in them and above 3, in the plain
and the padded layout (the padded output's pads zero) and on stacks of 1
and 4 fields; the kernel's order of addition (``agg_restrict_ordered``)
within its rounding bound of them, and T^T the adjoint of T.

On the card (``requires_cuda``, skipped without one): T bit-equal to its
twin, and T^T bit-equal to the twin in the kernel's order and within that
rounding bound of the einsums (cuBLAS documents no order of its sums), in
f32, f64 and bf16, one launch a call; other dtypes and mismatched shapes
raise; one launch each way a level a cycle, in a padded fused V-cycle and
in a ``VarStencil27`` cycle.  The module does not import JAX:

    python -m pytest tests/test_torch_transfer_kernels.py -m requires_cuda --noconftest -q
"""

import pytest
import torch

from tpusparse_torch import Grid3D, kernels
from tpusparse_torch.amg.transfer import StructuredTransfer
from tpusparse_torch.kernels.stencil7 import FACE, padded_shape
from tpusparse_torch.kernels.transfer import (
    agg_prolong,
    agg_prolong_torch,
    agg_restrict,
    agg_restrict_ordered,
    agg_restrict_torch,
)
from tpusparse_torch.sparse.padded import PaddedTransfer

SHAPES = [(7, 8, 10), (5, 9, 4), (80, 80, 80)]   # (nz, ny, nx); 80^3 -> 27^3 is the 720^3 cell's
FACTORS = [3, (3, 1, 3), (1, 3, 3), (2, 4, 5)]   # the last: the kernel's general-factor form
STACKS = [None, 4]   # one field, or a stack of 4
DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


def _transfer(shape, factor, dtype, padded, device="cpu"):
    tr = StructuredTransfer.build(shape, 0.5, dtype, factor, device=device)
    return PaddedTransfer(tr) if padded else tr


def _forms(tr):
    """(T, T^T, fine layout, z0) of a transfer."""
    if isinstance(tr, PaddedTransfer):
        return tr.t_apply_padded, tr.tT_apply_padded, padded_shape(tr.inner.fine_shape), FACE
    return tr.t_apply, tr.tT_apply, tr.fine_shape, 0


def _mats(tr):
    return tr.mats if isinstance(tr, PaddedTransfer) else (tr.sz, tr.sy, tr.sx)


def _fields(tr, k, dtype, device="cpu", seed=5):
    """A coarse field and a fine one in the transfer's layout (pads
    included, random: T^T must not read them), or stacks of k."""
    gen = torch.Generator(device).manual_seed(seed)
    lead = () if k is None else (k,)
    e_c = torch.randn((*lead, *tr.c_shape), generator=gen, device=device).to(dtype)
    r = torch.randn((*lead, *_forms(tr)[2]), generator=gen, device=device).to(dtype)
    return e_c, r


def _einsum_t(tr, e_c):
    """T e_c as the transfers computed it before the kernels: three einsums."""
    sz, sy, sx = _mats(tr)
    x = e_c * tr.tnorm
    x = torch.einsum("zc,...cde->...zde", sz, x)
    x = torch.einsum("yd,...zde->...zye", sy, x)
    return torch.einsum("xe,...zye->...zyx", sx, x)


def _einsum_tt(tr, r):
    """T^T r as the transfers computed it before the kernels."""
    sz, sy, sx = _mats(tr)
    x = torch.einsum("...zyx,zc->...cyx", r, sz)
    x = torch.einsum("...cyx,yd->...cdx", x, sy)
    x = torch.einsum("...cdx,xe->...cde", x, sx)
    return x * tr.tnorm


def _inner(tr):
    return tr.inner if isinstance(tr, PaddedTransfer) else tr


def _rounding_bound(tr, r):
    """Per coarse cell, how far two orders of T^T's sum may lie apart: each
    order's recursive sum of m terms is within (m - 1) u sum|r| of the exact
    (u = eps / 2), bf16 adds a rounding after each of the three axes and
    both round the scale, so (m + 4) eps T^T|r| covers the two."""
    inner = _inner(tr)
    m = inner.factor[0] * inner.factor[1] * inner.factor[2]
    eps = torch.finfo(r.dtype).eps
    z0 = FACE if isinstance(tr, PaddedTransfer) else 0
    absum = agg_restrict_ordered(r.double().abs(), inner.tnorm.double(), inner.factor, inner.fine_shape, z0)
    return (m + 4) * eps * absum


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("k", STACKS)
@pytest.mark.parametrize("padded", [False, True], ids=["plain", "padded"])
@pytest.mark.parametrize("factor", FACTORS, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_transfers_are_the_einsums_on_the_cpu(shape, factor, padded, k, dtype):
    tr = _transfer(shape, factor, dtype, padded)
    t, tt, layout, z0 = _forms(tr)
    e_c, r = _fields(tr, k, dtype)
    before = dict(kernels.LAUNCHES)
    fine, coarse = t(e_c), tt(r)
    assert kernels.LAUNCHES == before
    want_fine, want_coarse = _einsum_t(tr, e_c), _einsum_tt(tr, r)
    assert fine.dtype == coarse.dtype == dtype
    assert fine.shape == want_fine.shape and torch.equal(fine, want_fine)
    assert coarse.shape == want_coarse.shape and torch.equal(coarse, want_coarse)
    nz, ny, nx = shape
    inside = torch.zeros(layout, dtype=torch.bool)
    inside[z0:z0 + nz, :ny, :nx] = True
    assert not fine[..., ~inside].any()   # the pads are zero


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("padded", [False, True], ids=["plain", "padded"])
@pytest.mark.parametrize("factor", FACTORS, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ordered_restrict_within_rounding_of_the_einsums(shape, factor, padded, dtype):
    """The kernel's order of addition (z, then y, then x members) against
    the einsums, to the rounding two orders of one sum may differ by."""
    tr = _transfer(shape, factor, dtype, padded)
    _, r = _fields(tr, 3, dtype)
    inner, z0 = _inner(tr), _forms(tr)[3]
    got = agg_restrict_ordered(r, inner.tnorm, inner.factor, inner.fine_shape, z0)
    want = _einsum_tt(tr, r)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert ((got.double() - want.double()).abs() <= _rounding_bound(tr, r)).all()


@pytest.mark.parametrize("padded", [False, True], ids=["plain", "padded"])
@pytest.mark.parametrize("factor", FACTORS, ids=str)
def test_restrict_is_the_adjoint_of_prolong(factor, padded):
    """<T e, r> = <e, T^T r> in f64, both forms (the padded one against a
    field whose pads are zero)."""
    tr = _transfer((7, 8, 10), factor, torch.float64, padded)
    t, tt, layout, z0 = _forms(tr)
    e_c, r = _fields(tr, None, torch.float64)
    nz, ny, nx = _inner(tr).fine_shape
    r_in = torch.zeros_like(r)
    r_in[z0:z0 + nz, :ny, :nx] = r[z0:z0 + nz, :ny, :nx]
    lhs, rhs = (t(e_c) * r_in).sum(), (e_c * tt(r_in)).sum()
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_wrappers_take_no_other_device():
    tr = _transfer((4, 4, 4), 3, torch.float32, False, device="meta")
    e_c, r = torch.empty(tr.c_shape, device="meta"), torch.empty(tr.fine_shape, device="meta")
    with pytest.raises(ValueError):
        agg_prolong(e_c, tr.tnorm, _mats(tr), tr.factor, tr.fine_shape)
    with pytest.raises(ValueError):
        agg_restrict(r, tr.tnorm, _mats(tr), tr.factor, tr.fine_shape)


# the card's shapes: the CPU's, a plane wider than a restrict round (1100
# cells in x: a round of 340 coarse cells and one of 27), and the 720^3
# cell's 240^3 level
CARD_SHAPES = SHAPES + [(4, 5, 1100), (240, 240, 240)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


def _counted(name, fn, *args):
    before = kernels.LAUNCHES[name]
    out = fn(*args)
    assert kernels.LAUNCHES[name] == before + 1
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("padded", [False, True], ids=["plain", "padded"])
@pytest.mark.parametrize("factor", FACTORS, ids=str)
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_kernels_equal_their_twins(cuda, shape, factor, padded, dtype):
    """T bit-equal to the einsum twin; T^T bit-equal to the twin in the
    kernel's order and within the rounding bound of the einsums; one
    launch a call, on one field, a stack of 4 and a non-contiguous field."""
    tr = _transfer(shape, factor, dtype, padded, device=cuda)
    tr_cpu = _transfer(shape, factor, dtype, padded)
    t, tt, layout, z0 = _forms(tr)
    inner = _inner(tr_cpu)
    e4, r4 = _fields(tr, 4, dtype, device=cuda)
    cases = [(e4[0], r4[0]), (e4, r4), tuple(x[1].transpose(0, 2).contiguous().transpose(0, 2) for x in (e4, r4))]
    assert not cases[2][0].is_contiguous() and not cases[2][1].is_contiguous()
    for e_c, r in cases:
        fine = _counted("agg_prolong", t, e_c)
        coarse = _counted("agg_restrict", tt, r)
        want_fine = _einsum_t(tr_cpu, e_c.cpu())
        assert fine.dtype == dtype and torch.equal(fine.cpu(), want_fine)
        ordered = agg_restrict_ordered(r.cpu(), inner.tnorm, inner.factor, inner.fine_shape, z0)
        assert coarse.dtype == dtype and torch.equal(coarse.cpu(), ordered)
        einsum = _einsum_tt(tr, r).cpu()
        assert ((coarse.cpu().double() - einsum.double()).abs() <= _rounding_bound(tr_cpu, r.cpu())).all()


@pytest.mark.requires_cuda
def test_kernels_refuse_other_dtypes_and_shapes(cuda):
    tr = _transfer((7, 8, 10), 3, torch.float32, False, device=cuda)
    mats, args = _mats(tr), (tr.factor, tr.fine_shape)
    e_c, r = torch.ones(tr.c_shape, device=cuda), torch.ones(tr.fine_shape, device=cuda)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            agg_prolong(e_c.to(dtype), tr.tnorm, mats, *args)
        with pytest.raises(TypeError):
            agg_restrict(r.to(dtype), tr.tnorm, mats, *args)
    half = tr.tnorm.half()
    with pytest.raises(TypeError):
        agg_restrict(r.half(), half, mats, *args)
    with pytest.raises(ValueError):
        agg_prolong(torch.ones((3, 3, 3), device=cuda), tr.tnorm, mats, *args)
    with pytest.raises(ValueError):
        agg_restrict(torch.ones((7, 8, 11), device=cuda), tr.tnorm, mats, *args)
    with pytest.raises(ValueError):
        agg_restrict(r, tr.tnorm, mats, tr.factor, (8, 8, 10))   # the grid leaves the layout


def _count_cycle(cycle, hier, b):
    kernels.reset_launches()
    cycle(hier, b)
    torch.cuda.synchronize()
    return kernels.LAUNCHES["agg_restrict"], kernels.LAUNCHES["agg_prolong"]


@pytest.mark.requires_cuda
def test_one_launch_each_way_a_level_a_cycle(cuda):
    """A padded fused V-cycle at 24^3 and a plain ``VarStencil27`` V-cycle
    (HPCG's operator) at 18^3: each level with a transfer restricts and
    prolongs once, one launch each."""
    from tpusparse_torch.amg.fused_cycle import vcycle_fused
    from tpusparse_torch.amg.hierarchy import AMGParams, gamg_setup, vcycle
    from tpusparse_torch.grid.hpcg import hpcg_stencil
    from tpusparse_torch.grid.poisson import poisson_stencil_device
    from tpusparse_torch.sparse.padded import PaddedStar, pad_field

    star = poisson_stencil_device(Grid3D(24, 24, 24), dtype=torch.float32, device=cuda)[0]
    hier = gamg_setup(PaddedStar.from_star(star), AMGParams())
    b = pad_field(torch.randn((24, 24, 24), device=cuda))
    n = sum(lev.transfer is not None for lev in hier.levels)
    assert n >= 2 and _count_cycle(vcycle_fused, hier, b) == (n, n)

    op = hpcg_stencil(Grid3D(18, 18, 18), dtype=torch.float32, device=cuda)
    hier = gamg_setup(op, AMGParams())
    n = sum(lev.transfer is not None for lev in hier.levels)
    assert n >= 2 and _count_cycle(vcycle, hier, torch.randn((18, 18, 18), device=cuda)) == (n, n)

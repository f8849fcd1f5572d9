"""The tentative grid transfers of the structured hierarchy in one launch
each way: ``agg_restrict`` (T^T: each coarse cell the sum of its
aggregate's fine cells, times ``tnorm``) and ``agg_prolong`` (T: each fine
cell ``(e_c * tnorm)`` of its aggregate, zero on the pads).

The JAX package has no kernel here: ``tpusparse/amg/transfer.py`` applies
T as three contractions with the 0/1 per-axis membership matrices, which
XLA sends to the TPU's matrix unit.  Their PyTorch form,
``agg_prolong_torch`` / ``agg_restrict_torch``, is three ``torch.einsum``
calls, full-f32 GEMMs on this card against some 27 adds a coarse cell.
``csrc/transfer.cu`` streams the fine field once instead.

The membership matrices ``(sz, sy, sx)`` of ``StructuredTransfer`` (or
``PaddedTransfer``'s, whose zero rows are the padded layout's pads) define
the fine layout, ``(sz.shape[0], sy.shape[0], sx.shape[0])`` a field;
``fine_shape`` is the grid in it, its plane k at ``z0 + k``; ``factor`` the
per-axis aggregation factors.  Fields may carry leading stack axes
(``KSP.mat_solve``'s columns) over one ``tnorm``.  The dtypes: f32, f64
and bf16 (the bf16 V-cycle, ``cast_hierarchy``), the field's and
``tnorm``'s alike.

Both dispatch by tensor device only: a CPU tensor runs the einsum twin, a
CUDA tensor launches the kernel (or raises).  T equals the twin bit for
bit; T^T adds in the order of ``agg_restrict_ordered`` (the einsums'
order, which cuBLAS does not document), and equals it bit for bit.
"""

from __future__ import annotations

import math

import torch

from tpusparse_torch.kernels import LAUNCHES, _build

# the entry points' code of each field dtype
DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def agg_prolong_torch(e_c, tnorm, sz, sy, sx):
    """Plain twin of ``agg_prolong``: the three einsums of
    ``StructuredTransfer.t_apply``."""
    x = e_c * tnorm
    x = torch.einsum("zc,...cde->...zde", sz, x)
    x = torch.einsum("yd,...zde->...zye", sy, x)
    return torch.einsum("xe,...zye->...zyx", sx, x)


def agg_restrict_torch(r, tnorm, sz, sy, sx):
    """Plain twin of ``agg_restrict``: the three einsums of
    ``StructuredTransfer.tT_apply``."""
    x = torch.einsum("...zyx,zc->...cyx", r, sz)
    x = torch.einsum("...cyx,yd->...cdx", x, sy)
    x = torch.einsum("...cdx,xe->...cde", x, sx)
    return x * tnorm


def _block_sums(x: torch.Tensor, axis: int, f: int, dtype) -> torch.Tensor:
    """Sums of the groups of ``f`` along ``axis`` < 0 (the last one ragged), the
    members added in ascending order in ``x``'s type and then rounded to
    ``dtype``."""
    n = x.shape[axis]
    nc = -(-n // f)
    pad = [0, 0] * (-1 - axis) + [0, nc * f - n]
    x = torch.nn.functional.pad(x, pad).unflatten(axis, (nc, f))   # the members on ``axis``
    s = x.select(axis, 0)
    for m in range(1, f):
        s = s + x.select(axis, m)
    return s.to(dtype).to(x.dtype)


def agg_restrict_ordered(r, tnorm, factor, fine_shape, z0: int = 0):
    """T^T r in the kernel's order of addition: the z members of an
    aggregate first, then the y members of those sums, then the x members,
    each ascending and in the field's type (bf16: in f32, rounded to bf16
    after each axis), times ``tnorm`` last.  The ragged groups' missing
    members add zero, which moves no sum."""
    nz, ny, nx = fine_shape
    fz, fy, fx = factor
    x = r[..., z0:z0 + nz, :ny, :nx]
    work = torch.float32 if r.dtype == torch.bfloat16 else r.dtype
    x = x.to(work)
    for axis, f in ((-3, fz), (-2, fy), (-1, fx)):
        x = _block_sums(x, axis, f, r.dtype)
    return x.to(r.dtype) * tnorm


_ARGS = [_build.P] * 3 + [_build.I] * 12 + [_build.P]


def _launch(name, x, tnorm, mats, factor, fine_shape, z0, restrict):
    """Launch entry point ``tps_<name>`` on ``x`` (a coarse field or stack for
    T, a fine one in the layout of ``mats`` for T^T) and return its output;
    raise unless ``x`` and ``tnorm`` are a field and the scale of one type
    and device, of the grid ``fine_shape`` inside the layout at z0."""
    layout = tuple(m.shape[0] for m in mats)
    coarse = tuple(-(-n // f) for n, f in zip(fine_shape, factor))
    x_shape, out_shape = (layout, coarse) if restrict else (coarse, layout)
    if x.dim() < 3 or tuple(x.shape[-3:]) != x_shape or tuple(tnorm.shape) != coarse:
        raise ValueError(f"{name}: field {tuple(x.shape)} and tnorm {tuple(tnorm.shape)}: want (..., "
                         f"{x_shape}) and {coarse}")
    if z0 < 0 or z0 + fine_shape[0] > layout[0] or fine_shape[1] > layout[1] or fine_shape[2] > layout[2]:
        raise ValueError(f"{name}: grid {tuple(fine_shape)} at z0 {z0} leaves the layout {layout}")
    if x.device != tnorm.device:
        raise ValueError(f"{name}: field on {x.device}, tnorm on {tnorm.device}")
    if x.dtype != tnorm.dtype or x.dtype not in DTYPES:
        raise TypeError(f"{name}: no kernel for a {x.dtype} field with a {tnorm.dtype} tnorm; it takes one of"
                        f" {list(DTYPES)} for both")
    x, tnorm = x.contiguous(), tnorm.contiguous()
    out = torch.empty((*x.shape[:-3], *out_shape), dtype=x.dtype, device=x.device)
    _build.launch(f"tps_{name}", _ARGS, x.device, x.data_ptr(), tnorm.data_ptr(), out.data_ptr(), *layout, z0,
                  *fine_shape, *factor, math.prod(x.shape[:-3]), DTYPES[x.dtype])
    LAUNCHES[name] += 1
    return out


def agg_prolong(e_c, tnorm, mats, factor, fine_shape, z0: int = 0):
    """T e_c into the layout of ``mats`` = (sz, sy, sx), of one coarse field
    or a stack of them with leading axes.

    CUDA tensors run ``csrc/transfer.cu``'s ``agg_prolong_kernel``, one
    launch over every row of every column; CPU tensors the einsum twin.
    """
    if e_c.device.type == "cpu":
        return agg_prolong_torch(e_c, tnorm, *mats)
    if e_c.device.type != "cuda":
        raise ValueError(f"agg_prolong: no kernel or twin for device {e_c.device}")
    return _launch("agg_prolong", e_c, tnorm, mats, factor, fine_shape, z0, restrict=False)


def agg_restrict(r, tnorm, mats, factor, fine_shape, z0: int = 0):
    """T^T r from the layout of ``mats`` = (sz, sy, sx), of one fine field or
    a stack of them with leading axes; the pads are not read.

    CUDA tensors run ``csrc/transfer.cu``'s ``agg_restrict_kernel``, one
    launch, a block a coarse row of every column; CPU tensors the einsum
    twin.
    """
    if r.device.type == "cpu":
        return agg_restrict_torch(r, tnorm, *mats)
    if r.device.type != "cuda":
        raise ValueError(f"agg_restrict: no kernel or twin for device {r.device}")
    return _launch("agg_restrict", r, tnorm, mats, factor, fine_shape, z0, restrict=True)

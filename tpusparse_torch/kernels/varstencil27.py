"""The variable-coefficient 27-point apply of the coarse levels in one
launch: ``varstencil27_mv(coef, x)``, y[p] = sum_o coef[o][p] * x[p + o]
over the 27 offsets o in ``OFFSETS`` order, zero-filled where p + o leaves
the grid (``sparse/varstencil.py::VarStencil27.mv``).

The JAX package has no kernel here: ``tpusparse/sparse/varstencil.py:76``
leaves the apply to one XLA fusion.  Its PyTorch form,
``varstencil27_mv_torch``, is a pad, the centre product and a strided
multiply and an add for each other offset: about 54 kernels and some 80
host dispatches an apply.  ``csrc/varstencil27.cu`` computes the same sum
in one launch that reads each coefficient once: one block a 16 x 64 tile
of each plane (``varstencil27_tiles``).

``coef`` is one (27, nz, ny, nx) stack; ``x`` one (nz, ny, nx) field or a
stack of them with leading axes (``KSP.mat_solve``'s k columns), each
column the single-field apply.  The (coefficient, field) dtype pairs the
port makes: (bf16, f32) after ``cast_coarse_coefs``, (f32, f32), (f64,
f64) and (bf16, bf16) in the bf16 V-cycle (``cast_hierarchy``); the
output has PyTorch's promoted dtype.  The kernel rounds every product and
sum as the twin does, so the two agree bit for bit.

``varstencil27_mv`` dispatches by tensor device only: a CPU tensor runs
the twin, a CUDA tensor launches the kernel (or raises).  A field that is
not contiguous is copied to a contiguous one first: one more launch.
"""

from __future__ import annotations

import ctypes
import itertools
import math

import torch
import torch.nn.functional as F

from tpusparse_torch.kernels import LAUNCHES, _build

# the 27 offsets in a fixed lexicographic order (dk, dj, di), each in {-1,0,1}
OFFSETS: tuple[tuple[int, int, int], ...] = tuple(
    itertools.product((-1, 0, 1), repeat=3)
)
CENTER = OFFSETS.index((0, 0, 0))  # = 13


def pad1(x: torch.Tensor) -> torch.Tensor:
    """One zero cell around every face of the last three axes: the source
    of all 27 shifts."""
    return F.pad(x, (1, 1, 1, 1, 1, 1))


def shifted_view(xp: torch.Tensor, off, shape) -> torch.Tensor:
    """x[..., p + off] with zero fill, as a view of ``xp = pad1(x)``."""
    (dk, dj, di), (nz, ny, nx) = off, shape
    return xp[..., 1 + dk:1 + dk + nz, 1 + dj:1 + dj + ny, 1 + di:1 + di + nx]


def varstencil27_mv_torch(coef: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``varstencil27_mv``: y = A @ x on the 3D field view, or
    on each field of a stack with leading axes (same accumulation order as
    JAX)."""
    shape = tuple(coef.shape[1:])
    y = coef[CENTER] * x
    xp = pad1(x)
    for o, off in enumerate(OFFSETS):
        if o == CENTER:
            continue
        y = y + coef[o] * shifted_view(xp, off, shape)
    return y


# the entry point's code for each (coefficient, field) dtype pair
PAIRS = {
    (torch.bfloat16, torch.float32): 0,
    (torch.float32, torch.float32): 1,
    (torch.float64, torch.float64): 2,
    (torch.bfloat16, torch.bfloat16): 3,
}

# csrc/varstencil27.cu's VS_TY x VS_TX tile of a block of 256 threads, a
# quad of 4 x cells a thread
VS_TILE = (16, 64)


def varstencil27_tiles(shape: tuple[int, int, int]) -> tuple[int, int]:
    """(tiles_x, tiles_y): the ``VS_TILE`` tiles that cover a plane of an
    (nz, ny, nx) grid.  A launch runs one block a tile of each plane of
    each column: 4 x 15 a plane at 240^3 (14,400 blocks), one at 27^3,
    9^3 and 3^3."""
    _, ny, nx = shape
    ty, tx = VS_TILE
    return -(-nx // tx), -(-ny // ty)


def varstencil27_attributes(pair: int, aligned: bool = True) -> dict:
    """The compiled kernel of dtype pair ``pair`` (``PAIRS``) on the card,
    its 16-byte (``aligned``) or one-cell form: registers a thread, spilled
    bytes a thread, static shared bytes a block and the blocks an SM
    holds."""
    fn = _build.library().tps_varstencil27_attributes
    fn.argtypes = [_build.I, _build.I, _build.P, _build.P, _build.P, _build.P]
    fn.restype = _build.I
    out = [ctypes.c_int() for _ in range(4)]
    rc = fn(pair, int(aligned), *(ctypes.byref(v) for v in out))
    if rc != 0:
        raise RuntimeError(f"tps_varstencil27_attributes: CUDA error {rc}")
    names = ("registers", "spilled_bytes", "static_smem_bytes", "blocks_per_sm")
    return dict(zip(names, (v.value for v in out)))


_VS27_ARGS = [_build.P] * 3 + [_build.I] * 7 + [_build.P]


def varstencil27_mv(coef: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for the 27-point operator ``coef`` (27, nz, ny, nx) on x,
    one field or a stack with leading axes.

    CUDA tensors run ``csrc/varstencil27.cu``, one launch of
    ``varstencil27_tiles``' tiles over every plane of every column; CPU
    tensors the plain twin.
    """
    shape = tuple(coef.shape[1:])
    if coef.dim() != 4 or coef.shape[0] != 27 or x.dim() < 3 or tuple(x.shape[-3:]) != shape:
        raise ValueError(f"coef {tuple(coef.shape)} and x {tuple(x.shape)}: want (27, nz, ny, nx) over (..., nz, ny, nx)")
    if coef.device != x.device:
        raise ValueError(f"coef on {coef.device}, x on {x.device}")
    if x.device.type == "cpu":
        return varstencil27_mv_torch(coef, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel or twin for device {x.device}")
    pair = PAIRS.get((coef.dtype, x.dtype))
    if pair is None:
        raise TypeError(f"no kernel for ({coef.dtype}, {x.dtype}) coefficients and field; it takes {list(PAIRS)}")
    if not coef.is_contiguous():
        raise ValueError("the coefficient stack must be contiguous")
    x = x.contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _build.launch(
        "tps_varstencil27_mv", _VS27_ARGS, x.device,
        coef.data_ptr(), x.data_ptr(), y.data_ptr(), *shape, math.prod(x.shape[:-3]), pair,
        *varstencil27_tiles(shape),
    )
    LAUNCHES["varstencil27_mv"] += 1
    return y

"""K1 and K1p: the 7-point star apply on the padded-resident and on the
plain layout — port of ``tpusparse/kernels/stencil7.py``.

Layout (``padded_shape``): ``(nz + 2*FACE, ny, nxp)`` with ``nxp`` = ``nx``
rounded up to a multiple of 4.  FACE = 3 zero planes per z face stay, as in
the JAX package: the chained kernels of ``fused7`` read 3 halo planes.  The
JAX package rounds (ny, nx) to the TPU's (8, 128) f32 tile, which at 300^3
moves 28% extra bytes in x for nothing on this card.  Here y is not padded
at all, and x only to a multiple of 4 floats, so every row starts on a
16-byte boundary (the width of one vector load per thread) — 0 extra bytes
at 300^3.  The CUDA kernels mask the domain edges explicitly and never read
a pad cell, so neither padding carries meaning beyond alignment.

Invariants of the layout (``sparse/padded.py``): every pad cell of a vector
is zero; diag's pads hold 1.0.

``star7_mv`` (K1p) is the apply on plain ``(nz, ny, nx)`` f32 fields, the
counterpart of ``star7_mv_pallas``.  The JAX kernel pads x and diag into the
resident layout, runs K1 and crops y; on the H100 K1's neighbour reads are
already masked by the domain bounds, so ``csrc/stencil7.cu`` launches the
same kernel on the unpadded field (a geometry with no face planes and
``nxp = nx``) and skips the 4 field passes of pad and crop.

``star7_mv_padded`` and ``star7_mv`` dispatch by tensor device only: a CPU
tensor runs the plain twin (``star7_mv_padded_torch``, ``star7_mv_torch``),
a CUDA tensor launches ``csrc/stencil7.cu`` (or raises).
"""

from __future__ import annotations

import torch

from tpusparse_torch.kernels import LAUNCHES, _build

FACE = 3


def _shift(x: torch.Tensor, axis: int, direction: int) -> torch.Tensor:
    """out[..., i, ...] = x[..., i + direction, ...], zero-filled at the edge."""
    n = x.shape[axis]
    zero = torch.zeros_like(x.narrow(axis, 0, 1))
    if direction == 1:
        return torch.cat([x.narrow(axis, 1, n - 1), zero], dim=axis)
    if direction == -1:
        return torch.cat([zero, x.narrow(axis, 0, n - 1)], dim=axis)
    raise ValueError(f"direction must be +-1, got {direction}")


def _origin_mask(x: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the pinned cell (0, 0, 0), shaped like ``x``."""
    m = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    m[0, 0, 0] = True
    return m


def star7_mv_torch(diag, cx, cy, cz, x, pinned: bool):
    """Plain twin of K1p, and the apply of every dtype: y = A @ x on plain
    (nz, ny, nx) fields of any float dtype (``StarStencil3D.mv``'s math,
    ``tpusparse/sparse/stencil.py:140-152``).  The pinned cell x[0,0,0] is
    zeroed before the shifts and y[0,0,0] rewritten after."""
    if pinned:
        origin = _origin_mask(x)
        xn = torch.where(origin, torch.zeros((), dtype=x.dtype, device=x.device), x)
    else:
        xn = x
    y = diag * x
    y += cx * (_shift(xn, 2, 1) + _shift(xn, 2, -1))
    y += cy * (_shift(xn, 1, 1) + _shift(xn, 1, -1))
    y += cz * (_shift(xn, 0, 1) + _shift(xn, 0, -1))
    if pinned:
        # pinned row: y[0] = diag[0] * x[0] only
        y = torch.where(origin, diag * x, y)
    return y


def _pad_to(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def padded_shape(shape: tuple[int, int, int]) -> tuple[int, int, int]:
    """The resident layout for a (nz, ny, nx) field."""
    nz, ny, nx = shape
    return (nz + 2 * FACE, ny, _pad_to(nx, 4))


def check_fields(shape: tuple[int, int, int], *fields: torch.Tensor) -> None:
    """Raise unless every field is a contiguous f32 tensor of
    ``padded_shape(shape)`` on one device."""
    want = padded_shape(shape)
    dev = fields[0].device
    for f in fields:
        if tuple(f.shape) != want:
            raise ValueError(f"field {tuple(f.shape)} != padded_shape({shape})={want}")
        if f.dtype != torch.float32:
            raise TypeError(f"field dtype {f.dtype}, the kernels take float32")
        if not f.is_contiguous():
            raise ValueError("fields must be contiguous")
        if f.device != dev:
            raise ValueError(f"fields on {f.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or twin for device {dev}")


def launch_args(shape, *legs):
    """The (nz, ny, nx, nxp, cx, cy, cz) ctypes arguments every entry point takes."""
    nz, ny, nx = shape
    return (nz, ny, nx, padded_shape(shape)[2], *(float(c) for c in legs))


def domain_index(shape, device):
    """Broadcastable padded-layout index vectors (k, j, i) in domain
    coordinates: k counts domain planes (FACE planes sit below k = 0)."""
    nzp, nyp, nxp = padded_shape(shape)
    k = torch.arange(nzp, dtype=torch.int64, device=device)[:, None, None] - FACE
    j = torch.arange(nyp, dtype=torch.int64, device=device)[None, :, None]
    i = torch.arange(nxp, dtype=torch.int64, device=device)[None, None, :]
    return k, j, i


def star7_mv_padded_torch(diag_p, cx, cy, cz, x_p, shape, pinned: bool, z0: int = 0, nzg: int | None = None):
    """Plain twin of K1: the math of ``PaddedStar._mv_xla``
    (``tpusparse/sparse/padded.py:141-175``) on the port's layout.

    ``z0``/``nzg``: the field is one z-slab of a grid of ``nzg`` planes
    whose domain planes are the global planes [z0, z0 + nz), as in
    ``fused7_call``'s sharded form: its face planes hold the neighbouring
    slabs' planes, the domain and the pin are tested in global planes, and
    y is kept on every plane of the global domain the slab holds.  The
    defaults (0, nz) are the whole grid."""
    nz, ny, nx = shape
    nzg = nz if nzg is None else nzg
    k, j, i = domain_index(shape, x_p.device)
    k = k + z0
    in_dom = (k >= 0) & (k < nzg) & (j < ny) & (i < nx)
    zero = torch.zeros((), dtype=x_p.dtype, device=x_p.device)
    if pinned:
        origin = (k == 0) & (j == 0) & (i == 0)
        xn = torch.where(origin, zero, x_p)
    else:
        xn = x_p
    # y is never padded and x may not be: mask the Neumann edges explicitly
    xp_ = torch.where(i < nx - 1, _shift(xn, 2, 1), zero)
    xm_ = torch.where(i > 0, _shift(xn, 2, -1), zero)
    yp_ = torch.where(j < ny - 1, _shift(xn, 1, 1), zero)
    ym_ = torch.where(j > 0, _shift(xn, 1, -1), zero)
    y = diag_p * x_p
    y += cx * (xp_ + xm_)
    y += cy * (yp_ + ym_)
    y += cz * (_shift(xn, 0, 1) + _shift(xn, 0, -1))
    if pinned:
        y = torch.where(origin, diag_p * x_p, y)
    return torch.where(in_dom, y, zero)


_STAR7_ARGS = [_build.P] * 3 + [_build.I] * 4 + [_build.F] * 3 + [_build.I, _build.P]


def star7_mv_padded(diag_p, cx, cy, cz, x_p, shape, pinned: bool):
    """y = A @ x in the padded layout: x's pads must be zero, diag's pads
    are never read; y comes back with zero pads.

    CUDA tensors run ``csrc/stencil7.cu``; CPU tensors the plain twin.
    """
    shape = tuple(shape)
    check_fields(shape, diag_p, x_p)
    if x_p.device.type == "cpu":
        return star7_mv_padded_torch(diag_p, cx, cy, cz, x_p, shape, pinned)
    y = torch.empty_like(x_p)
    _build.launch(
        "tps_star7_mv", _STAR7_ARGS, x_p.device,
        x_p.data_ptr(), diag_p.data_ptr(), y.data_ptr(),
        *launch_args(shape, cx, cy, cz), int(pinned),
    )
    LAUNCHES["star7_mv_padded"] += 1
    return y


_STAR7_PLAIN_ARGS = [_build.P] * 3 + [_build.I] * 3 + [_build.F] * 3 + [_build.I, _build.P]


def star7_mv(diag, cx, cy, cz, x, pinned: bool):
    """y = A @ x on plain (nz, ny, nx) f32 fields (K1p).

    CUDA tensors run ``csrc/stencil7.cu``; CPU tensors the plain twin.
    """
    shape = tuple(x.shape)
    if len(shape) != 3 or tuple(diag.shape) != shape:
        raise ValueError(f"x {shape} and diag {tuple(diag.shape)}: want one (nz, ny, nx)")
    for f in (diag, x):
        if f.dtype != torch.float32:
            raise TypeError(f"field dtype {f.dtype}, the kernel takes float32")
        if not f.is_contiguous():
            raise ValueError("fields must be contiguous")
    if diag.device != x.device:
        raise ValueError(f"fields on {diag.device} and {x.device}")
    if x.device.type == "cpu":
        return star7_mv_torch(diag, cx, cy, cz, x, pinned)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel or twin for device {x.device}")
    y = torch.empty_like(x)
    _build.launch(
        "tps_star7_mv_plain", _STAR7_PLAIN_ARGS, x.device,
        x.data_ptr(), diag.data_ptr(), y.data_ptr(), *shape,
        float(cx), float(cy), float(cz), int(pinned),
    )
    LAUNCHES["star7_mv"] += 1
    return y

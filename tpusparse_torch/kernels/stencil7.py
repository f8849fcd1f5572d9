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
already masked by the domain bounds, so ``csrc/stencil7.cu`` runs the star
on the unpadded field (a geometry with no face planes and ``nxp = nx``) and
skips the 4 field passes of pad and crop.

``star7_mv_batched`` is K1p over a stack of k plain fields, ``(k, nz, ny,
nx)``, in one launch that reads diag once a cell: the f32 fine-level apply
of ``KSP.mat_solve``'s block solve, where the JAX package vmaps the star's
XLA form (``tpusparse/ksp.py:792-806``).  Both kernels spell out every
rounding of the star, so each column of a stack is bit for bit a K1p
launch.  Its twin is ``star7_mv_torch``, which broadcasts over leading
axes.

``star7_mv_halo`` (K1h) is K1p's halo form: the star on one (nz, ny, nx)
block whose neighbours' planes come from four ghost planes, the
counterpart of what ``tpusparse/dist/halo.py::_mv_shard`` computes per
shard.  ``dist/halo.py::halo_mv`` launches it once a rank an apply, on
the rank's whole z-slab with its two received planes; a block of the
mesh, a strided view with y ghosts, takes it too.  One launch marches up
the block in z-chunks of the plan ``halo_plan`` chooses.  Its twin is
``star7_mv_halo_torch``, bit for bit ``star7_mv_torch`` on the cells of
the block.

``star7_mv_padded``, ``star7_mv``, ``star7_mv_batched`` and
``star7_mv_halo`` dispatch by tensor device only: a CPU tensor runs the
plain twin (``star7_mv_padded_torch``, ``star7_mv_torch``,
``star7_mv_halo_torch``), a CUDA tensor launches ``csrc/stencil7.cu`` (or
raises).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

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
    """Boolean mask of the pinned cell (0, 0, 0) of each field, shaped
    like ``x``."""
    m = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    m[..., 0, 0, 0] = True
    return m


def star7_mv_torch(diag, cx, cy, cz, x, pinned: bool):
    """Plain twin of K1p and of ``star7_mv_batched``, and the apply of
    every dtype: y = A @ x on plain (nz, ny, nx) fields of any float dtype,
    or on a stack of them with leading axes (``StarStencil3D.mv``'s math,
    ``tpusparse/sparse/stencil.py:140-152``).  The pinned cell x[0,0,0] is
    zeroed before the shifts and y[0,0,0] rewritten after."""
    if pinned:
        origin = _origin_mask(x)
        xn = torch.where(origin, torch.zeros((), dtype=x.dtype, device=x.device), x)
    else:
        xn = x
    y = diag * x
    y += cx * (_shift(xn, -1, 1) + _shift(xn, -1, -1))
    y += cy * (_shift(xn, -2, 1) + _shift(xn, -2, -1))
    y += cz * (_shift(xn, -3, 1) + _shift(xn, -3, -1))
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


def check_fields(shape: tuple[int, int, int], *fields: torch.Tensor, stack: int | None = None) -> None:
    """Raise unless every field is a contiguous f32 tensor of
    ``padded_shape(shape)`` on one device; with ``stack`` = q, of q such
    fields stacked, ``(q, *padded_shape(shape))``."""
    want = padded_shape(shape) if stack is None else (stack, *padded_shape(shape))
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


_STAR7_PLAIN_ARGS = [_build.P] * 3 + [_build.I] * 4 + [_build.F] * 3 + [_build.I, _build.P]


def _launch_plain(diag, cx, cy, cz, x, pinned: bool, k: int) -> torch.Tensor:
    """Launch K1p over the k stacked plain fields of x (k = 1: one field)."""
    y = torch.empty_like(x)
    _build.launch(
        "tps_star7_mv_plain", _STAR7_PLAIN_ARGS, x.device,
        x.data_ptr(), diag.data_ptr(), y.data_ptr(), *diag.shape, k,
        float(cx), float(cy), float(cz), int(pinned),
    )
    return y


def _check_plain(diag, x, leading: int) -> None:
    """Raise unless diag is one plain (nz, ny, nx) f32 field and x is one
    (``leading`` 0) or a stack of k >= 1 of them (``leading`` 1), both
    contiguous, on one CPU or CUDA device."""
    shape = tuple(x.shape)
    if len(shape) != 3 + leading or tuple(diag.shape) != shape[leading:] or 0 in shape[:leading]:
        want = "one (nz, ny, nx)" if not leading else "x (k >= 1, nz, ny, nx) over diag (nz, ny, nx)"
        raise ValueError(f"x {shape} and diag {tuple(diag.shape)}: want {want}")
    for f in (diag, x):
        if f.dtype != torch.float32:
            raise TypeError(f"field dtype {f.dtype}, the kernel takes float32")
        if not f.is_contiguous():
            raise ValueError("fields must be contiguous")
    if diag.device != x.device:
        raise ValueError(f"fields on {diag.device} and {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or twin for device {x.device}")


def star7_mv(diag, cx, cy, cz, x, pinned: bool):
    """y = A @ x on plain (nz, ny, nx) f32 fields (K1p).

    CUDA tensors run ``csrc/stencil7.cu``; CPU tensors the plain twin.
    """
    _check_plain(diag, x, 0)
    if x.device.type == "cpu":
        return star7_mv_torch(diag, cx, cy, cz, x, pinned)
    y = _launch_plain(diag, cx, cy, cz, x, pinned, 1)
    LAUNCHES["star7_mv"] += 1
    return y


def star7_mv_batched(diag, cx, cy, cz, x, pinned: bool):
    """y[c] = A @ x[c] for each column c of the f32 stack x (k, nz, ny, nx),
    over one diag (nz, ny, nx): K1p over the stack in one launch, each
    column bit for bit one ``star7_mv`` launch.

    CUDA tensors run ``csrc/stencil7.cu``; CPU tensors the plain twin.
    """
    _check_plain(diag, x, 1)
    if x.device.type == "cpu":
        return star7_mv_torch(diag, cx, cy, cz, x, pinned)
    y = _launch_plain(diag, cx, cy, cz, x, pinned, x.shape[0])
    LAUNCHES["star7_mv_batched"] += 1
    return y


def star7_mv_halo_torch(diag, cx, cy, cz, x, zlo, zhi, ylo, yhi, origin: int = -1):
    """Plain twin of K1h, and the halo apply of every dtype: y = A @ x on
    one (nz, ny, nx) block whose neighbours' planes are the ghosts ``zlo``,
    ``zhi`` (ny, nx) and ``ylo``, ``yhi`` (nz, nx), None for a zero face.
    ``origin``: the block's flat index of the pinned cell, or -1; the
    ghosts come with it masked already.  Each cell is ``star7_mv_torch``'s
    arithmetic on the same operands, so the blocks' outputs are bit for bit
    its output on the global field."""
    nz, ny, nx = x.shape
    ext = x.new_zeros((nz + 2, ny + 2, nx))
    ext[1:-1, 1:-1] = x
    if origin >= 0:
        k, j, i = _unravel(origin, ny, nx)
        ext[1 + k, 1 + j, i] = 0.0
    for g, idx in ((zlo, (0, slice(1, -1))), (zhi, (-1, slice(1, -1))),
                   (ylo, (slice(1, -1), 0)), (yhi, (slice(1, -1), -1))):
        if g is not None:
            ext[idx] = g
    xn = ext[1:-1, 1:-1]
    y = diag * x
    y += cx * (_shift(xn, -1, 1) + _shift(xn, -1, -1))
    y += cy * (ext[1:-1, 2:] + ext[1:-1, :-2])
    y += cz * (ext[2:, 1:-1] + ext[:-2, 1:-1])
    if origin >= 0:
        y[k, j, i] = diag[k, j, i] * x[k, j, i]
    return y


def _unravel(q: int, ny: int, nx: int) -> tuple[int, int, int]:
    k, rem = divmod(int(q), ny * nx)
    return (k, *divmod(rem, nx))


_STAR7_HALO_ARGS = (
    [_build.P] * 3 + [_build.I] * 3 + [_build.L] * 4 + [_build.P] * 4 + [_build.F] * 3 + [_build.L]
    + [_build.I] * 5 + [_build.P]
)

# csrc/stencil7.cu's HX_TY x HX_TX tile of a block of 256 threads, a quad of
# 4 x cells a thread; its ring of HX_DEPTH staged planes of the tile's rows
# and one a side, HX_ROW floats a row; the blocks an SM must hold
# (HX_MIN_BLOCKS, __launch_bounds__), what a wave of blocks is
HALO_TILE = (16, 64)
HALO_SMEM_BYTES = 4 * (HALO_TILE[0] + 2) * (HALO_TILE[1] + 8) * 4
HALO_BLOCKS_PER_SM = 3
H100_SMS = 132


def wave_zchunk(nz: int, tiles: int, wave: int, halo: int) -> int:
    """The z-chunk of a z-marching launch of ``tiles`` column tiles over
    ``nz`` planes, a wave being the ``wave`` blocks the card holds at once.

    The rule: a launch costs about (its waves of blocks, rounded up) times
    (the planes a block marches, zchunk + 2 ``halo``).  Of every chunk
    count n = 1 .. nz (chunks of ceil(nz / n) planes, equal but the last),
    take the one of least cost; of equal costs, the fewest chunks (the
    fewest halo planes read twice).  A short chunk re-reads its 2 ``halo``
    planes more often (a chunk of 27 reads 22% more with a halo of 3),
    which the rule trades against a last wave that leaves SMs idle."""

    def cost(zchunk):
        chunks = -(-nz // zchunk)
        return -(-tiles * chunks // wave) * (zchunk + 2 * halo), chunks

    return min({-(-nz // n) for n in range(1, nz + 1)}, key=cost)


@dataclass(frozen=True)
class HaloPlan:
    """The grid of one K1h launch: ``tiles_y`` x ``tiles_x`` tiles of
    ``HALO_TILE`` cells over the (ny, nx) plane times ``chunks`` z-chunks
    of ``zchunk`` planes, one block of 256 threads each, ``smem_bytes`` of
    dynamic shared memory a block."""

    tiles_x: int
    tiles_y: int
    chunks: int
    zchunk: int
    smem_bytes: int = HALO_SMEM_BYTES

    @property
    def blocks(self) -> int:
        return self.tiles_x * self.tiles_y * self.chunks

    def waves(self) -> float:
        """Blocks over the blocks the H100's SMs hold at once."""
        return self.blocks / (H100_SMS * HALO_BLOCKS_PER_SM)

    def ranges(self, shape) -> tuple[list, list, list]:
        """The cells the blocks write along z, y and x, as the kernel
        computes them from ``blockIdx``: chunk c planes [c zchunk, min((c +
        1) zchunk, nz)), tile t rows [t TY, min((t + 1) TY, ny)), likewise
        in x."""
        nz, ny, nx = shape
        ty, tx = HALO_TILE

        def cut(n, step, parts):
            return [(c * step, min((c + 1) * step, n)) for c in range(parts)]

        return cut(nz, self.zchunk, self.chunks), cut(ny, ty, self.tiles_y), cut(nx, tx, self.tiles_x)

    def launch_args(self) -> tuple[int, int, int, int, int]:
        return self.tiles_x, self.tiles_y, self.chunks, self.zchunk, self.smem_bytes


@functools.lru_cache(maxsize=None)
def halo_plan(shape: tuple[int, int, int]) -> HaloPlan:
    """The plan of one K1h launch over an (nz, ny, nx) block: the tiles
    that cover the plane, and the z-chunks by ``wave_zchunk``'s rule (a
    halo of one plane).  At 300^3 (95 tiles) 4 chunks of 75: 380 blocks,
    one wave of 396; a (75, 300, 300) rank slab 4 chunks of 19.  Cached: a
    solve asks for the same plan every apply."""
    nz, ny, nx = shape
    ty, tx = HALO_TILE
    tiles_y, tiles_x = -(-ny // ty), -(-nx // tx)
    zchunk = wave_zchunk(nz, tiles_x * tiles_y, H100_SMS * HALO_BLOCKS_PER_SM, 1)
    return HaloPlan(tiles_x=tiles_x, tiles_y=tiles_y, chunks=-(-nz // zchunk), zchunk=zchunk)


def halo_attributes(aligned: bool = True) -> dict:
    """K1h's compiled kernel (on the card), its 16-byte (``aligned``) or
    4-byte form: registers a thread, spilled bytes a thread, static shared
    bytes a block and the blocks an SM holds with the plan's dynamic
    shared bytes."""
    fn = _build.library().tps_halo_attributes
    fn.argtypes = [_build.I, _build.P, _build.P, _build.P, _build.P]
    fn.restype = _build.I
    out = [ctypes.c_int() for _ in range(4)]
    rc = fn(int(aligned), *(ctypes.byref(v) for v in out))
    if rc != 0:
        raise RuntimeError(f"tps_halo_attributes: CUDA error {rc}")
    names = ("registers", "spilled_bytes", "static_smem_bytes", "blocks_per_sm")
    return dict(zip(names, (v.value for v in out)))


def _check_halo(diag, x, out, ghosts) -> None:
    """Raise unless x, diag and out are f32 (nz, ny, nx) views of one
    shape, unit stride in x, x and diag with one set of strides, and each
    ghost is None or a contiguous f32 plane of its face's shape, all on
    one CPU or CUDA device."""
    if x.dim() != 3 or 0 in x.shape:
        raise ValueError(f"x {tuple(x.shape)}: want one (nz, ny, nx) block")
    nz, ny, nx = x.shape

    def strides(f):   # a dim of one cell has no stride that matters
        return tuple(st for st, n in zip(f.stride(), f.shape) if n > 1)

    if diag.shape != x.shape or strides(diag) != strides(x):
        raise ValueError(f"diag {tuple(diag.shape)}/{diag.stride()} != x {tuple(x.shape)}/{x.stride()}")
    if out is not None and out.shape != x.shape:
        raise ValueError(f"out {tuple(out.shape)} != x {tuple(x.shape)}")
    if x.stride(2) != 1 or (out is not None and out.stride(2) != 1):
        raise ValueError("the block and its output must be unit-stride in x")
    faces = {"zlo": (ny, nx), "zhi": (ny, nx), "ylo": (nz, nx), "yhi": (nz, nx)}
    for (name, want), g in zip(faces.items(), ghosts):
        if g is not None and (tuple(g.shape) != want or not g.is_contiguous()):
            raise ValueError(f"ghost {name} {tuple(g.shape)}: want a contiguous {want}")
    fields = [f for f in (diag, x, out, *ghosts) if f is not None]
    for f in fields:
        if f.dtype != torch.float32:
            raise TypeError(f"field dtype {f.dtype}, the kernel takes float32")
        if f.device != x.device:
            raise ValueError(f"fields on {f.device} and {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or twin for device {x.device}")


def star7_mv_halo(diag, cx, cy, cz, x, zlo, zhi, ylo, yhi, origin: int = -1, out=None):
    """y = A @ x on one f32 block with its ghost planes (K1h): a rank's
    slab or a (z, y) block of it; see ``star7_mv_halo_torch`` for the
    arguments.  ``x``, ``diag`` and ``out`` may be strided views of a
    rank's slab (x and diag with one set of strides, all unit stride in
    x): y is written into ``out`` (a new contiguous block when None) and
    returned.

    CUDA tensors run ``csrc/stencil7.cu``, one launch of ``halo_plan``'s
    grid; CPU tensors the plain twin.
    """
    ghosts = (zlo, zhi, ylo, yhi)
    _check_halo(diag, x, out, ghosts)
    if x.device.type == "cpu":
        y = star7_mv_halo_torch(diag, cx, cy, cz, x, *ghosts, origin)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    nz, ny, nx = x.shape
    _build.launch(
        "tps_star7_mv_halo", _STAR7_HALO_ARGS, x.device,
        x.data_ptr(), diag.data_ptr(), out.data_ptr(), nz, ny, nx, x.stride(0), x.stride(1), out.stride(0),
        out.stride(1),
        *(0 if g is None else g.data_ptr() for g in ghosts), float(cx), float(cy), float(cz), int(origin),
        *halo_plan((nz, ny, nx)).launch_args(),
    )
    LAUNCHES["star7_mv_halo"] += 1
    return out

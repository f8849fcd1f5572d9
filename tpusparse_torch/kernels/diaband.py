"""K5: general banded (DIA) SpMV — port of ``tpusparse/kernels/diaband.py``.

    y[r] = sum_{k=0..K-1} bands[k, r] * x[r + offsets[k]]    (term dropped
                                                          outside [0, n))

This is the general-matrix path's MatMult_SeqAIJ (reference
``src/openacc-step1/MatMult_SeqAIJ.patch:19-30``): every f32 level apply of
the aij V-cycle and inner CG.  The TPU kernel streams slabs of a
slab-major band stack (``stack_bands``) through VMEM; that layout only
arranges DMAs on the TPU, so the port keeps the container's own
band-major ``(K, n)`` layout.

``dia_mv_batched`` is K5 over a stack of k columns, ``X (k, n) -> Y (k,
n)``: ``KSP.mat_solve``'s apply of a DIA operator, which the JAX package
runs as the vmapped XLA form of ``DIA.mv`` (``tpusparse/ksp.py:792-810``).
One launch reads each band value once for every 4 columns, and each column
is bit for bit a ``dia_mv`` launch on it: both kernels spell out every
rounding.

``dia_mv_window`` is K5h, K5 on one rank's contiguous rows [r0, r0 + nl)
of an n-row matrix with the two windows of x it received from the ranks
that hold them (``dist/general.py::DistDIA``; the JAX package's
``DistDIA._mv_shard`` applies the same function per shard): the rows of
every rank's launch, put together, are bit for bit one K5 launch on the
whole vector, for any split.  K5 and K5h are one CUDA kernel: a
``dia_mv`` launch is K5h on all n rows with no windows.

``dia_mv``, ``dia_mv_batched`` and ``dia_mv_window`` dispatch by tensor
device only: a CPU tensor runs the plain twin (``dia_mv_torch``, one
function for the first two: it shifts along the last axis;
``dia_mv_window_torch``), a CUDA tensor launches ``csrc/diaband.cu`` (or
raises).  Both take float32 only, as the Pallas K5 does
(``tpusparse/kernels/diaband.py:101-105``); ``DIA.mv`` applies a band
stack of any other dtype in plain torch.
"""

from __future__ import annotations

import ctypes

import torch

from tpusparse_torch.kernels import LAUNCHES, _build

MAX_BANDS = 192  # the DIA family's cap, DIA.host_bands(max_offsets=192)


def _shift(x: torch.Tensor, o: int, n: int | None = None, dim: int = -1) -> torch.Tensor:
    """y[..., r, ...] = x[..., r + o, ...] for r in [0, n) along ``dim``,
    zeros shifted in.  ``n`` defaults to x's length there (square
    frame)."""
    m = x.shape[dim]
    n = m if n is None else n
    if o == 0 and n == m:
        return x
    shape = list(x.shape)
    shape[dim] = n
    y = x.new_zeros(shape)
    lo, hi = max(0, -o), min(n, m - o)
    if hi > lo:
        y.narrow(dim, lo, hi - lo).copy_(x.narrow(dim, lo + o, hi - lo))
    return y


def dia_mv_torch(bands: torch.Tensor, x: torch.Tensor, offsets) -> torch.Tensor:
    """Plain twin of K5 and of the batched K5: one shift and multiply-add
    per band, in ascending band order (``tpusparse/sparse/dia.py:163-170``),
    along the last axis of x, a vector (n,) or a stack of columns (k, n)."""
    n = bands.shape[1]
    y = bands[0] * _shift(x, offsets[0], n)
    for k, o in enumerate(offsets[1:], start=1):
        y = y + bands[k] * _shift(x, o, n)
    return y


def check_operands(bands: torch.Tensor, x: torch.Tensor, offsets, stacked: bool = False) -> None:
    """Raise unless ``bands`` (K, n) and ``x`` ((n,), or (k, n) when
    ``stacked``) are contiguous f32 tensors on one device, with 1 <= K <=
    MAX_BANDS (192), K offsets and n < 2^31."""
    want = 2 if stacked else 1
    if bands.dim() != 2 or x.dim() != want or x.shape[-1] != bands.shape[1]:
        raise ValueError(
            f"bands {tuple(bands.shape)} and x {tuple(x.shape)}: want (K, n) and"
            f" {'(k, n)' if stacked else '(n,)'}"
        )
    k, n = bands.shape
    if not 1 <= k <= MAX_BANDS or len(offsets) != k:
        raise ValueError(f"{k} bands and {len(offsets)} offsets: want 1 <= K <= {MAX_BANDS} of each")
    if n >= 2**31:
        raise ValueError(f"n = {n} rows: the kernel takes n < 2^31")
    for t in (bands, x):
        if t.dtype != torch.float32:
            raise TypeError(f"dtype {t.dtype}, the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError("bands and x must be contiguous")
    if bands.device != x.device:
        raise ValueError(f"bands on {bands.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or twin for device {x.device}")


_DIA_ARGS = [_build.P] * 3 + [ctypes.c_longlong, _build.I, ctypes.POINTER(ctypes.c_longlong), _build.P]


def dia_mv(bands: torch.Tensor, x: torch.Tensor, offsets) -> torch.Tensor:
    """y = A @ x for the DIA matrix (``bands``, ``offsets``).

    CUDA tensors run ``csrc/diaband.cu``; CPU tensors the plain twin.
    """
    check_operands(bands, x, offsets)
    if x.device.type == "cpu":
        return dia_mv_torch(bands, x, offsets)
    k, n = bands.shape
    y = torch.empty_like(x)
    offs = (ctypes.c_longlong * k)(*(int(o) for o in offsets))
    _build.launch(
        "tps_dia_mv", _DIA_ARGS, x.device,
        bands.data_ptr(), x.data_ptr(), y.data_ptr(), n, k, offs,
    )
    LAUNCHES["dia_mv"] += 1
    return y


_DIA_BATCHED_ARGS = _DIA_ARGS[:-1] + [_build.I, _build.P]


def dia_mv_batched(bands: torch.Tensor, x: torch.Tensor, offsets) -> torch.Tensor:
    """Y[c] = A @ X[c] for each column c of the f32 stack ``x`` (k, n): K5
    over the stack in one launch, each column bit for bit one ``dia_mv``
    launch.

    CUDA tensors run ``csrc/diaband.cu``; CPU tensors the plain twin.
    """
    check_operands(bands, x, offsets, stacked=True)
    if x.device.type == "cpu":
        return dia_mv_torch(bands, x, offsets)
    k, n = bands.shape
    y = torch.empty_like(x)
    offs = (ctypes.c_longlong * k)(*(int(o) for o in offsets))
    _build.launch(
        "tps_dia_mv_batched", _DIA_BATCHED_ARGS, x.device,
        bands.data_ptr(), x.data_ptr(), y.data_ptr(), n, k, offs, x.shape[0],
    )
    LAUNCHES["dia_mv_batched"] += 1
    return y


def window_reach(offsets) -> tuple[int, int]:
    """(below, above): how far the bands reach below and above a row."""
    return max(0, -min(offsets)), max(0, max(offsets))


def dia_mv_window_torch(bands: torch.Tensor, x: torch.Tensor, offsets, xlo: torch.Tensor, xhi: torch.Tensor,
                        r0: int, n: int) -> torch.Tensor:
    """Plain twin of K5h: ``dia_mv_torch``'s terms on the rows [r0, r0 +
    nl), in its order, against the rank's columns [r0 - hl, r0 + nl + hh)
    (its windows and its own x) with zeros past them, which is where the
    columns outside [0, n) fall: bit for bit ``dia_mv_torch`` of the whole
    vector on those rows."""
    nl = bands.shape[1]
    below, above = window_reach(offsets)
    hl, hh = xlo.shape[0], xhi.shape[0]
    ext = x.new_zeros(below + nl + above)
    ext[below - min(hl, below):below] = xlo[hl - min(hl, below):]
    ext[below:below + nl] = x
    ext[below + nl:below + nl + min(hh, above)] = xhi[:min(hh, above)]
    y = bands[0] * ext[below + offsets[0]:below + offsets[0] + nl]
    for k, o in enumerate(offsets[1:], start=1):
        y = y + bands[k] * ext[below + o:below + o + nl]
    return y


def check_window_operands(bands, x, offsets, xlo, xhi, r0: int, n: int) -> None:
    """``check_operands`` of the rank's bands (K, nl) and x (nl,), and of
    its windows: contiguous f32 vectors on x's device, inside [0, n)
    (``hl <= r0``, ``r0 + nl + hh <= n``), each no shorter than the reach
    of the bands that read it (``hl >= min(r0, below)``, ``hh >= min(n -
    r0 - nl, above)``)."""
    check_operands(bands, x, offsets)
    for name, t in (("xlo", xlo), ("xhi", xhi)):
        if t.dim() != 1 or t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on {t.device}: want a contiguous float32 vector"
                             f" on {x.device}")
    nl, hl, hh = bands.shape[1], xlo.shape[0], xhi.shape[0]
    if n >= 2**31:
        raise ValueError(f"n = {n} rows: the kernel takes n < 2^31")
    if r0 < 0 or hl > r0 or r0 + nl + hh > n:
        raise ValueError(f"rows [{r0}, {r0 + nl}) with windows of {hl} and {hh}: not inside the {n} rows")
    below, above = window_reach(offsets)
    if hl < min(r0, below) or hh < min(n - r0 - nl, above):
        raise ValueError(f"windows of {hl} and {hh} entries: the bands reach {below} below and {above} above"
                         f" rows [{r0}, {r0 + nl}) of {n}")


_DIA_WINDOW_ARGS = [_build.P] * 5 + [_build.L] * 5 + [_build.I, ctypes.POINTER(ctypes.c_longlong), _build.P]


def dia_mv_window(bands: torch.Tensor, x: torch.Tensor, offsets, xlo: torch.Tensor, xhi: torch.Tensor,
                  r0: int, n: int) -> torch.Tensor:
    """y[i] = sum_k bands[k, i] * x(r0 + i + offsets[k]) on the rank's rows
    [r0, r0 + nl) of the n-row matrix: ``x`` the rank's own entries, ``xlo``
    the hl entries below r0 and ``xhi`` the hh entries above r0 + nl.

    CUDA tensors run ``csrc/diaband.cu`` (K5h); CPU tensors the plain twin.
    """
    check_window_operands(bands, x, offsets, xlo, xhi, r0, n)
    if x.device.type == "cpu":
        return dia_mv_window_torch(bands, x, offsets, xlo, xhi, r0, n)
    k, nl = bands.shape
    y = torch.empty_like(x)
    offs = (ctypes.c_longlong * k)(*(int(o) for o in offsets))
    _build.launch(
        "tps_dia_mv_window", _DIA_WINDOW_ARGS, x.device,
        bands.data_ptr(), x.data_ptr(), xlo.data_ptr(), xhi.data_ptr(), y.data_ptr(),
        nl, r0, n, xlo.shape[0], xhi.shape[0], k, offs,
    )
    LAUNCHES["dia_mv_window"] += 1
    return y

"""K5: general banded (DIA) SpMV — port of ``tpusparse/kernels/diaband.py``.

    y[r] = sum_{k=0..K-1} bands[k, r] * x[r + offsets[k]]    (term dropped
                                                          outside [0, n))

This is the general-matrix path's MatMult_SeqAIJ (reference
``src/openacc-step1/MatMult_SeqAIJ.patch:19-30``): every f32 level apply of
the aij V-cycle and inner CG.  The TPU kernel streams slabs of a
slab-major band stack (``stack_bands``) through VMEM; that layout only
arranges DMAs on the TPU, so the port keeps the container's own
band-major ``(K, n)`` layout.

``dia_mv`` dispatches by tensor device only: a CPU tensor runs the plain
twin ``dia_mv_torch``, a CUDA tensor launches ``csrc/diaband.cu`` (or
raises).
"""

from __future__ import annotations

import ctypes

import torch

from tpusparse_torch.kernels import LAUNCHES, _build

MAX_BANDS = 48


def _shift(x: torch.Tensor, o: int, n: int | None = None) -> torch.Tensor:
    """y[r] = x[r + o] for r in [0, n), zeros shifted in, along axis 0.
    ``n`` defaults to len(x) (square frame)."""
    m = x.shape[0]
    n = m if n is None else n
    if o == 0 and n == m:
        return x
    y = x.new_zeros((n,) + tuple(x.shape[1:]))
    lo, hi = max(0, -o), min(n, m - o)
    if hi > lo:
        y[lo:hi] = x[lo + o:hi + o]
    return y


def dia_mv_torch(bands: torch.Tensor, x: torch.Tensor, offsets) -> torch.Tensor:
    """Plain twin of K5: one shift and multiply-add per band, in ascending
    band order (``tpusparse/sparse/dia.py:163-170``)."""
    n = bands.shape[1]
    y = bands[0] * _shift(x, offsets[0], n)
    for k, o in enumerate(offsets[1:], start=1):
        y = y + bands[k] * _shift(x, o, n)
    return y


def check_operands(bands: torch.Tensor, x: torch.Tensor, offsets) -> None:
    """Raise unless ``bands`` (K, n) and ``x`` (n,) are contiguous f32
    tensors on one device, with 1 <= K <= 48, K offsets and n < 2^31."""
    if bands.dim() != 2 or x.dim() != 1 or x.shape[0] != bands.shape[1]:
        raise ValueError(f"bands {tuple(bands.shape)} and x {tuple(x.shape)}: want (K, n) and (n,)")
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

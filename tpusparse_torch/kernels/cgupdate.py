"""CG's vector updates in two streaming launches an iteration:
``cg_update_r`` (r' = r - alpha ap) and ``cg_update_xp`` (x' = x + alpha p
and p' = z + beta p, reading p once), for ``solve/cg.py``'s loop.

The JAX package has no kernel here: its CG body leaves the three updates
to one XLA fusion (``tpusparse/solve/cg.py``).  Their PyTorch form, the
twins ``cg_update_r_torch`` / ``cg_update_xp_torch``, is the loop's three
statements: each a multiply by the 0-d device scalar and an add, six
launches and 15 passes over the field an iteration.  ``csrc/cgupdate.cu``
makes it two launches and 8 passes, and rounds as the twins do, so the
two agree bit for bit.

The fields are one shape, one dtype (f32 or f64) and contiguous; alpha
and beta are 0-d tensors of f32 or f64 on the fields' device, read there
(no host synchronisation).  Outputs are new tensors: no input is written.
A field whose base is not 16-byte aligned (a view at an offset) is taken
a cell at a time by the same launch.

Both dispatch by tensor device only: a CPU tensor runs the twin, a CUDA
tensor launches the kernel (or raises).  The checks hold on either.
"""

from __future__ import annotations

import torch

from tpusparse_torch.kernels import LAUNCHES, _build

# the entry points' code of each field dtype, and the scalar dtypes they read
DTYPES = {torch.float32: 0, torch.float64: 1}
SCALAR_DTYPES = (torch.float32, torch.float64)


def cg_update_r_torch(r, ap, alpha):
    """Plain twin of ``cg_update_r``: CG's residual update as torch ops."""
    return r - alpha * ap


def cg_update_xp_torch(x, p, z, alpha, beta):
    """Plain twin of ``cg_update_xp``: CG's solution and direction updates
    as torch ops."""
    return x + alpha * p, z + beta * p


def _check(name, fields, scalars) -> None:
    """Raise unless ``fields`` are contiguous tensors of one shape, dtype
    (f32 / f64) and device, and ``scalars`` 0-d f32 / f64 tensors there."""
    first = fields[0]
    for t in fields:
        if t.device != first.device:
            raise ValueError(f"{name}: fields on {first.device} and {t.device}")
        if t.shape != first.shape:
            raise ValueError(f"{name}: fields of shapes {tuple(first.shape)} and {tuple(t.shape)}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: fields of {first.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: a field is not contiguous")
    if first.dtype not in DTYPES:
        raise TypeError(f"{name}: no kernel for {first.dtype} fields; it takes {list(DTYPES)}")
    for s in scalars:
        if s.dim() != 0 or s.device != first.device or s.dtype not in SCALAR_DTYPES:
            raise ValueError(f"{name}: want a 0-d f32 / f64 scalar on {first.device}, got {s.dtype} "
                             f"{tuple(s.shape)} on {s.device}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel or twin for device {first.device}")


# the entry points' argument types, the stream last
_R_ARGS = [_build.P] * 4 + [_build.L, _build.I, _build.I, _build.P]
_XP_ARGS = [_build.P] * 7 + [_build.L] + [_build.I] * 3 + [_build.P]


def cg_update_r(r: torch.Tensor, ap: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """r - alpha ap, as a new tensor.

    CUDA tensors run ``csrc/cgupdate.cu``'s ``cg_update_r_kernel``, one
    launch; CPU tensors the twin.
    """
    _check("cg_update_r", (r, ap), (alpha,))
    if r.device.type == "cpu":
        return cg_update_r_torch(r, ap, alpha)
    out = torch.empty_like(r)
    _build.launch("tps_cg_update_r", _R_ARGS, r.device, r.data_ptr(), ap.data_ptr(), alpha.data_ptr(),
                  out.data_ptr(), r.numel(), DTYPES[r.dtype], int(alpha.dtype == torch.float64))
    LAUNCHES["cg_update_r"] += 1
    return out


def cg_update_xp(x: torch.Tensor, p: torch.Tensor, z: torch.Tensor, alpha: torch.Tensor,
                 beta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + alpha p, z + beta p), as new tensors.

    CUDA tensors run ``csrc/cgupdate.cu``'s ``cg_update_xp_kernel``, one
    launch that reads p once; CPU tensors the twin.
    """
    _check("cg_update_xp", (x, p, z), (alpha, beta))
    if x.device.type == "cpu":
        return cg_update_xp_torch(x, p, z, alpha, beta)
    x_out, p_out = torch.empty_like(x), torch.empty_like(p)
    _build.launch("tps_cg_update_xp", _XP_ARGS, x.device, x.data_ptr(), p.data_ptr(), z.data_ptr(),
                  alpha.data_ptr(), beta.data_ptr(), x_out.data_ptr(), p_out.data_ptr(), x.numel(),
                  DTYPES[x.dtype], int(alpha.dtype == torch.float64), int(beta.dtype == torch.float64))
    LAUNCHES["cg_update_xp"] += 1
    return x_out, p_out

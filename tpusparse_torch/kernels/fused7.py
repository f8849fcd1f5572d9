"""K2-K4: the fused fine-level kernels of the CG + GAMG solve — port of the
modes ``mvdot``, ``descent_rr`` and ``ascent_rz`` of
``tpusparse/kernels/fused7.py::fused7_call``.

=========== ======================================================== =====
wrapper     computes                                                 dot
=========== ======================================================== =====
mvdot       y = A x                                                  <x,y>
descent_rr  u = (s0 b) D^-1;  x1 = u + ad u + g D^-1 (b - A u)       <b,b>
            r = b - A x1;  s = r - gw A (D^-1 r)
            out: (x1, s) — the V-cycle's fine-level downstroke
ascent_rz   x2 = x1 + t - gw D^-1 (A t)                              <b,x4>
            d = g D^-1 (b - A x2);  x3 = x2 + d
            x4 = x3 + ad d + g2 D^-1 (b - A x3)
            out: x4 — the V-cycle's fine-level upstroke
=========== ======================================================== =====

D is ``diag`` (pads 1.0), inverted by true division.  All fields are in the
padded-resident layout (``kernels/stencil7.py::padded_shape``).  The dots are
what CG needs next: ``<p, Ap>`` for alpha, ``||r||^2`` and ``<r, z>`` (the
cycle's input b IS the residual and its output IS z).

Each wrapper dispatches by tensor device only: a CPU tensor runs its plain
twin (the math of ``fused7_xla``, ``tpusparse/kernels/fused7.py:945-1023``),
a CUDA tensor launches ``csrc/fused7.cu`` (or raises).  The kernels' dots
come back as a 0-d device tensor summed in a fixed order from one partial
per block — no atomics, so a solve repeats its iteration counts.
"""

from __future__ import annotations

import torch

from tpusparse_torch.kernels import LAUNCHES, _build
from tpusparse_torch.kernels.stencil7 import (
    check_fields,
    launch_args,
    padded_shape,
    star7_mv_padded_torch,
)

P, I, F = _build.P, _build.I, _build.F
_MVDOT_ARGS = [P] * 4 + [I] * 4 + [F] * 3 + [I, P]
_DESCENT_ARGS = [P] * 6 + [I] * 4 + [F] * 7 + [I, P]
_ASCENT_ARGS = [P] * 9 + [I] * 4 + [F] * 7 + [I, P]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _partials(shape, device) -> torch.Tensor:
    """Scratch for one dot partial per thread block."""
    cells = 1
    for n in padded_shape(shape):
        cells *= n
    block = _build.block_size()
    return torch.empty((cells + block - 1) // block, dtype=torch.float32, device=device)


# --- plain twins -------------------------------------------------------------

def fused7_mvdot_torch(diag_p, cx, cy, cz, x_p, shape, pinned: bool):
    y = star7_mv_padded_torch(diag_p, cx, cy, cz, x_p, shape, pinned)
    return y, _dot(x_p, y)


def fused7_descent_rr_torch(
    diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned: bool,
):
    def mv(v):
        return star7_mv_padded_torch(diag_p, cx, cy, cz, v, shape, pinned)

    dinv = 1.0 / diag_p
    u = (s0 * b_p) * dinv
    x1 = u + ad * u + g * (dinv * (b_p - mv(u)))
    r = b_p - mv(x1)
    s = r - gw * mv(dinv * r)
    return x1, s, _dot(b_p, b_p)


def fused7_ascent_rz_torch(
    diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned: bool,
):
    def mv(v):
        return star7_mv_padded_torch(diag_p, cx, cy, cz, v, shape, pinned)

    dinv = 1.0 / diag_p
    x2 = x1_p + t_p - gw * (dinv * mv(t_p))
    d = g * (dinv * (b_p - mv(x2)))
    x3 = x2 + d
    x4 = x3 + ad * d + g2 * (dinv * (b_p - mv(x3)))
    return x4, _dot(b_p, x4)


# --- kernel wrappers -----------------------------------------------------------

def fused7_mvdot(diag_p, cx, cy, cz, x_p, shape, pinned: bool):
    """``(A x, <x, A x>)`` in one launch (K2)."""
    shape = tuple(shape)
    check_fields(shape, diag_p, x_p)
    if x_p.device.type == "cpu":
        return fused7_mvdot_torch(diag_p, cx, cy, cz, x_p, shape, pinned)
    y = torch.empty_like(x_p)
    partials = _partials(shape, x_p.device)
    _build.launch(
        "tps_mvdot", _MVDOT_ARGS, x_p.device,
        x_p.data_ptr(), diag_p.data_ptr(), y.data_ptr(), partials.data_ptr(),
        *launch_args(shape, cx, cy, cz), int(pinned),
    )
    LAUNCHES["fused7_mvdot"] += 1
    return y, partials.sum()


def fused7_descent_rr(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned: bool):
    """``(x1, s, <b, b>)``: the fine-level downstroke (K3).  The kernel
    sequence keeps the residual r in scratch device memory."""
    shape = tuple(shape)
    check_fields(shape, diag_p, b_p)
    if b_p.device.type == "cpu":
        return fused7_descent_rr_torch(
            diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned
        )
    x1, r, s = (torch.empty_like(b_p) for _ in range(3))
    partials = _partials(shape, b_p.device)
    _build.launch(
        "tps_descent_rr", _DESCENT_ARGS, b_p.device,
        b_p.data_ptr(), diag_p.data_ptr(), x1.data_ptr(), r.data_ptr(),
        s.data_ptr(), partials.data_ptr(), *launch_args(shape, cx, cy, cz),
        float(s0), float(ad), float(g), float(gw), int(pinned),
    )
    LAUNCHES["fused7_descent_rr"] += 1
    return x1, s, partials.sum()


def fused7_ascent_rz(
    diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned: bool,
):
    """``(x4, <b, x4>)``: the fine-level upstroke (K4).  The kernel
    sequence keeps x2, d and x3 in scratch device memory."""
    shape = tuple(shape)
    check_fields(shape, diag_p, t_p, b_p, x1_p)
    if t_p.device.type == "cpu":
        return fused7_ascent_rz_torch(
            diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned
        )
    x2, d, x3, x4 = (torch.empty_like(t_p) for _ in range(4))
    partials = _partials(shape, t_p.device)
    _build.launch(
        "tps_ascent_rz", _ASCENT_ARGS, t_p.device,
        t_p.data_ptr(), b_p.data_ptr(), x1_p.data_ptr(), diag_p.data_ptr(),
        x2.data_ptr(), d.data_ptr(), x3.data_ptr(), x4.data_ptr(),
        partials.data_ptr(), *launch_args(shape, cx, cy, cz),
        float(g), float(ad), float(g2), float(gw), int(pinned),
    )
    LAUNCHES["fused7_ascent_rz"] += 1
    return x4, partials.sum()

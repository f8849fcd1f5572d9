"""K2-K4, K6, K7: the fused fine-level kernels of the GAMG V-cycle — port of
the modes ``mvdot``, ``descent(_rr)``, ``ascent(_rz)``, ``descent1(_rr)``
and ``ascent1(_rz)`` of ``tpusparse/kernels/fused7.py::fused7_call``.

=========== ======================================================== =====
wrapper     computes                                                 dot
=========== ======================================================== =====
mvdot       y = A x                                                  <x,y>
descent_rr  u = (s0 b) D^-1;  x1 = u + ad u + g D^-1 (b - A u)       <b,b>
            r = b - A x1;  s = r - gw A (D^-1 r)
            out: (x1, s) — the degree-2 fine-level downstroke
ascent_rz   x2 = x1 + t - gw D^-1 (A t)                              <b,x4>
            d = g D^-1 (b - A x2);  x3 = x2 + d
            x4 = x3 + ad d + g2 D^-1 (b - A x3)
            out: x4 — the degree-2 fine-level upstroke
descent1_rr x1 = g D^-1 b;  r = b - A x1;  s = r - gw A (D^-1 r)     <b,b>
            out: (x1, s) — the degree-1 downstroke
ascent1_rz  x2 = x1 + t - gw D^-1 (A t);  x3 = x2 + g D^-1 (b - A x2) <b,x3>
            out: x3 — the degree-1 upstroke
=========== ======================================================== =====

``descent``, ``ascent``, ``descent1`` and ``ascent1`` (K3'/K4'/K6'/K7')
are the same four without the dot: the same CUDA kernels with the dot
epilogue compiled out, for the V-cycle of the non-CG solvers.  The dots are
what CG needs next: ``<p, Ap>`` for alpha, ``||r||^2`` and ``<r, z>`` (the
cycle's input b IS the residual and its output IS z).

D is ``diag`` (pads 1.0), inverted by true division.  All fields are in the
padded-resident layout (``kernels/stencil7.py::padded_shape``).

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
_DESCENT1_ARGS = [P] * 6 + [I] * 4 + [F] * 5 + [I, P]
_ASCENT1_ARGS = [P] * 7 + [I] * 4 + [F] * 5 + [I, P]


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

def _mv(diag_p, cx, cy, cz, shape, pinned):
    return lambda v: star7_mv_padded_torch(diag_p, cx, cy, cz, v, shape, pinned)


def fused7_mvdot_torch(diag_p, cx, cy, cz, x_p, shape, pinned: bool):
    y = star7_mv_padded_torch(diag_p, cx, cy, cz, x_p, shape, pinned)
    return y, _dot(x_p, y)


def fused7_descent_torch(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned: bool):
    mv = _mv(diag_p, cx, cy, cz, shape, pinned)
    dinv = 1.0 / diag_p
    u = (s0 * b_p) * dinv
    x1 = u + ad * u + g * (dinv * (b_p - mv(u)))
    r = b_p - mv(x1)
    s = r - gw * mv(dinv * r)
    return x1, s


def fused7_descent_rr_torch(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned: bool):
    x1, s = fused7_descent_torch(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned)
    return x1, s, _dot(b_p, b_p)


def fused7_ascent_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned: bool):
    mv = _mv(diag_p, cx, cy, cz, shape, pinned)
    dinv = 1.0 / diag_p
    x2 = x1_p + t_p - gw * (dinv * mv(t_p))
    d = g * (dinv * (b_p - mv(x2)))
    x3 = x2 + d
    return x3 + ad * d + g2 * (dinv * (b_p - mv(x3)))


def fused7_ascent_rz_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned: bool):
    x4 = fused7_ascent_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned)
    return x4, _dot(b_p, x4)


def fused7_descent1_torch(diag_p, cx, cy, cz, b_p, g, gw, shape, pinned: bool):
    mv = _mv(diag_p, cx, cy, cz, shape, pinned)
    dinv = 1.0 / diag_p
    x1 = g * (dinv * b_p)
    r = b_p - mv(x1)
    s = r - gw * mv(dinv * r)
    return x1, s


def fused7_descent1_rr_torch(diag_p, cx, cy, cz, b_p, g, gw, shape, pinned: bool):
    x1, s = fused7_descent1_torch(diag_p, cx, cy, cz, b_p, g, gw, shape, pinned)
    return x1, s, _dot(b_p, b_p)


def fused7_ascent1_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned: bool):
    mv = _mv(diag_p, cx, cy, cz, shape, pinned)
    dinv = 1.0 / diag_p
    x2 = x1_p + t_p - gw * (dinv * mv(t_p))
    return x2 + g * (dinv * (b_p - mv(x2)))


def fused7_ascent1_rz_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned: bool):
    x3 = fused7_ascent1_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned)
    return x3, _dot(b_p, x3)


# --- kernel launches -----------------------------------------------------------
# Each launcher takes its counter's name and ``dot``: with it the kernels
# write block partials and the launcher returns their sum last; without it
# the entry point gets a null partials pointer (the dot-free form).

def _launch_descent(name, dot, diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned):
    x1, r, s = (torch.empty_like(b_p) for _ in range(3))
    partials = _partials(shape, b_p.device) if dot else None
    _build.launch(
        "tps_descent", _DESCENT_ARGS, b_p.device,
        b_p.data_ptr(), diag_p.data_ptr(), x1.data_ptr(), r.data_ptr(),
        s.data_ptr(), partials.data_ptr() if dot else None,
        *launch_args(shape, cx, cy, cz),
        float(s0), float(ad), float(g), float(gw), int(pinned),
    )
    LAUNCHES[name] += 1
    return (x1, s, partials.sum()) if dot else (x1, s)


def _launch_ascent(name, dot, diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned):
    x2, d, x3, x4 = (torch.empty_like(t_p) for _ in range(4))
    partials = _partials(shape, t_p.device) if dot else None
    _build.launch(
        "tps_ascent", _ASCENT_ARGS, t_p.device,
        t_p.data_ptr(), b_p.data_ptr(), x1_p.data_ptr(), diag_p.data_ptr(),
        x2.data_ptr(), d.data_ptr(), x3.data_ptr(), x4.data_ptr(),
        partials.data_ptr() if dot else None, *launch_args(shape, cx, cy, cz),
        float(g), float(ad), float(g2), float(gw), int(pinned),
    )
    LAUNCHES[name] += 1
    return (x4, partials.sum()) if dot else x4


def _launch_descent1(name, dot, diag_p, cx, cy, cz, b_p, g, gw, shape, pinned):
    x1, r, s = (torch.empty_like(b_p) for _ in range(3))
    partials = _partials(shape, b_p.device) if dot else None
    _build.launch(
        "tps_descent1", _DESCENT1_ARGS, b_p.device,
        b_p.data_ptr(), diag_p.data_ptr(), x1.data_ptr(), r.data_ptr(),
        s.data_ptr(), partials.data_ptr() if dot else None,
        *launch_args(shape, cx, cy, cz), float(g), float(gw), int(pinned),
    )
    LAUNCHES[name] += 1
    return (x1, s, partials.sum()) if dot else (x1, s)


def _launch_ascent1(name, dot, diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned):
    x2, x3 = torch.empty_like(t_p), torch.empty_like(t_p)
    partials = _partials(shape, t_p.device) if dot else None
    _build.launch(
        "tps_ascent1", _ASCENT1_ARGS, t_p.device,
        t_p.data_ptr(), b_p.data_ptr(), x1_p.data_ptr(), diag_p.data_ptr(),
        x2.data_ptr(), x3.data_ptr(), partials.data_ptr() if dot else None,
        *launch_args(shape, cx, cy, cz), float(g), float(gw), int(pinned),
    )
    LAUNCHES[name] += 1
    return (x3, partials.sum()) if dot else x3


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
    """``(x1, s, <b, b>)``: the degree-2 downstroke (K3).  The kernel
    sequence keeps the residual r in scratch device memory."""
    shape = tuple(shape)
    check_fields(shape, diag_p, b_p)
    if b_p.device.type == "cpu":
        return fused7_descent_rr_torch(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned)
    return _launch_descent("fused7_descent_rr", True, diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned)


def fused7_descent(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned: bool):
    """``(x1, s)``: K3 without its dot (K3')."""
    shape = tuple(shape)
    check_fields(shape, diag_p, b_p)
    if b_p.device.type == "cpu":
        return fused7_descent_torch(diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned)
    return _launch_descent("fused7_descent", False, diag_p, cx, cy, cz, b_p, s0, ad, g, gw, shape, pinned)


def fused7_ascent_rz(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned: bool):
    """``(x4, <b, x4>)``: the degree-2 upstroke (K4).  The kernel sequence
    keeps x2, d and x3 in scratch device memory."""
    shape = tuple(shape)
    check_fields(shape, diag_p, t_p, b_p, x1_p)
    if t_p.device.type == "cpu":
        return fused7_ascent_rz_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned)
    return _launch_ascent("fused7_ascent_rz", True, diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned)


def fused7_ascent(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned: bool):
    """``x4``: K4 without its dot (K4')."""
    shape = tuple(shape)
    check_fields(shape, diag_p, t_p, b_p, x1_p)
    if t_p.device.type == "cpu":
        return fused7_ascent_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned)
    return _launch_ascent("fused7_ascent", False, diag_p, cx, cy, cz, t_p, b_p, x1_p, g, ad, g2, gw, shape, pinned)


def fused7_descent1_rr(diag_p, cx, cy, cz, b_p, g, gw, shape, pinned: bool):
    """``(x1, s, <b, b>)``: the degree-1 downstroke (K6).  The kernel
    sequence keeps the residual r in scratch device memory."""
    shape = tuple(shape)
    check_fields(shape, diag_p, b_p)
    if b_p.device.type == "cpu":
        return fused7_descent1_rr_torch(diag_p, cx, cy, cz, b_p, g, gw, shape, pinned)
    return _launch_descent1("fused7_descent1_rr", True, diag_p, cx, cy, cz, b_p, g, gw, shape, pinned)


def fused7_descent1(diag_p, cx, cy, cz, b_p, g, gw, shape, pinned: bool):
    """``(x1, s)``: K6 without its dot (K6')."""
    shape = tuple(shape)
    check_fields(shape, diag_p, b_p)
    if b_p.device.type == "cpu":
        return fused7_descent1_torch(diag_p, cx, cy, cz, b_p, g, gw, shape, pinned)
    return _launch_descent1("fused7_descent1", False, diag_p, cx, cy, cz, b_p, g, gw, shape, pinned)


def fused7_ascent1_rz(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned: bool):
    """``(x3, <b, x3>)``: the degree-1 upstroke (K7).  The kernel sequence
    keeps x2 in scratch device memory."""
    shape = tuple(shape)
    check_fields(shape, diag_p, t_p, b_p, x1_p)
    if t_p.device.type == "cpu":
        return fused7_ascent1_rz_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned)
    return _launch_ascent1("fused7_ascent1_rz", True, diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned)


def fused7_ascent1(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned: bool):
    """``x3``: K7 without its dot (K7')."""
    shape = tuple(shape)
    check_fields(shape, diag_p, t_p, b_p, x1_p)
    if t_p.device.type == "cpu":
        return fused7_ascent1_torch(diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned)
    return _launch_ascent1("fused7_ascent1", False, diag_p, cx, cy, cz, t_p, b_p, x1_p, g, gw, shape, pinned)

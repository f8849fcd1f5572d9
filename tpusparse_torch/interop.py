"""Carry operators and AMG hierarchies in from numpy arrays.

The parity tests pull the arrays out of the JAX package's objects with
``np.asarray`` and build the port's objects here, so both packages run the
same operator or the same hierarchy (isolating, say, the V-cycle from the
setup).  Every field is given in its TRUE (unpadded) shape; the padded
fine level is laid out here with the port's own ``padded_shape``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.amg.geo import GeoTransfer
from tpusparse_torch.amg.hierarchy import Hierarchy, Level
from tpusparse_torch.amg.transfer import StructuredTransfer
from tpusparse_torch.sparse.dia import DFDIA, DIA
from tpusparse_torch.sparse.padded import PaddedStar, PaddedTransfer, pad_field
from tpusparse_torch.sparse.stencil import StarStencil3D
from tpusparse_torch.sparse.varstencil import VarStencil27


def _put(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device)


def star_from_numpy(diag, cx, cy, cz, pinned, *, device) -> StarStencil3D:
    return StarStencil3D(
        diag=_put(diag, device), cx=float(cx), cy=float(cy), cz=float(cz),
        pinned=bool(pinned),
    )


def padded_star_from_numpy(diag, cx, cy, cz, pinned, *, device) -> PaddedStar:
    return PaddedStar.from_star(
        star_from_numpy(diag, cx, cy, cz, pinned, device=device)
    )


def dia_from_numpy(bands, offsets, shape, *, device) -> DIA:
    return DIA(
        bands=_put(bands, device), offsets=tuple(int(o) for o in offsets),
        shape=tuple(int(s) for s in shape),
    )


def dfdia_from_numpy(hi, lo, offsets, shape, *, device) -> DFDIA:
    """``lo`` None where the JAX container holds none (A exactly f32)."""
    return DFDIA(
        hi=_put(hi, device), lo=None if lo is None else _put(lo, device),
        offsets=tuple(int(o) for o in offsets), shape=tuple(int(s) for s in shape),
    )


def hierarchy_from_numpy(
    levels, *, damping, smoother, degree, cheby_lo, cheby_hi, device,
) -> Hierarchy:
    """A ``Hierarchy`` from per-level dicts.

    Each level: ``op`` — ``{"diag", "cx", "cy", "cz", "pinned"}`` for the
    (padded) fine star, ``{"coef"}`` for a 27-point level or ``{"bands",
    "offsets", "shape"}`` for a flat DIA level; ``dinv`` (true shape);
    ``rho``; ``transfer`` — ``None`` on the coarsest level, else ``{"omega",
    "tnorm", "sz", "sy", "sx", "fine_shape", "factor"}`` for a structured
    transfer or ``{"w", "omega", "sz", "sy", "sx", "fine_shape", "bs"}`` for
    a ``GeoTransfer``.
    """
    out = []
    for lv in levels:
        op_d = lv["op"]
        padded = "diag" in op_d
        if padded:
            op = padded_star_from_numpy(
                op_d["diag"], op_d["cx"], op_d["cy"], op_d["cz"],
                op_d["pinned"], device=device,
            )
            dinv = pad_field(_put(lv["dinv"], device), 1.0)
        elif "bands" in op_d:
            op = dia_from_numpy(op_d["bands"], op_d["offsets"], op_d["shape"], device=device)
            dinv = _put(lv["dinv"], device)
        else:
            op = VarStencil27(coef=_put(op_d["coef"], device))
            dinv = _put(lv["dinv"], device)
        tr = lv["transfer"]
        transfer = None
        if tr is not None and "bs" in tr:
            transfer = GeoTransfer(
                w=_put(tr["w"], device),
                omega=float(tr["omega"]),
                sz=_put(tr["sz"], device),
                sy=_put(tr["sy"], device),
                sx=_put(tr["sx"], device),
                fine_shape=tuple(int(n) for n in tr["fine_shape"]),
                bs=tuple(int(b) for b in tr["bs"]),
            )
        elif tr is not None:
            transfer = StructuredTransfer(
                omega=float(tr["omega"]),
                tnorm=_put(tr["tnorm"], device),
                sz=_put(tr["sz"], device),
                sy=_put(tr["sy"], device),
                sx=_put(tr["sx"], device),
                fine_shape=tuple(int(n) for n in tr["fine_shape"]),
                factor=tuple(int(f) for f in tr["factor"]),
            )
            if padded:
                transfer = PaddedTransfer(transfer)
        out.append(Level(op=op, dinv=dinv, rho=float(lv["rho"]), transfer=transfer))
    return Hierarchy(
        levels=out, damping=float(damping), smoother=smoother,
        degree=int(degree), cheby_lo=float(cheby_lo), cheby_hi=float(cheby_hi),
    )

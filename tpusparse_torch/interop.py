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

from tpusparse_torch.amg.hierarchy import Hierarchy, Level
from tpusparse_torch.amg.transfer import StructuredTransfer
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


def hierarchy_from_numpy(
    levels, *, damping, smoother, degree, cheby_lo, cheby_hi, device,
) -> Hierarchy:
    """A ``Hierarchy`` from per-level dicts.

    Each level: ``op`` — ``{"diag", "cx", "cy", "cz", "pinned"}`` for the
    (padded) fine star or ``{"coef"}`` for a 27-point level; ``dinv`` (true
    shape); ``rho``; ``transfer`` — ``None`` on the coarsest level, else
    ``{"omega", "tnorm", "sz", "sy", "sx", "fine_shape", "factor"}``.
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
        else:
            op = VarStencil27(coef=_put(op_d["coef"], device))
            dinv = _put(lv["dinv"], device)
        tr = lv["transfer"]
        transfer = None
        if tr is not None:
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

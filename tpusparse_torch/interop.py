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

import dataclasses

from tpusparse_torch.amg.deviceagg import SegTransfer
from tpusparse_torch.amg.geo import GeoTransfer
from tpusparse_torch.amg.hierarchy import Hierarchy, Level
from tpusparse_torch.amg.transfer import StructuredTransfer
from tpusparse_torch.amg.unstructured import ELLTransfer, FactoredTransfer, member_table
from tpusparse_torch.solve.bjacobi import BlockJacobi, PCRLineJacobi
from tpusparse_torch.sparse.csr import HostCSR
from tpusparse_torch.sparse.dia import DFDIA, DIA, HybridDIA
from tpusparse_torch.sparse.ell import ELL
from tpusparse_torch.sparse.griddia import GridDIA
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


def dfdia_from_numpy(hi, lo, offsets, shape, *, device, grid=None) -> DFDIA:
    """``lo`` None where the JAX container holds none (A exactly f32);
    ``grid`` its 3-D view ``(grid_shape, d3s)`` or None."""
    if grid is not None:
        grid = (tuple(int(s) for s in grid[0]), tuple(tuple(int(d) for d in d3) for d3 in grid[1]))
    return DFDIA(
        hi=_put(hi, device), lo=None if lo is None else _put(lo, device),
        offsets=tuple(int(o) for o in offsets), shape=tuple(int(s) for s in shape), grid=grid,
    )


def griddia_from_numpy(bands, offsets, d3s, grid_shape, *, device) -> GridDIA:
    """A ``GridDIA`` from the JAX container's bands and its 3-D view."""
    return GridDIA(
        bands=_put(bands, device), offsets=tuple(int(o) for o in offsets),
        d3s=tuple(tuple(int(d) for d in d3) for d3 in d3s), grid_shape=tuple(int(s) for s in grid_shape),
    )


def ell_from_numpy(cols, vals, shape, *, device) -> ELL:
    """An ELL from the JAX package's width-major (width, n_rows) arrays."""
    return ELL(
        cols=_put(np.asarray(cols, np.int64), device), vals=_put(vals, device),
        shape=tuple(int(s) for s in shape),
    )


def _general_op(d, device):
    """A flat level operator: ``{"bands", "offsets", "shape"}`` (DIA),
    ``{"bands", "offsets", "d3s", "grid_shape"}`` (GridDIA), ``{"cols",
    "vals", "shape"}`` (ELL) or ``{"dia", "rem"}`` (HybridDIA, ``rem`` an
    ELL dict or None)."""
    if "d3s" in d:
        return griddia_from_numpy(d["bands"], d["offsets"], d["d3s"], d["grid_shape"], device=device)
    if "dia" in d:
        return HybridDIA(
            dia=_general_op(d["dia"], device),
            rem=None if d["rem"] is None else _general_op(d["rem"], device),
        )
    if "cols" in d:
        return ell_from_numpy(d["cols"], d["vals"], d["shape"], device=device)
    return dia_from_numpy(d["bands"], d["offsets"], d["shape"], device=device)


def _general_transfer(tr, device):
    """``{"agg", "w", "omega", "n_coarse", "nsmooths"}`` (FactoredTransfer),
    ``{"s", "w", "omega", "n_fine", "n_coarse"}`` (SegTransfer) or ``{"p",
    "r"}`` ELL dicts (ELLTransfer)."""
    if "agg" in tr:
        agg = np.asarray(tr["agg"], np.int64)
        n_c = int(tr["n_coarse"])
        return FactoredTransfer(
            agg=_put(agg, device), w=_put(tr["w"], device), omega=float(tr["omega"]),
            members=_put(member_table(agg, n_c), device), n_coarse=n_c, nsmooths=int(tr["nsmooths"]),
        )
    if "s" in tr:
        return SegTransfer(
            w=float(tr["w"]), omega=float(tr["omega"]), s=int(tr["s"]), n_fine=int(tr["n_fine"]),
            n_coarse=int(tr["n_coarse"]),
        )
    return ELLTransfer(p=_general_op(tr["p"], device), r=_general_op(tr["r"], device))


def host_csr_from_numpy(indptr, indices, data, shape) -> HostCSR:
    """A HostCSR from the JAX package's (numpy) arrays, copied."""
    return HostCSR(
        indptr=np.array(indptr, dtype=np.int64), indices=np.array(indices, dtype=np.int32),
        data=np.array(data), shape=tuple(int(s) for s in shape),
    )


def block_jacobi_from_numpy(dinv_blocks, bs, n, *, device) -> BlockJacobi:
    """A dense block-Jacobi sub-PC from its inverted blocks (nb, bs, bs)."""
    return BlockJacobi(dinv_blocks=_put(dinv_blocks, device), bs=int(bs), n=int(n))


def _bjac_from_numpy(d, device):
    """A block-Jacobi sub-PC: ``{"dinv_blocks", "bs", "n"}`` (dense) or
    ``{"alphas", "gammas", "binv", "bs", "n", "shifts"}`` (PCR)."""
    if "dinv_blocks" in d:
        return block_jacobi_from_numpy(d["dinv_blocks"], d["bs"], d["n"], device=device)
    return PCRLineJacobi(
        alphas=tuple(_put(a, device) for a in d["alphas"]),
        gammas=tuple(_put(g, device) for g in d["gammas"]),
        binv=_put(d["binv"], device), bs=int(d["bs"]), n=int(d["n"]),
        shifts=tuple(int(k) for k in d["shifts"]),
    )


def hierarchy_from_numpy(
    levels, *, damping, smoother, degree, cheby_lo, cheby_hi, device, level_spec=(),
) -> Hierarchy:
    """A ``Hierarchy`` from per-level dicts.

    Each level: ``op`` — ``{"diag", "cx", "cy", "cz", "pinned"}`` for the
    fine star (padded unless ``"plain": True``), ``{"coef"}`` for a
    27-point level or a flat level (``_general_op``: DIA, ELL or
    HybridDIA); ``dinv`` (true shape); ``rho``; ``transfer`` — ``None`` on the
    coarsest level, else ``{"omega", "tnorm", "sz", "sy", "sx",
    "fine_shape", "factor"}`` (per-axis factors) for a structured transfer,
    with ``"fop"`` — ``{"cx", "cy", "cz"}`` (the filtered star's legs) or
    ``{"coef"}`` (masked 27-point coefficients) — under a threshold
    schedule, or ``{"w", "omega", "sz", "sy", "sx", "fine_shape", "bs"}``
    for a ``GeoTransfer``, or a transfer of the general route
    (``_general_transfer``).  Optional: ``coarse_inv`` (the dense LU coarse
    inverse) and ``bjac`` (``_bjac_from_numpy``).
    """
    out = []
    for lv in levels:
        op_d = lv["op"]
        padded = "diag" in op_d and not op_d.get("plain", False)
        if "diag" in op_d and not padded:
            op = star_from_numpy(
                op_d["diag"], op_d["cx"], op_d["cy"], op_d["cz"], op_d["pinned"], device=device,
            )
            dinv = _put(lv["dinv"], device)
        elif padded:
            op = padded_star_from_numpy(
                op_d["diag"], op_d["cx"], op_d["cy"], op_d["cz"],
                op_d["pinned"], device=device,
            )
            dinv = pad_field(_put(lv["dinv"], device), 1.0)
        elif "bands" in op_d or "cols" in op_d or "dia" in op_d:
            op = _general_op(op_d, device)
            dinv = _put(lv["dinv"], device)
        else:
            op = VarStencil27(coef=_put(op_d["coef"], device))
            dinv = _put(lv["dinv"], device)
        tr = lv["transfer"]
        transfer = None
        if tr is not None and ("agg" in tr or "s" in tr or "p" in tr):
            transfer = _general_transfer(tr, device)
        elif tr is not None and "bs" in tr:
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
            fop_d, fop = tr.get("fop"), None
            if fop_d is not None and "coef" in fop_d:
                fop = VarStencil27(coef=_put(fop_d["coef"], device))
            elif fop_d is not None:
                fop = dataclasses.replace(
                    op, cx=float(fop_d["cx"]), cy=float(fop_d["cy"]), cz=float(fop_d["cz"]),
                )
            transfer = StructuredTransfer(
                omega=float(tr["omega"]),
                tnorm=_put(tr["tnorm"], device),
                sz=_put(tr["sz"], device),
                sy=_put(tr["sy"], device),
                sx=_put(tr["sx"], device),
                fine_shape=tuple(int(n) for n in tr["fine_shape"]),
                factor=tuple(int(f) for f in tr["factor"]),
                fop=fop,
            )
            if padded:
                transfer = PaddedTransfer(transfer)
        out.append(Level(
            op=op, dinv=dinv, rho=float(lv["rho"]), transfer=transfer,
            bjac=None if lv.get("bjac") is None else _bjac_from_numpy(lv["bjac"], device),
            coarse_inv=None if lv.get("coarse_inv") is None else _put(lv["coarse_inv"], device),
        ))
    return Hierarchy(
        levels=out, damping=float(damping), smoother=smoother,
        degree=int(degree), cheby_lo=float(cheby_lo), cheby_hi=float(cheby_hi),
        level_spec=tuple(level_spec),
    )

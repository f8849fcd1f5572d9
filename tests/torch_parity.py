"""Shared helpers of the port's parity tests: a JAX package hierarchy as the
numpy level dicts of ``tpusparse_torch.interop.hierarchy_from_numpy``, so
that one hierarchy runs in both packages.  Not a test module."""

import numpy as np

from tpusparse.sparse.padded import PaddedStar as JPaddedStar
from tpusparse.sparse.padded import crop_field as j_crop_field
from tpusparse.sparse.stencil import StarStencil3D as JStarStencil3D
from tpusparse_torch.interop import hierarchy_from_numpy


def _bjac(b):
    if b is None:
        return None
    if hasattr(b, "dinv_blocks"):
        return {"dinv_blocks": np.asarray(b.dinv_blocks), "bs": b.bs, "n": b.n}
    return {
        "alphas": [np.asarray(a) for a in b.alphas], "gammas": [np.asarray(g) for g in b.gammas],
        "binv": np.asarray(b.binv), "bs": b.bs, "n": b.n, "shifts": b.shifts,
    }


def _star(op, crop):
    diag = np.asarray(j_crop_field(op.diag, op.true_shape)) if crop else np.asarray(op.diag)
    return {
        "diag": diag, "cx": np.asarray(op.cx), "cy": np.asarray(op.cy),
        "cz": np.asarray(op.cz), "pinned": op.pinned, "plain": not crop,
    }


def _general_op(op):
    """A JAX DIA, ELL or HybridDIA as interop's dict."""
    if hasattr(op, "rem"):
        return {"dia": _general_op(op.dia), "rem": None if op.rem is None else _general_op(op.rem)}
    if hasattr(op, "cols"):
        return {"cols": np.asarray(op.cols), "vals": np.asarray(op.vals), "shape": op.shape}
    return {"bands": np.asarray(op.bands), "offsets": op.offsets, "shape": op.shape}


def _general_transfer(tr):
    """A JAX FactoredTransfer, SegTransfer or ELLTransfer as interop's dict."""
    if hasattr(tr, "agg"):
        return {"agg": np.asarray(tr.agg), "w": np.asarray(tr.w), "omega": np.asarray(tr.omega),
                "n_coarse": tr.n_coarse, "nsmooths": tr.nsmooths}
    if hasattr(tr, "s"):
        return {"s": tr.s, "w": np.asarray(tr.w), "omega": np.asarray(tr.omega), "n_fine": tr.n_fine,
                "n_coarse": tr.n_coarse}
    return {"p": _general_op(tr.p), "r": _general_op(tr.r)}


def jax_levels(jh):
    """The JAX hierarchy ``jh`` (padded or plain fine star and 27-point
    coarse levels, or flat DIA/ELL/HybridDIA levels with geometric,
    factored, segment or ELL transfers; optional
    filtered operators, block-Jacobi sub-PCs and the dense coarse inverse)
    as numpy level dicts."""
    out = []
    for lev in jh.levels:
        padded = isinstance(lev.op, JPaddedStar)
        if padded or isinstance(lev.op, JStarStencil3D):
            op = _star(lev.op, crop=padded)
        elif hasattr(lev.op, "bands") or hasattr(lev.op, "cols") or hasattr(lev.op, "rem"):
            op = _general_op(lev.op)
        else:
            op = {"coef": np.asarray(lev.op.coef, dtype=np.float32)}
        dinv = np.asarray(j_crop_field(lev.dinv, lev.op.true_shape)) if padded else np.asarray(lev.dinv)
        inner = getattr(lev.transfer, "inner", lev.transfer)
        transfer = None
        if inner is not None and (hasattr(inner, "agg") or hasattr(inner, "s") or hasattr(inner, "p")):
            transfer = _general_transfer(inner)
        elif inner is not None and hasattr(inner, "w"):
            transfer = {
                "w": np.asarray(inner.w), "omega": np.asarray(inner.omega),
                "sz": np.asarray(inner.sz), "sy": np.asarray(inner.sy), "sx": np.asarray(inner.sx),
                "fine_shape": inner.fine_shape, "bs": inner.bs,
            }
        elif inner is not None:
            transfer = {
                "omega": np.asarray(inner.omega), "tnorm": np.asarray(inner.tnorm),
                "sz": np.asarray(inner.sz), "sy": np.asarray(inner.sy),
                "sx": np.asarray(inner.sx), "fine_shape": inner.fine_shape,
                "factor": inner.factor,
            }
            fop = inner.fop
            if fop is not None:
                transfer["fop"] = (
                    {"coef": np.asarray(fop.coef)} if hasattr(fop, "coef")
                    else {"cx": np.asarray(fop.cx), "cy": np.asarray(fop.cy), "cz": np.asarray(fop.cz)}
                )
        out.append({
            "op": op, "dinv": dinv, "rho": np.asarray(lev.rho), "transfer": transfer,
            "bjac": _bjac(lev.bjac),
            "coarse_inv": None if lev.coarse_inv is None else np.asarray(lev.coarse_inv),
        })
    return out


def port_copy(jh, device="cpu"):
    """The port's ``Hierarchy`` holding the JAX hierarchy's arrays."""
    return hierarchy_from_numpy(
        jax_levels(jh), damping=np.asarray(jh.damping), smoother=jh.smoother,
        degree=jh.degree, cheby_lo=jh.cheby_lo, cheby_hi=jh.cheby_hi,
        level_spec=jh.level_spec, device=device,
    )

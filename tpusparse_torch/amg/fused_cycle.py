"""V-cycle with a fused fine level — port of ``tpusparse/amg/fused_cycle.py``.

The fine level dominates a V-cycle's cost (27x the cells of level 1).  Its
whole downstroke (pre-smoothing, the residual and the P^T smoothing pass)
runs as one fused7 descent mode and its whole upstroke (P smoothing, the
correction and post-smoothing) as one ascent mode; the coarse levels
recurse through ``hierarchy.vcycle`` (``coarse_cycle``: twice for a
W-cycle, ``gamma`` 2):

- ``vcycle_fused_dots`` (CG) also returns ``||b||^2`` and ``<b, z>`` from
  the kernels: K3/K4 (``descent_rr``/``ascent_rz``) for a degree-2
  smoother, K6/K7 (``descent1_rr``/``ascent1_rz``) for degree 1, the
  reference config's Richardson(1);
- ``vcycle_fused`` (every other Krylov method) runs the same kernels
  without the dots: K3'/K4' or K6'/K7';
- ``vcycle_fused_rupdate`` (the full-fusion CG body) forms CG's residual
  update r' = r - alpha ap inside the downstroke, K9 (``descentu``), then
  runs the coarse cycle and K4.  A degree-1 smoother has no such kernel in
  either package: there it is a torch r-update plus ``vcycle_fused_dots``,
  and ``cg_fusion_supported`` is False.

Supported configuration: the padded-resident f32 fine level with a
point-Jacobi Chebyshev or Richardson smoother of degree 1 or 2, and a
P-smoothing operator that is the level's own or its threshold-filtered
star (``transfer.fop``, passed to the kernels as ``flegs``).  Anything else
raises here; the driver runs it on the unfused padded cycle
(``hierarchy.vcycle``, kernels K10-K16), as the JAX driver does.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.amg.hierarchy import Hierarchy, _cheb_scalars, coarse_cycle
from tpusparse_torch.kernels.fused7 import (
    fused7_ascent,
    fused7_ascent1,
    fused7_ascent1_rz,
    fused7_ascent_rz,
    fused7_descent,
    fused7_descent1,
    fused7_descent1_rr,
    fused7_descent_rr,
    fused7_descentu,
)
from tpusparse_torch.sparse.padded import PaddedStar, PaddedTransfer


def fused_fine_supported(hier: Hierarchy) -> bool:
    """True when the level-0 configuration maps onto the fused kernels:
    degree 2 onto K3/K4, degree 1 onto K6/K7."""
    lev = hier.levels[0]
    sm0, dg0 = hier.level_cfg(0)
    return (
        isinstance(lev.op, PaddedStar)
        and isinstance(lev.transfer, PaddedTransfer)
        and sm0 in ("chebyshev", "richardson")
        and dg0 in (1, 2)
        and lev.op.dtype == torch.float32
        and _flegs_ok(lev.transfer.inner.fop)
    )


def _flegs_ok(fop) -> bool:
    """A filtered P-smoothing operator rides the kernels as per-axis leg
    overrides when it is a star with scalar legs (``_filtered_op`` of the
    fine level), not a 27-point operator."""
    return fop is None or (hasattr(fop, "cx") and getattr(fop, "coef", None) is None)


def cg_fusion_supported(hier: Hierarchy) -> bool:
    """True when the full-fusion CG body can run: the fused fine level with
    a degree-2 smoother (``descentu`` has no degree-1 twin)."""
    return fused_fine_supported(hier) and hier.level_cfg(0)[1] == 2


def _fine_scalars(hier: Hierarchy, lev):
    """(s0, ad, g): the degree-2 recurrence of ``hierarchy._smooth`` as one
    fused step each for pre and post, in f32 as the JAX package computes it
    (``_cheb_scalars`` on the f32 fine level).  Degree 1 uses only the g
    slot (one sweep: Richardson's damping, or Chebyshev's 1/theta)."""
    smoother, degree = hier.level_cfg(0)
    if smoother == "richardson":
        w = float(np.float32(hier.damping))
        return w, 0.0, w
    s0, _theta, steps = _cheb_scalars(hier, lev, degree)
    return (s0, 0.0, s0) if degree == 1 else (s0, *steps[0])


def _modes(hier: Hierarchy, with_dots: bool):
    """The (downstroke, upstroke) kernel pair of the fine level's degree."""
    if hier.level_cfg(0)[1] == 2:
        return (fused7_descent_rr, fused7_ascent_rz) if with_dots else (fused7_descent, fused7_ascent)
    return (fused7_descent1_rr, fused7_ascent1_rz) if with_dots else (fused7_descent1, fused7_ascent1)


def _vcycle_fused(hier: Hierarchy, b_p: torch.Tensor, with_dots: bool, gamma: int):
    if not fused_fine_supported(hier):
        raise ValueError(
            "the fused V-cycle needs a padded f32 fine level with a degree-1"
            " or degree-2 chebyshev or richardson point-Jacobi smoother"
        )
    lev = hier.levels[0]
    op: PaddedStar = lev.op
    tr: PaddedTransfer = lev.transfer
    s0, ad, g = _fine_scalars(hier, lev)
    legs = (op.diag, op.cx, op.cy, op.cz)
    pin = (op.true_shape, op.pinned)
    down, up = _modes(hier, with_dots)
    # scalar slots as fused_cycle.py:281-319 assigns them: the degree-2
    # downstroke takes (s0, ad, g, gw) and its upstroke's g slot carries s0
    # (post-smooth step 1 is the 1/theta scale) and its g2 slot g; degree 1
    # takes only g (and gw) in both strokes (fused_cycle.py:315-317)
    slots = (s0, ad, g, tr.omega) if hier.level_cfg(0)[1] == 2 else (g, tr.omega)

    out = down(*legs, b_p, *slots, *pin, flegs=tr.flegs)          # (x1, s[, <b, b>])
    e = coarse_cycle(hier, tr.tT_apply_padded(out[1]), 1, gamma)
    z = up(*legs, tr.t_apply_padded(e), b_p, out[0], *slots, *pin, flegs=tr.flegs)
    if with_dots:
        z, rz = z
        return z, rz, out[2]
    return z


def vcycle_fused(hier: Hierarchy, b_p: torch.Tensor, gamma: int = 1) -> torch.Tensor:
    """One cycle (V, or W for ``gamma`` 2) from a zero guess with the fused
    fine level: the same contract as ``hierarchy.vcycle`` on a
    padded-resident fine level."""
    return _vcycle_fused(hier, b_p, with_dots=False, gamma=gamma)


def vcycle_fused_dots(hier: Hierarchy, b_p: torch.Tensor, gamma: int = 1):
    """``(z, rz, rr)`` where z = M^-1 b, rz = <b, z>, rr = <b, b>.

    The two dots come out of the fine-level kernels, so a CG iteration
    using this form pays no separate pass for its ||r|| and <r, z>
    reductions.
    """
    return _vcycle_fused(hier, b_p, with_dots=True, gamma=gamma)


def vcycle_fused_rupdate(hier: Hierarchy, r_p: torch.Tensor, ap_p: torch.Tensor, alpha, gamma: int = 1):
    """``(z, r_new, rz, rr)``: the CG iteration's bottom half with the
    residual update r_new = r - alpha ap fused into the downstroke (K9),
    then the coarse cycle and the upstroke with <r_new, z> (K4); rr is
    <r_new, r_new>.  A degree-1 smoother takes a torch r-update and
    ``vcycle_fused_dots`` (K6/K7), as the JAX package does."""
    if not cg_fusion_supported(hier):
        r_new = r_p - alpha * ap_p
        z, rz, rr = vcycle_fused_dots(hier, r_new, gamma)
        return z, r_new, rz, rr
    lev = hier.levels[0]
    op: PaddedStar = lev.op
    tr: PaddedTransfer = lev.transfer
    s0, ad, g = _fine_scalars(hier, lev)
    legs = (op.diag, op.cx, op.cy, op.cz)
    pin = (op.true_shape, op.pinned)
    x1, s, r_new, rr = fused7_descentu(*legs, r_p, ap_p, s0, ad, g, tr.omega, alpha, *pin, flegs=tr.flegs)
    e = coarse_cycle(hier, tr.tT_apply_padded(s), 1, gamma)
    z, rz = fused7_ascent_rz(*legs, tr.t_apply_padded(e), r_new, x1, s0, ad, g, tr.omega, *pin,
                             flegs=tr.flegs)
    return z, r_new, rz, rr

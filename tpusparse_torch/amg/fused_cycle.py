"""V-cycle with a fused fine level — port of the dot-fused path of
``tpusparse/amg/fused_cycle.py``.

The fine level dominates a V-cycle's cost (27x the cells of level 1).
``vcycle_fused_dots`` runs its whole downstroke as K3
(``fused7_descent_rr``: both pre-smoothing steps, the residual and the P^T
smoothing pass, plus ||b||^2) and its whole upstroke as K4
(``fused7_ascent_rz``: P smoothing, the correction and both post-smoothing
steps, plus <b, z>); the coarse levels recurse through ``hierarchy.vcycle``.

Supported configuration: the padded-resident f32 fine level with a
point-Jacobi Chebyshev or Richardson smoother of degree 2.  Anything else
raises — there is no silent fallback to the unfused cycle.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.amg.hierarchy import Hierarchy, vcycle
from tpusparse_torch.kernels.fused7 import fused7_ascent_rz, fused7_descent_rr
from tpusparse_torch.sparse.padded import PaddedStar, PaddedTransfer


def fused_fine_supported(hier: Hierarchy) -> bool:
    """True when the level-0 configuration maps onto K3/K4."""
    lev = hier.levels[0]
    sm0, dg0 = hier.level_cfg(0)
    return (
        isinstance(lev.op, PaddedStar)
        and isinstance(lev.transfer, PaddedTransfer)
        and sm0 in ("chebyshev", "richardson")
        and dg0 == 2
        and lev.op.dtype == torch.float32
    )


def _fine_scalars(hier: Hierarchy, lev):
    """(s0, ad, g): the degree-2 recurrence of ``hierarchy._smooth`` as one
    fused step each for pre and post, in f32 as the JAX package computes it."""
    f32 = np.float32
    smoother, _ = hier.level_cfg(0)
    if smoother == "richardson":
        w = f32(hier.damping)
        return float(w), 0.0, float(w)
    rho = f32(lev.rho)
    lo = hier.cheby_lo * rho
    hi = hier.cheby_hi * rho
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = theta / delta
    rho_c = 1.0 / sigma
    rho_new = 1.0 / (2.0 * sigma - rho_c)
    s0 = 1.0 / theta               # first-step scale (1/theta)
    ad = rho_new * rho_c           # d-recurrence coefficient
    g = 2.0 * rho_new / delta      # residual-term coefficient
    return float(s0), float(ad), float(g)


def vcycle_fused_dots(hier: Hierarchy, b_p: torch.Tensor):
    """``(z, rz, rr)`` where z = M^-1 b, rz = <b, z>, rr = <b, b>.

    The two dots come out of K3 and K4, so a CG iteration using this form
    pays no separate pass for its ||r|| and <r, z> reductions.
    """
    if not fused_fine_supported(hier):
        raise ValueError(
            "vcycle_fused_dots needs a padded f32 fine level with a degree-2"
            " chebyshev or richardson point-Jacobi smoother"
        )
    lev = hier.levels[0]
    op: PaddedStar = lev.op
    tr: PaddedTransfer = lev.transfer
    s0, ad, g = _fine_scalars(hier, lev)
    gw = tr.omega
    legs = (op.diag, op.cx, op.cy, op.cz)

    # scalar slots as fused_cycle.py:281-319 assigns them: the downstroke
    # takes (s0, ad, g, gw); the upstroke's g slot carries s0 (post-smooth
    # step 1 is the 1/theta scale) and its g2 slot carries g
    x1, s, rr = fused7_descent_rr(
        *legs, b_p, s0, ad, g, gw, op.true_shape, op.pinned,
    )
    e = vcycle(hier, tr.tT_apply_padded(s), level=1)
    t = tr.t_apply_padded(e)
    z, rz = fused7_ascent_rz(
        *legs, t, b_p, x1, s0, ad, g, gw, op.true_shape, op.pinned,
    )
    return z, rz, rr

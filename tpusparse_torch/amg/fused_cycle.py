"""V-cycle with a fused fine level — port of ``tpusparse/amg/fused_cycle.py``.

The fine level dominates a V-cycle's cost (27x the cells of level 1).  Its
whole downstroke (pre-smoothing, the residual and the P^T smoothing pass)
runs as one fused7 descent mode and its whole upstroke (P smoothing, the
correction and post-smoothing) as one ascent mode; the coarse levels
recurse through ``hierarchy.vcycle``:

- ``vcycle_fused_dots`` (CG) also returns ``||b||^2`` and ``<b, z>`` from
  the kernels: K3/K4 (``descent_rr``/``ascent_rz``) for a degree-2
  smoother, K6/K7 (``descent1_rr``/``ascent1_rz``) for degree 1, the
  reference config's Richardson(1);
- ``vcycle_fused`` (every other Krylov method) runs the same kernels
  without the dots: K3'/K4' or K6'/K7'.

Supported configuration: the padded-resident f32 fine level with a
point-Jacobi Chebyshev or Richardson smoother of degree 1 or 2.  Anything
else raises — there is no silent fallback to the unfused cycle.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.amg.hierarchy import Hierarchy, vcycle
from tpusparse_torch.kernels.fused7 import (
    fused7_ascent,
    fused7_ascent1,
    fused7_ascent1_rz,
    fused7_ascent_rz,
    fused7_descent,
    fused7_descent1,
    fused7_descent1_rr,
    fused7_descent_rr,
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
    )


def _fine_scalars(hier: Hierarchy, lev):
    """(s0, ad, g): the degree-2 recurrence of ``hierarchy._smooth`` as one
    fused step each for pre and post, in f32 as the JAX package computes it.
    Degree 1 uses only the g slot (one sweep: Richardson's damping, or
    Chebyshev's 1/theta)."""
    f32 = np.float32
    smoother, degree = hier.level_cfg(0)
    if smoother == "richardson":
        w = f32(hier.damping)
        return float(w), 0.0, float(w)
    rho = f32(lev.rho)
    if degree == 1:
        theta = 0.5 * (hier.cheby_hi * rho + hier.cheby_lo * rho)
        s0 = f32(1.0 / theta)
        return float(s0), 0.0, float(s0)
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


def _modes(hier: Hierarchy, with_dots: bool):
    """The (downstroke, upstroke) kernel pair of the fine level's degree."""
    if hier.level_cfg(0)[1] == 2:
        return (fused7_descent_rr, fused7_ascent_rz) if with_dots else (fused7_descent, fused7_ascent)
    return (fused7_descent1_rr, fused7_ascent1_rz) if with_dots else (fused7_descent1, fused7_ascent1)


def _vcycle_fused(hier: Hierarchy, b_p: torch.Tensor, with_dots: bool):
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

    out = down(*legs, b_p, *slots, *pin)          # (x1, s[, <b, b>])
    e = vcycle(hier, tr.tT_apply_padded(out[1]), level=1)
    z = up(*legs, tr.t_apply_padded(e), b_p, out[0], *slots, *pin)
    if with_dots:
        z, rz = z
        return z, rz, out[2]
    return z


def vcycle_fused(hier: Hierarchy, b_p: torch.Tensor) -> torch.Tensor:
    """One V-cycle from a zero guess with the fused fine level: the same
    contract as ``hierarchy.vcycle`` on a padded-resident fine level."""
    return _vcycle_fused(hier, b_p, with_dots=False)


def vcycle_fused_dots(hier: Hierarchy, b_p: torch.Tensor):
    """``(z, rz, rr)`` where z = M^-1 b, rz = <b, z>, rr = <b, b>.

    The two dots come out of the fine-level kernels, so a CG iteration
    using this form pays no separate pass for its ||r|| and <r, z>
    reductions.
    """
    return _vcycle_fused(hier, b_p, with_dots=True)

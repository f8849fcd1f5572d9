"""GAMG-style AMG hierarchy: setup + V-cycle apply — port of
``tpusparse/amg/hierarchy.py``.

Parity target (``configs/PETSc_SolverOptions_GAMG.info:6-21``): smoothed
aggregation, one prolongator-smoothing pass, threshold 0.0, a point-Jacobi
smoother (Chebyshev degree 2 by default, Richardson for parity runs) and a
preonly + Jacobi coarse solve.  The hierarchy is built eagerly, once per
matrix, on the operator's device; nothing leaves device memory except one
scalar per level (rho).

This slice covers the point-Jacobi / Jacobi-coarse / V-cycle configuration;
threshold schedules, block Jacobi, SOR and the dense LU coarse solve raise
``NotImplementedError``.

Scalars (rho, omega, the damping) are Python floats holding values of the
hierarchy's dtype; the smoother's Chebyshev coefficients are computed from
them in numpy scalars of that dtype, the arithmetic JAX does on 0-d arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusparse_torch.amg.galerkin import galerkin_coarse
from tpusparse_torch.amg.transfer import StructuredTransfer
from tpusparse_torch.solve.cg import _dot, np_float
from tpusparse_torch.sparse.padded import PaddedStar, PaddedTransfer, pad_field


@dataclasses.dataclass(frozen=True)
class AMGParams:
    """Setup knobs, named after their GAMG counterparts where they exist."""

    nsmooths: int = 1            # -pc_gamg_agg_nsmooths (0 or 1 here)
    threshold: float = 0.0       # -pc_gamg_threshold (0.0 = keep all, parity)
    coarse_eq_limit: int = 200   # stop coarsening below this many unknowns
    max_levels: int = 30
    factor: int = 3              # geometric aggregation block edge
    omega_scale: float = 4.0 / 3.0   # omega = omega_scale / rho(D^-1 A)
    rho_iters: int = 25          # power-iteration steps for rho(D^-1 A)
    rho_safety: float = 1.05     # inflate the estimate (underdamping is worse)
    smoother: str = "chebyshev"  # or "richardson" (reference-config parity)
    degree: int = 2              # chebyshev degree / richardson sweep count
    level_spec: tuple = ()       # ((level, smoother|"", degree|0), ...)
    smooth_damping: float = 1.0  # Richardson scale (PETSc default 1.0)
    cheby_lo: float = 0.1        # chebyshev target range [lo,hi]*rho(D^-1 A)
    cheby_hi: float = 1.05
    bjacobi_bs: int = 0          # block-Jacobi sub-PC (not in this slice)
    aggressive_coarsening: int = 1   # unstructured path only
    coarse_solve: str = "jacobi"     # "lu" is not in this slice


@dataclasses.dataclass
class Level:
    op: PaddedStar | object        # PaddedStar (level 0) or VarStencil27
    dinv: torch.Tensor             # 1 / diag, field view
    rho: float                     # rho(D^{-1} A) estimate
    transfer: object | None        # None on the coarsest level


@dataclasses.dataclass
class Hierarchy:
    levels: list[Level]
    damping: float               # Richardson smoother scale
    smoother: str = "chebyshev"
    degree: int = 2
    cheby_lo: float = 0.1
    cheby_hi: float = 1.05
    level_spec: tuple = ()       # per-level (level, smoother|"", degree|0)

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def level_cfg(self, level: int) -> tuple[str, int]:
        """(smoother, degree) effective at ``level``."""
        for lv, sm, dg in self.level_spec:
            if lv == level:
                return (sm or self.smoother, dg or self.degree)
        return self.smoother, self.degree


def estimate_rho_dinv_a(op, dinv, iters: int = 25, true_shape=None) -> torch.Tensor:
    """Power iteration for rho(D^{-1} A) (positive spectrum: A and D share
    sign), as a 0-d tensor.  Deterministic, non-smooth start vector.

    ``true_shape``: the unpadded field shape when ``op`` is padded-resident.
    The start vector is then built on the TRUE shape and zero-padded, so
    the padded estimate equals the plain-layout one.  This is load-bearing:
    a start vector that includes pad cells gives a ~1% different estimate,
    which made the 300^3 solve diverge on the TPU.
    """
    shape = tuple(dinv.shape)
    build_shape = tuple(true_shape) if true_shape is not None else shape
    n = int(np.prod(build_shape))
    # NB: sin's argument is rounded after the product and after the sum, as
    # the JAX code reads.  XLA fuses it into one multiply-add when it
    # compiles the estimate; at i ~ 1e4 that one ulp of the argument moves
    # sin by ~1e-3 and the 25-step estimate by ~1e-4.
    idx = torch.arange(n, dtype=torch.int64, device=dinv.device).to(dinv.dtype)
    v = torch.sin(idx * 0.7 + 0.3).reshape(build_shape)
    if true_shape is not None and shape != tuple(true_shape):
        v = pad_field(v)

    v = v / torch.sqrt(_dot(v, v))
    for _ in range(iters):
        w = dinv * op.mv(v)
        v = w / torch.sqrt(_dot(w, w))
    w = dinv * op.mv(v)
    return _dot(v, w)  # Rayleigh quotient (v normalized)


def gamg_setup(fine_op, params: AMGParams = AMGParams()) -> Hierarchy:
    """Build the AMG hierarchy from the fine operator (KSPSetUp parity)."""
    if params.nsmooths not in (0, 1):
        raise ValueError(
            "the structured path supports nsmooths in {0, 1}: a twice-"
            "smoothed prolongator reaches past the probed 27-point coarse "
            "container"
        )
    if params.smoother not in ("richardson", "chebyshev", "sor"):
        raise ValueError(f"unknown smoother {params.smoother!r}")
    if params.coarse_solve not in ("jacobi", "lu"):
        raise ValueError(f"unknown coarse_solve {params.coarse_solve!r}")
    for unported, name in (
        (params.threshold > 0.0, "threshold schedules (-pc_gamg_threshold > 0)"),
        (params.bjacobi_bs, "the block-Jacobi smoother (bjacobi_bs)"),
        (params.smoother == "sor", "the SOR smoother"),
        (params.coarse_solve == "lu", "the LU coarse solve"),
    ):
        if unported:
            raise NotImplementedError(f"{name} is not ported to tpusparse_torch yet")

    levels: list[Level] = []
    op = fine_op
    while True:
        dinv = 1.0 / op.diagonal_field()
        shape = op.grid_shape
        n = int(np.prod(shape))
        last = (
            n <= params.coarse_eq_limit
            or len(levels) + 1 >= params.max_levels
            or min(shape) < 2
        )
        true = getattr(op, "true_shape", None)
        padded = true is not None and tuple(true) != tuple(dinv.shape)
        rho_t = estimate_rho_dinv_a(
            op, dinv, params.rho_iters, true_shape=true if padded else None,
        ) * params.rho_safety
        rho = rho_t.item()
        if last:
            levels.append(Level(op=op, dinv=dinv, rho=rho, transfer=None))
            break
        f = np_float(dinv.dtype)
        omega = float(params.omega_scale / f(rho)) if params.nsmooths == 1 else 0.0
        transfer = StructuredTransfer.build(
            shape, omega, dinv.dtype, params.factor, device=dinv.device,
        )
        if isinstance(op, PaddedStar):
            transfer = PaddedTransfer(transfer)
        levels.append(Level(op=op, dinv=dinv, rho=rho, transfer=transfer))
        op = galerkin_coarse(op, dinv, transfer)
    dt = levels[0].dinv.dtype
    return Hierarchy(
        levels=levels,
        damping=float(np_float(dt)(params.smooth_damping)),
        smoother=params.smoother,
        degree=params.degree,
        cheby_lo=params.cheby_lo,
        cheby_hi=params.cheby_hi,
        level_spec=params.level_spec,
    )


def hierarchy_summary(hier: Hierarchy) -> str:
    """PETSc ``-ksp_view``-style description of the PC hierarchy (PCView:
    the MG level structure, smoother and coarse solve)."""
    lines = [
        f"PC Object: type gamg (smoothed aggregation), {hier.n_levels} levels",
        f"  cycle: V, smoother: {hier.smoother}"
        f" (degree {hier.degree}, damping {float(hier.damping):g})",
    ]
    for i, lev in enumerate(hier.levels):
        shape = getattr(lev.op, "grid_shape", None)
        n = int(np.prod(shape)) if shape is not None else lev.op.shape[0]
        extra = "" if lev.transfer is not None else ", coarse solve: preonly + jacobi"
        lines.append(
            f"  level {i}: {n} unknowns, operator {type(lev.op).__name__},"
            f" rho(M^-1 A) ~= {float(lev.rho):.4f}{extra}"
        )
    return "\n".join(lines)


def cast_coarse_coefs(hier: Hierarchy, dtype=torch.bfloat16) -> Hierarchy:
    """Cast ONLY the coarse-level coefficient stacks (levels >= 1).

    Vectors, diagonals and transfers keep the build dtype; only the
    operator data a 27-point level reads per apply shrinks.
    """
    new = [hier.levels[0]]
    for lev in hier.levels[1:]:
        op = lev.op
        if hasattr(op, "coef"):
            op = dataclasses.replace(op, coef=op.coef.to(dtype))
        new.append(dataclasses.replace(lev, op=op))
    return dataclasses.replace(hier, levels=new)


def _smooth(hier: Hierarchy, lev: Level, b, x, level: int = 0):
    """Apply the level smoother to A x = b starting from x (None = zero).

    richardson: x += damping * D^{-1} (b - A x), ``degree`` sweeps.
    chebyshev: degree-k Chebyshev polynomial in D^{-1} A targeting
    [cheby_lo, cheby_hi] * rho — PETSc KSPChebyshev, GAMG's default.
    """
    smoother, degree = hier.level_cfg(level)

    def pc(r):
        return lev.dinv * r

    if smoother == "richardson":
        for _ in range(degree):
            if x is None:
                x = hier.damping * pc(b)
            else:
                x = x + hier.damping * pc(b - lev.op.mv(x))
        return x

    # chebyshev
    rho = np_float(lev.dinv.dtype)(lev.rho)
    lo = hier.cheby_lo * rho
    hi = hier.cheby_hi * rho
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = theta / delta
    rho_c = 1.0 / sigma
    r = b if x is None else b - lev.op.mv(x)
    d = pc(r) / float(theta)
    x = d if x is None else x + d
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho_c)
        r = b - lev.op.mv(x)
        d = float(rho_new * rho_c) * d + float(2.0 * rho_new / delta) * pc(r)
        x = x + d
        rho_c = rho_new
    return x


def vcycle(hier: Hierarchy, b: torch.Tensor, level: int = 0) -> torch.Tensor:
    """One V-cycle solving A_l e = b from a zero initial guess.  Symmetric
    (the post-smoother is the adjoint of the pre-smoother), so a valid CG
    preconditioner.  Coarse solve: preonly + Jacobi."""
    lev = hier.levels[level]
    if lev.transfer is None:
        return lev.dinv * b
    x = _smooth(hier, lev, b, None, level=level)
    r = b - lev.op.mv(x)
    e_c = lev.transfer.restrict(lev.op, lev.dinv, r)
    e = vcycle(hier, e_c, level + 1)
    x = x + lev.transfer.prolong(lev.op, lev.dinv, e)
    return _smooth(hier, lev, b, x, level=level)

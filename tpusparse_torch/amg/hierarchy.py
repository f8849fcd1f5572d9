"""GAMG-style AMG hierarchy: setup + V-cycle apply — port of
``tpusparse/amg/hierarchy.py``.

Parity target (``configs/PETSc_SolverOptions_GAMG.info:6-21``): smoothed
aggregation, one prolongator-smoothing pass, threshold 0.0, a point-Jacobi
smoother (Chebyshev degree 2 by default, Richardson for parity runs) and a
preonly + Jacobi coarse solve.  The hierarchy is built eagerly, once per
matrix, on the operator's device; nothing leaves device memory except one
scalar per level (rho).

Beyond that configuration: W-cycles (``gamma``), ``-pc_gamg_threshold``
schedules with filtered P-smoothing operators, the multicolor SOR smoother,
block-Jacobi sub-PCs (``bjacobi_bs``, ``solve/bjacobi.py``) and the dense LU
coarse solve.  A padded fine level runs the unfused cycle on the single-step
kernels K10-K16 (``PaddedStar.{pre2, cheb0, cheb, rich, residual}``,
``PaddedTransfer.{restrict_steps, prolong_steps}``) wherever the fused fine
level (``fused_cycle.py``) does not apply.

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
from tpusparse_torch.solve.bjacobi import BlockJacobi
from tpusparse_torch.solve.cg import _dot, np_float
from tpusparse_torch.sparse.padded import PaddedStar, PaddedTransfer, crop_field, pad_field
from tpusparse_torch.sparse.varstencil import OFFSETS, VarStencil27


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
    bjacobi_bs: int = 0          # block-Jacobi sub-PC block size (0 = point)
    aggressive_coarsening: int = 1   # unstructured path only
    coarse_solve: str = "jacobi"     # or "lu" (-mg_coarse_pc_type lu)


def plain_cycle_only(params: AMGParams) -> bool:
    """The options the padded kernels cannot honour: the block-Jacobi
    sub-PC and the multicolor SOR smoother (the kernels smooth with point
    Jacobi only), and the dense LU coarse solve (the JAX package's padded
    hierarchy keeps pad columns at every level).  They run the plain cycle
    (the JAX driver's ``_plain_cycle_only``, ``driver.py:270-284``)."""
    return bool(params.bjacobi_bs or params.smoother == "sor" or params.coarse_solve == "lu")


@dataclasses.dataclass
class Level:
    op: PaddedStar | object        # PaddedStar (level 0) or VarStencil27
    dinv: torch.Tensor             # 1 / diag, field view
    rho: float                     # rho(M^{-1} A) estimate
    transfer: object | None        # None on the coarsest level
    bjac: object | None = None     # BlockJacobi sub-PC (None = point Jacobi)
    coarse_inv: torch.Tensor | None = None  # dense coarsest inverse (lu)


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


def estimate_rho_dinv_a(op, dinv, iters: int = 25, true_shape=None, m_pc=None) -> torch.Tensor:
    """Power iteration for rho(D^{-1} A) (positive spectrum: A and D share
    sign), as a 0-d tensor.  Deterministic, non-smooth start vector.

    ``true_shape``: the unpadded field shape when ``op`` is padded-resident.
    The start vector is then built on the TRUE shape and zero-padded, so
    the padded estimate equals the plain-layout one.  This is load-bearing:
    a start vector that includes pad cells gives a ~1% different estimate,
    which made the 300^3 solve diverge on the TPU.

    ``m_pc``: a preconditioner with ``.apply`` in place of D^{-1} (a
    block-Jacobi sub-PC): the estimate is then rho(M^{-1} A), the spectrum
    the Chebyshev smoother sees.
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

    def pc(w):
        return dinv * w if m_pc is None else m_pc.apply(w)

    v = v / torch.sqrt(_dot(v, v))
    for _ in range(iters):
        w = pc(op.mv(v))
        v = w / torch.sqrt(_dot(w, w))
    w = pc(op.mv(v))
    return _dot(v, w)  # Rayleigh quotient (v normalized)


# dense coarse inverse guard: 4096 unknowns = 128 MB f64 for eye + inverse,
# generous for any real coarsest level (coarse_eq_limit defaults to 200)
DENSE_COARSE_CAP = 4096


def dense_coarse_inverse(op) -> torch.Tensor:
    """The ``-mg_coarse_pc_type lu`` coarse solve: materialize a small
    operator densely (one apply per identity column) and invert it once,
    in float64 (an f32 inverse of the conditioned coarsest Galerkin
    operator can emit inf/NaN, as it did on the TPU at 300^3), returned in
    the operator's dtype.  Identically zero rows become identity rows.
    """
    gs = getattr(op, "grid_shape", None)
    n = int(np.prod(gs)) if gs is not None else op.shape[0]
    if n > DENSE_COARSE_CAP:
        # the coarsest level is not always <= coarse_eq_limit: max_levels
        # and stalled coarsening can leave a large one, whose dense inverse
        # would take tens of GB
        raise ValueError(
            f"coarse_solve='lu': coarsest level has {n} unknowns"
            f" (> {DENSE_COARSE_CAP} dense-inverse cap) — the hierarchy"
            " stopped early (max_levels / stalled coarsening); use the"
            " jacobi coarse solve or let coarsening continue"
        )
    d = op.diagonal_field() if gs is not None else op.diagonal()
    eye = torch.eye(n, dtype=d.dtype, device=d.device)
    cols = torch.stack([
        op.mv(e.reshape(gs) if gs is not None else e).reshape(-1) for e in eye
    ])
    dense = cols.T  # row i of ``cols`` is A @ e_i
    zero_row = dense.abs().sum(dim=1) == 0
    dense = dense + torch.diag(zero_row.to(dense.dtype))
    return torch.linalg.inv(dense.double()).to(dense.dtype)


def _coarse_direct(lev: Level, b: torch.Tensor) -> torch.Tensor:
    """Apply the dense coarse inverse to a field or flat vector, or to a
    stack of k of them as one product inv @ B.T."""
    inv = lev.coarse_inv
    n = inv.shape[0]
    if b.numel() == n:
        x = inv @ b.reshape(-1).to(inv.dtype)
    else:
        x = (inv @ b.reshape(-1, n).T.to(inv.dtype)).T
    return x.to(b.dtype).reshape(b.shape)


def axis_strengths(op) -> tuple[float, float, float]:
    """Coupling strengths per grid axis, (z, y, x): the mean |leg| over the
    mean |diagonal|, boundary rows included, in float64 on the host.  A
    padded operator is measured on its domain (its pads are not rows).
    ``threshold_schedule`` reads them."""
    diag = op.diagonal_field()
    if isinstance(op, PaddedStar):
        diag = crop_field(diag, op.true_shape)
    dmean = diag.double().abs().mean().item()
    if isinstance(op, VarStencil27):
        def leg(off):
            return op.coef[OFFSETS.index(off)].double().abs().mean().item()

        legs = (
            0.5 * (leg((1, 0, 0)) + leg((-1, 0, 0))),
            0.5 * (leg((0, 1, 0)) + leg((0, -1, 0))),
            0.5 * (leg((0, 0, 1)) + leg((0, 0, -1))),
        )
    else:  # StarStencil3D / PaddedStar: constant per-axis legs
        legs = (abs(float(op.cz)), abs(float(op.cy)), abs(float(op.cx)))
    return tuple(v / dmean for v in legs)


def threshold_schedule(fine_op, threshold: float, factor: int = 3, max_levels: int = 30):
    """Per-level per-axis coarsening factors under ``-pc_gamg_threshold``
    (configs/PETSc_SolverOptions_GAMG.info:8), or None when no axis is
    ever dropped (the threshold-0 hierarchy).

    GAMG drops couplings with |a_ij| <= theta sqrt(a_ii a_jj) from the
    strength graph, so anisotropic operators semicoarsen along their strong
    axes.  The structured form measures the fine level's per-axis strengths
    once and advances them analytically: coarsening an axis by ``factor``
    scales its coupling by 1/factor^2 against the uncoarsened axes.
    """
    if threshold <= 0.0:
        return None
    # per-axis leg magnitudes (a common scale cancels); the drop test
    # compares leg/diag with theta, and diag = 2 * sum(legs) for the
    # zero-row-sum operators this path serves
    legs = list(axis_strengths(fine_op))
    sched: list[tuple[int, int, int]] = []
    dropped_any = False
    for _ in range(max_levels):
        diag = 2.0 * sum(legs)
        keep = [v / diag > threshold for v in legs]
        if not any(keep):
            keep = [v == max(legs) for v in legs]
        f = tuple(int(factor) if k else 1 for k in keep)
        sched.append(f)
        dropped_any |= not all(keep)
        if all(keep):
            break  # isotropic from here on: the schedule's tail repeats
        legs = [v / (factor * factor) if k else v for v, k in zip(legs, keep)]
    return tuple(sched) if dropped_any else None


def _filtered_op(op, factors):
    """The P-smoothing operator with the legs of the uncoarsened axes
    (factor 1) dropped, or None when every axis coarsens.  It keeps A_c
    inside the 27-point container: live smoothing legs along an
    uncoarsened axis would give the Galerkin product radius 3 there."""
    drop = [f == 1 for f in factors]
    if not any(drop):
        return None
    if isinstance(op, VarStencil27):
        mask = torch.tensor(
            [0.0 if any(d and o != 0 for d, o in zip(drop, off)) else 1.0 for off in OFFSETS],
            dtype=op.coef.dtype, device=op.coef.device,
        )
        return VarStencil27(coef=op.coef * mask[:, None, None, None])
    # StarStencil3D / PaddedStar: constant per-axis legs
    return dataclasses.replace(op, **{name: 0.0 for name, d in zip(("cz", "cy", "cx"), drop) if d})


def _bjac(op, params: AMGParams, fine_nx: int):
    """The level's block-Jacobi sub-PC, or None for point Jacobi.  Each
    bs x bs natural-ordering diagonal block is assembled exactly from the
    stencil legs inside it.  With bs equal to the fine grid's nx it is
    x-line relaxation: each level smooths its own x-lines (bs = this
    level's nx), and only the +-1 offsets couple within a line, so the
    blocks are tridiagonal at any size (``PCRLineJacobi`` past the cap)."""
    if not params.bjacobi_bs:
        return None
    bs = params.bjacobi_bs
    if bs == fine_nx:
        bs = op.grid_shape[2]
        bands = {o: f for o, f in op.flat_band_fields(bs).items() if abs(o) == 1}
    else:
        bands = op.flat_band_fields(bs)
    return BlockJacobi.from_bands(op.diagonal_field(), bands, bs)


def gamg_setup(fine_op, params: AMGParams = AMGParams(), factors_schedule=None) -> Hierarchy:
    """Build the AMG hierarchy from the fine operator (KSPSetUp parity).

    ``factors_schedule``: per-level per-axis coarsening factors from
    ``threshold_schedule`` (None: ``params.factor`` on every axis); each
    level coarsened with a factor 1 smooths P with ``_filtered_op``.
    """
    if params.nsmooths not in (0, 1):
        raise ValueError(
            "the structured path supports nsmooths in {0, 1}: a twice-"
            "smoothed prolongator reaches past the probed 27-point coarse "
            "container"
        )
    if params.smoother not in ("richardson", "chebyshev", "sor"):
        raise ValueError(f"unknown smoother {params.smoother!r}")
    if params.smoother == "sor":
        if not hasattr(fine_op, "gs_color_masks"):
            raise ValueError(
                f"smoother='sor' needs a colorable grid operator (gs_color_masks);"
                f" {type(fine_op).__name__} has none — use chebyshev/richardson or"
                " the plain layout"
            )
        if params.bjacobi_bs:
            raise ValueError(
                "smoother='sor' IS the sub-PC (GS sweeps); it composes with point"
                " relaxation only — drop bjacobi_bs"
            )
    if params.bjacobi_bs and not hasattr(fine_op, "flat_band_fields"):
        raise ValueError(
            f"bjacobi_bs: operator {type(fine_op).__name__} exposes no band"
            " accessor — use layout='plain' (the padded kernels are"
            " point-Jacobi only)"
        )
    if params.coarse_solve not in ("jacobi", "lu"):
        raise ValueError(f"unknown coarse_solve {params.coarse_solve!r}")
    coarse_lu = params.coarse_solve == "lu"
    if coarse_lu and isinstance(fine_op, PaddedStar):
        # the padded coarsest level keeps its pad columns: like sor and
        # bjacobi_bs, lu runs on the plain layout only
        raise ValueError(
            "coarse_solve='lu' is not supported on the padded layout — use"
            " layout='plain'"
        )

    fine_nx = fine_op.grid_shape[2]
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
        bjac = _bjac(op, params, fine_nx)
        rho_lev = rho
        if bjac is not None and not last:
            # the Chebyshev bounds need the spectrum the smoother sees,
            # rho(M_block^-1 A); omega stays D^-1-based (P is smoothed with
            # point Jacobi whatever the level smoother's sub-PC)
            rho_lev = (estimate_rho_dinv_a(
                op, dinv, params.rho_iters, true_shape=true if padded else None, m_pc=bjac,
            ) * params.rho_safety).item()
        if last:
            levels.append(Level(
                op=op, dinv=dinv, rho=rho_lev, transfer=None, bjac=bjac,
                coarse_inv=dense_coarse_inverse(op) if coarse_lu else None,
            ))
            break
        f = np_float(dinv.dtype)
        omega = float(params.omega_scale / f(rho)) if params.nsmooths == 1 else 0.0
        f_lvl, fop = params.factor, None
        if factors_schedule is not None:
            f_lvl = factors_schedule[min(len(levels), len(factors_schedule) - 1)]
            fop = _filtered_op(op, f_lvl)
        transfer = StructuredTransfer.build(
            shape, omega, dinv.dtype, f_lvl, device=dinv.device, fop=fop,
        )
        if isinstance(op, PaddedStar):
            transfer = PaddedTransfer(transfer)
        levels.append(Level(op=op, dinv=dinv, rho=rho_lev, transfer=transfer, bjac=bjac))
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


def hierarchy_summary(hier: Hierarchy, gamma: int = 1) -> str:
    """PETSc ``-ksp_view``-style description of the PC hierarchy (PCView:
    the MG cycle, level structure, smoother and coarse solve)."""
    lines = [
        f"PC Object: type gamg (smoothed aggregation), {hier.n_levels} levels",
        f"  cycle: {'V' if gamma == 1 else 'W'}, smoother: {hier.smoother}"
        f" (degree {hier.degree}, damping {float(hier.damping):g})",
    ]
    for i, lev in enumerate(hier.levels):
        shape = getattr(lev.op, "grid_shape", None)
        n = int(np.prod(shape)) if shape is not None else lev.op.shape[0]
        extra = ""
        if lev.transfer is not None:
            inner = getattr(lev.transfer, "inner", lev.transfer)
            factor = getattr(inner, "factor", None)
            if factor is not None and len(set(factor)) > 1:
                extra = f", coarsening {tuple(factor)}"
            if getattr(inner, "fop", None) is not None:
                extra += " (filtered P smoother)"
        else:
            extra = ", coarse solve: preonly + " + (
                "lu (dense direct)" if lev.coarse_inv is not None
                else "bjacobi" if lev.bjac is not None else "jacobi"
            )
        if lev.bjac is not None and lev.transfer is not None:
            extra += f", sub-PC bjacobi (bs {lev.bjac.bs})"
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


# the Python float fields of a hierarchy that hold data of its dtype (the
# JAX package's 0-d array leaves): ``cast_hierarchy`` rounds them too
_DATA_SCALARS = ("rho", "damping", "cx", "cy", "cz", "omega")


def cast_hierarchy(hier: Hierarchy, dtype: torch.dtype) -> Hierarchy:
    """Cast every float field of the hierarchy to ``dtype`` — port of
    ``tpusparse/amg/hierarchy.py::cast_hierarchy``, JAX's tree map over the
    float leaves: every float tensor, and the Python float scalars that are
    data there (``_DATA_SCALARS``) rounded to ``dtype``'s values.

    The V-cycle is an approximate inverse, so a bf16 hierarchy trades
    mantissa for half the bytes the preconditioner moves.  The driver casts
    after the build (``pc_dtype="bf16"`` off the padded route), so setup
    stays in the build dtype.
    """
    def cast(v, name=None):
        if isinstance(v, torch.Tensor):
            return v.to(dtype) if v.is_floating_point() else v
        if isinstance(v, float) and name in _DATA_SCALARS:
            return torch.tensor(v, dtype=torch.float64).to(dtype).item()
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return dataclasses.replace(v, **{
                f.name: cast(getattr(v, f.name), f.name) for f in dataclasses.fields(v) if f.init
            })
        if isinstance(v, (list, tuple)):
            return type(v)(cast(e) for e in v)
        return v

    return cast(hier)


def _scalar_type(dtype: torch.dtype):
    """The numpy scalar type the smoother's scalars are computed in: the
    level's own (``np_float``), f32 for a bf16 level (numpy has no bf16;
    XLA computes a bf16 scalar chain in f32 and rounds where it meets the
    fields)."""
    return np.float32 if dtype == torch.bfloat16 else np_float(dtype)


def _cheb_scalars(hier: Hierarchy, lev: Level, degree: int):
    """(1/theta, theta, [(ad, g) of steps 2..degree]): the Chebyshev
    recurrence's scalars as ``_smooth`` computes them, in numpy scalars of
    the level's dtype (``_scalar_type``)."""
    rho = _scalar_type(lev.dinv.dtype)(lev.rho)
    lo = hier.cheby_lo * rho
    hi = hier.cheby_hi * rho
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = theta / delta
    rho_c = 1.0 / sigma
    steps = []
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho_c)
        steps.append((float(rho_new * rho_c), float(2.0 * rho_new / delta)))
        rho_c = rho_new
    return float(1.0 / theta), float(theta), steps


def _smooth_padded(hier: Hierarchy, lev: Level, b, x, level: int):
    """``_smooth`` on a padded level, step by step on K11-K14: Chebyshev
    from zero is ``pre2`` then (k-2) ``cheb``, from x ``cheb0`` then (k-1)
    ``cheb``; Richardson from zero is w D^-1 b then (k-1) ``rich``, from x
    k ``rich``.  Each step takes its own recurrence scalars."""
    op: PaddedStar = lev.op
    smoother, degree = hier.level_cfg(level)
    if smoother == "richardson":
        for _ in range(degree):
            if x is None:
                x = hier.damping * (lev.dinv * b)
            else:
                x = op.rich(x, b, hier.damping)
        return x
    s0, theta, steps = _cheb_scalars(hier, lev, degree)
    if x is None:
        if degree == 1:
            return (lev.dinv * b) / theta
        x, d = op.pre2(b, s0, *steps[0])
        steps = steps[1:]
    else:
        x, d = op.cheb0(x, b, s0)
    for ad, g in steps:
        x, d = op.cheb(x, b, d, ad, g)
    return x


def _smooth(hier: Hierarchy, lev: Level, b, x, reverse: bool = False, level: int = 0):
    """Apply the level smoother to A x = b starting from x (None = zero).

    richardson: x += damping * M^{-1} (b - A x), ``degree`` sweeps.
    chebyshev: degree-k Chebyshev polynomial in M^{-1} A targeting
    [cheby_lo, cheby_hi] * rho — PETSc KSPChebyshev, GAMG's default.
    M^{-1} is point Jacobi or the level's block-Jacobi sub-PC.
    sor: multicolor Gauss-Seidel sweeps (PCSOR in its parallel form): no
    two points of one color couple (``gs_color_masks``), so a masked
    simultaneous update is a GS ordering; ``reverse`` runs the colors
    backwards, the post-smoother's order, so that pre and post are
    transposes (SSOR pairing) and the cycle stays symmetric.
    """
    if isinstance(lev.op, PaddedStar):
        return _smooth_padded(hier, lev, b, x, level)
    smoother, degree = hier.level_cfg(level)
    if smoother == "sor":
        masks = lev.op.gs_color_masks()
        if reverse:
            masks = masks[::-1]
        omega = hier.damping
        for _ in range(degree):
            for m in masks:
                if x is None:
                    x = torch.where(m, omega * lev.dinv * b, torch.zeros_like(b))
                else:
                    x = torch.where(m, x + omega * lev.dinv * (b - lev.op.mv(x)), x)
        return x

    def pc(r):
        return lev.bjac.apply(r) if lev.bjac is not None else lev.dinv * r

    if smoother == "richardson":
        for _ in range(degree):
            if x is None:
                x = hier.damping * pc(b)
            else:
                x = x + hier.damping * pc(b - lev.op.mv(x))
        return x

    # chebyshev
    _s0, theta, steps = _cheb_scalars(hier, lev, degree)
    r = b if x is None else b - lev.op.mv(x)
    d = pc(r) / theta
    x = d if x is None else x + d
    for ad, g in steps:
        r = b - lev.op.mv(x)
        d = ad * d + g * pc(r)
        x = x + d
    return x


def vcycle(hier: Hierarchy, b: torch.Tensor, level: int = 0, gamma: int = 1) -> torch.Tensor:
    """One multigrid cycle solving A_l e = b from a zero initial guess.

    ``gamma`` is the cycle index (``-pc_mg_cycle_type``): 1 a V-cycle, 2 a
    W-cycle, which re-enters the coarse hierarchy on the updated coarse
    residual.  On plain levels ``b`` may be a stack of k fields (leading
    axis), each cycled as the single-field cycle would: the block apply of
    ``KSP.mat_solve``; a padded level takes one field.  Symmetric — the
    post-smoother is the adjoint of the pre-smoother — so a valid CG
    preconditioner.  Coarse solve: preonly +
    Jacobi, the block-Jacobi sub-PC, or the dense LU.  A padded level runs
    the unfused cycle on K10-K16 (``_smooth_padded``, ``PaddedStar.residual``,
    ``PaddedTransfer.{restrict_steps, prolong_steps}``).
    """
    lev = hier.levels[level]
    if lev.transfer is None:
        if lev.coarse_inv is not None:
            return _coarse_direct(lev, b)
        if lev.bjac is not None:
            return lev.bjac.apply(b)
        return lev.dinv * b
    padded = isinstance(lev.op, PaddedStar)
    x = _smooth(hier, lev, b, None, level=level)
    if padded:
        e_c = lev.transfer.restrict_steps(lev.op, lev.op.residual(x, b))
    else:
        e_c = lev.transfer.restrict(lev.op, lev.dinv, b - lev.op.mv(x))
    e = coarse_cycle(hier, e_c, level + 1, gamma)
    if padded:
        x = x + lev.transfer.prolong_steps(lev.op, e)
    else:
        x = x + lev.transfer.prolong(lev.op, lev.dinv, e)
    return _smooth(hier, lev, b, x, reverse=True, level=level)


def coarse_cycle(hier: Hierarchy, r_c: torch.Tensor, level: int, gamma: int = 1) -> torch.Tensor:
    """The coarse correction of a cycle entering ``level``: one cycle, and
    for a W-cycle (gamma 2) a second one on the updated coarse residual."""
    e = vcycle(hier, r_c, level, gamma)
    for _ in range(gamma - 1):
        e = e + vcycle(hier, r_c - hier.levels[level].op.mv(e), level, gamma)
    return e

"""The solve driver — port of the mixed-precision GAMG branches of
``tpusparse/bench/driver.py``.

Reproduces the protocol of the reference's ``src/main_ksp.cpp``: build
the manufactured Poisson system, set up the Krylov solver + AMG, solve, fail
on divergence, compute the Linf error against the analytic solution, and
report the phase triple ``[init, create solver, solve]`` in the reference's
text format (``src/main_ksp.cpp:124-129``) plus a JSON sidecar.

Every solve is a Krylov method (``-ksp_type``, ``_pick_ksp``)
preconditioned by a GAMG V- or W-cycle (``mg_cycle``), point Jacobi, SSOR
or nothing (``pc``), on one device, with a convergence check every
iteration.  Under mixed precision (the default) the Krylov method runs in
f32 under f64 defect correction.  The routes:

- ``mat_type="stencil"``, ``layout="padded"``: the 7-point stencil operator
  on the padded-resident layout.  With GAMG and a fine smoother the fused
  kernels take (``fused_fine_supported``), the fused fine level: CG takes
  the dot-fused cycle (``vcycle_fused_dots``) and the fused ``<p, Ap>``
  (``PaddedStar.mv_dot``); every other method the dot-free
  ``vcycle_fused`` (the JAX driver's ``:627-642``, ``:704-709``).  Kernels
  K1-K4 for a degree-2 smoother, K6/K7 (or K6'/K7') for the reference
  config's Richardson(1), with the threshold schedule's filtered legs
  where it has some.  Any other smoother degree runs the unfused padded
  cycle, ``hierarchy.vcycle`` on kernels K10-K16, as the JAX driver does
  where its preflight declines.  ``cg_fusion=True`` swaps CG's body for the
  full-fusion one (``PaddedStar.cgmv`` + ``vcycle_fused_rupdate``: K8, K9
  and K4), the JAX driver's ``TPUSPARSE_CG_FUSION``.  ``pc="jacobi"`` and
  ``"none"`` run here too (CG's ``<p, Ap>`` still on K2).
- ``mat_type="stencil"``, ``layout="plain"``: the f32 ``StarStencil3D`` on
  plain ``(nz, ny, nx)`` fields and the plain ``hierarchy.vcycle``, whose
  level-0 applies are kernel K1p (``star7_mv``); the coarse coefficients
  stay f32 (the JAX plain route casts them only for ``pc_dtype="bf16"``).
  The options the padded kernels cannot honour (``plain_cycle_only``: the
  SOR smoother, block Jacobi, the LU coarse solve, and ``pc="sor"``) take
  this route under ``layout="auto"``.
- ``precision="f64"`` or ``"f32"``: no defect correction.  The Krylov
  method runs on the plain operator in that dtype, preconditioned by the
  plain V-cycle of a hierarchy built in the same dtype (the JAX driver's
  ``:756-764``); in f32 its level-0 applies are K1p, in f64 plain torch.
- ``n_devices=p`` > 1: the z-sharded route (the JAX driver's ``fused_sh``,
  ``:396-431``, ``:766-825``): the f32 ``StarStencil3D`` and the plain
  hierarchy, preconditioned by ``vcycle_fused_sharded``, whose fine level
  runs once per z-shard (kernels K3z/K4z, ``dist/fused_sharded.py``), and
  CG's ``Ap`` on K1p.  The p shards live on ONE device; several devices are
  ROADMAP queue 12, and so is every other ``n_devices > 1`` route.
- ``mat_type="aij"``: the system as a 7-band DIA (f32 ``DIA`` for the
  inner solves, two-float ``DFDIA`` for the outer residual; one ``DIA`` in
  the solve's dtype under uniform precision).  With GAMG and
  ``structure_detect`` (the JAX default, ``_solve_poisson_aij``'s
  ``:1062-1150``) ``sparse/starlift.py`` proves it a constant-coefficient
  star and the solve moves onto the stencil routes above (K1-K4 under mixed
  precision).  Otherwise it is the structure-blind route: the
  device-resident geometric GAMG (``amg/geo.py``) and the plain V-cycle
  over flat DIA levels, every f32 level apply kernel K5; ``pc`` is gamg,
  jacobi or none there, mixed precision only.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
import warnings

import numpy as np
import torch

from tpusparse_torch.amg.fused_cycle import (
    cg_fusion_supported,
    fused_fine_supported,
    vcycle_fused,
    vcycle_fused_dots,
    vcycle_fused_rupdate,
)
from tpusparse_torch.amg.hierarchy import (
    AMGParams,
    cast_coarse_coefs,
    cast_hierarchy,
    gamg_setup,
    hierarchy_summary,
    plain_cycle_only,
    threshold_schedule,
    vcycle,
)
from tpusparse_torch.amg.unstructured import gamg_setup_unstructured
from tpusparse_torch.dist.fused_sharded import FusedSharded, sharded_route_refusal, vcycle_fused_sharded
from tpusparse_torch.dist.mesh import check_divisible, make_z_mesh
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import (
    assemble_poisson,
    poisson_dia_device,
    poisson_stencil_device,
)
from tpusparse_torch.solve.bcgs import bicgstab
from tpusparse_torch.solve.cg import ConvergedReason, cg
from tpusparse_torch.solve.chebyshev import chebyshev
from tpusparse_torch.solve.fgmres import fgmres
from tpusparse_torch.solve.gmres import gmres
from tpusparse_torch.solve.minres import minres
from tpusparse_torch.solve.pipelined import cg_pipelined
from tpusparse_torch.solve.refine import cg_refined
from tpusparse_torch.solve.simple import preonly, richardson
from tpusparse_torch.solve.spectrum import eigenvalue_block, ritz_values
from tpusparse_torch.sparse.dia import DIA
from tpusparse_torch.sparse.padded import PaddedStar, crop_field, pad_field
from tpusparse_torch.sparse.starlift import star_lift


@dataclasses.dataclass
class SolveReport:
    nx: int
    ny: int
    nz: int
    iters: int
    resnorm: float
    linf_error: float
    reason: int
    t_init: float
    t_setup: float
    t_solve: float
    rtol: float
    atol: float
    pc: str
    device: str          # the device the solve ran on, by name
    precision: str = "mixed"
    outer_iters: int = 0
    mat_type: str = "stencil"
    # t_setup's parts in seconds: "star_lift" (or "star_lift_refused") on
    # the aij route, "hierarchy_build" with GAMG
    setup_breakdown: dict | None = None
    # -ksp_monitor data, f32 values as the JAX package records them: the
    # true ||r||_2 of each outer sweep under mixed precision, the method's
    # norm of each iteration under uniform precision (index 0 = initial)
    residual_history: list | None = None
    # -ksp_view text (KSPView + PCView), filled when view=True
    solver_view: str | None = None
    # -ksp_compute_eigenvalues data: the Ritz values of M A from CG's own
    # scalars (solve/spectrum.py), ascending
    eigenvalues: list | None = None
    # the z-shards of the fine level (n_devices), all on ``device``
    z_shards: int = 1

    def log_view(self) -> str:
        """PETSc ``-log_view``-style performance summary: phase wall times
        plus the solve phase's flop accounting (PetscLogFlops model: 2*nnz
        per fine operator apply, ~7 applies per iteration, a coarse
        hierarchy ~1.6x the fine level's work)."""
        n = self.nx * self.ny * self.nz
        nnz = 7 * n - 2 * (
            self.ny * self.nz + self.nx * self.nz + self.nx * self.ny
        )
        flops = 2 * nnz * 7 * 1.6 * max(self.iters, 1)
        total = self.t_init + self.t_setup + self.t_solve
        lines = [
            "--- Performance Summary (-log_view) "
            "----------------------------------",
            f"{'Phase':<16}{'Time (s)':>12}{'% total':>10}",
            f"{'init (system)':<16}{self.t_init:>12.4f}"
            f"{100 * self.t_init / total:>9.1f}%",
            f"{'setup (KSP+PC)':<16}{self.t_setup:>12.4f}"
            f"{100 * self.t_setup / total:>9.1f}%",
            f"{'solve':<16}{self.t_solve:>12.4f}"
            f"{100 * self.t_solve / total:>9.1f}%",
            f"solve: {self.iters} iterations, ~{flops / 1e9:.2f} GFLOP "
            f"(PetscLogFlops model), "
            f"{flops / self.t_solve / 1e9:.1f} GFLOP/s, "
            f"{nnz * max(self.iters, 1) / self.t_solve / 1e9:.2f} Gnnz/s",
        ]
        return "\n".join(lines)

    def monitor_block(self) -> str:
        """PETSc ``-ksp_monitor`` output: '  %d KSP Residual norm %e' per
        recorded residual (KSPMonitorResidual format)."""
        if not self.residual_history:
            return ""
        return "\n".join(
            f"  {i} KSP Residual norm {r:e}"
            for i, r in enumerate(self.residual_history)
        )

    def eigenvalues_block(self) -> str:
        """PETSc ``-ksp_compute_eigenvalues`` output and the kappa(M A)
        estimate (``solve/spectrum.py::eigenvalue_block``)."""
        if not self.eigenvalues:
            return ""
        return eigenvalue_block(np.asarray(self.eigenvalues))

    def converged_reason_line(self) -> str:
        """PETSc ``-ksp_converged_reason`` output (KSPConvergedReasonView
        format)."""
        try:
            name = ConvergedReason(self.reason).name
        except ValueError:
            name = str(self.reason)
        verdict = "converged" if self.reason > 0 else "did not converge"
        return f"Linear solve {verdict} due to {name} iterations {self.iters}"

    def reference_block(self) -> str:
        """The reference's exact output contract (src/main_ksp.cpp:124-129)."""
        return (
            f"[Nx, Ny, Nz]: [{self.nx}, {self.ny}, {self.nz}]\n"
            f"Number of iterations: {self.iters}\n"
            f"L2 norm of final residual: {self.resnorm:f}\n"
            f"Maximum norm of error: {self.linf_error:f}\n"
            f"Time [init, create solver, solve]: "
            f"[{self.t_init:f}, {self.t_setup:f}, {self.t_solve:f}]"
        )

    def json_sidecar(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class DivergedError(RuntimeError):
    """SETERRQ1-on-negative-reason parity (src/main_ksp.cpp:109-111)."""


def _pick_ksp(
    ksp: str, ksp_gmres_restart: int = 30, ksp_richardson_scale: float = 1.0,
    precision: str = "mixed",
):
    """The solver a ``-ksp_type`` name selects: the inner solver under mixed
    precision, the whole solve under uniform precision."""
    solvers = {
        "cg": cg,
        # under mixed precision, f64 recurrence scalars and residual
        # replacement every 5: the f32 recurrences NaN'd at >= 144^3 on the
        # TPU (the JAX driver's :189-217); vectors and dots stay f32
        "pipecg": (
            functools.partial(cg_pipelined, scalar_dtype=torch.float64, replace_every=5)
            if precision == "mixed" else cg_pipelined
        ),
        "gmres": functools.partial(gmres, restart=ksp_gmres_restart),
        "fgmres": functools.partial(fgmres, restart=ksp_gmres_restart),
        "bcgs": bicgstab,
        "minres": minres,
        "chebyshev": chebyshev,
        "richardson": functools.partial(richardson, scale=ksp_richardson_scale),
        "preonly": preonly,
    }
    if ksp not in solvers:
        raise ValueError(f"unknown ksp {ksp!r} ({' | '.join(solvers)})")
    return solvers[ksp]


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work before a timer read."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_system(grid: Grid3D, device):
    """The manufactured system on ``grid``: the f64 outer operator, ``b``,
    the exact solution, and the padded f32 operator of the inner solves
    (also the AMG's home dtype)."""
    op, b, exact = poisson_stencil_device(grid, dtype=torch.float64, device=device)
    op_lo = PaddedStar.from_star(
        poisson_stencil_device(grid, dtype=torch.float32, device=device)[0]
    )
    return op, b, exact, op_lo


def _refined_padded(op, op_lo, b, m_lo_mv, *, rtol, atol, divtol=1e5, ksp_solve=cg,
                    history=False, m_lo_mv_dots=None, **fused):
    """f64 defect correction around the f32 ``ksp_solve`` on padded fields,
    preconditioned by ``m_lo_mv`` (None: none).  CG also takes the fused
    ``<p, Ap>`` (K2) and, where given, the dot-fused preconditioner."""
    if ksp_solve is cg:
        fused.setdefault("a_lo_mv_dot", op_lo.mv_dot)
        if m_lo_mv_dots is not None:
            fused["m_lo_mv_dots"] = m_lo_mv_dots
    return cg_refined(
        op.mv, op_lo.mv, b, rtol=rtol, atol=atol, divtol=divtol, m_lo_mv=m_lo_mv,
        solver=ksp_solve, history=history, encode=pad_field,
        decode=functools.partial(crop_field, shape=tuple(b.shape)), **fused,
    )


def refined_solve(
    op, op_lo, pc_state, b, *, rtol: float, atol: float, divtol: float = 1e5,
    ksp_solve=cg, history: bool = False, cg_fusion: bool = False, gamma: int = 1,
):
    """f64 defect correction around the f32 ``ksp_solve`` preconditioned by
    the padded cycle (a W-cycle for ``gamma`` 2).  Where the fine level
    takes the fused kernels, CG takes the dot-fused cycle and the fused
    ``<p, Ap>``, every other method the dot-free cycle; elsewhere every
    method takes the unfused padded cycle (K10-K16).  ``cg_fusion`` adds
    the full-fusion pair, which ``cg_refined`` puts before both (CG only;
    a degree-2 fine smoother, ``cg_fusion_supported``)."""
    fused = {}
    if cg_fusion:
        if not cg_fusion_supported(pc_state):
            raise ValueError(
                f"cg_fusion=True needs a degree-2 level-0 smoother on the fused"
                f" fine level, not {pc_state.level_cfg(0)}: descentu has no"
                f" degree-1 form"
            )
        fused.update(
            ab_fused=op_lo.cgmv,
            m_fused=lambda r, ap, alpha: vcycle_fused_rupdate(pc_state, r, ap, alpha, gamma),
        )
    if fused_fine_supported(pc_state):
        m, dots = (lambda r: vcycle_fused(pc_state, r, gamma)), (lambda r: vcycle_fused_dots(pc_state, r, gamma))
    else:
        m, dots = (lambda r: vcycle(pc_state, r, gamma=gamma)), None
    return _refined_padded(
        op, op_lo, b, m, rtol=rtol, atol=atol, divtol=divtol, ksp_solve=ksp_solve,
        history=history, m_lo_mv_dots=dots, **fused,
    )


def build_system_aij(grid: Grid3D, device):
    """The manufactured system on ``grid`` as a general matrix, assembled
    on ``device`` (``poisson_dia_device``): ``(op_hi, op_lo, b, exact)``,
    flat.  ``op_lo`` is the f32 ``DIA`` of the inner solves and the
    hierarchy's fine level; ``op_hi`` the two-float ``DFDIA`` outer operator
    aliasing its bands; ``b``/``exact`` f64."""
    return poisson_dia_device(grid, device=device)


def refined_solve_plain(
    op_hi, pc_state, b, *, rtol: float, atol: float, divtol: float = 1e5,
    ksp_solve=cg, history: bool = False, gamma: int = 1,
):
    """f64 defect correction around the f32 ``ksp_solve`` preconditioned
    by the plain cycle, on unpadded fields: the aij route's flat DIA
    levels and the plain layout's f32 ``StarStencil3D`` fine level.  The
    inner operator is the hierarchy's fine level, as in the JAX driver;
    neither has a ``mv_dot``, so no method takes a fused form."""
    return cg_refined(
        op_hi.mv, pc_state.levels[0].op.mv, b, rtol=rtol, atol=atol, divtol=divtol,
        m_lo_mv=lambda r: vcycle(pc_state, r, gamma=gamma), solver=ksp_solve, history=history,
    )


def refined_solve_sharded(op_hi, op_lo, pc_state, b, *, rtol: float, atol: float, divtol: float = 1e5,
                          ksp_solve=cg, history: bool = False, gamma: int = 1):
    """f64 defect correction around the f32 ``ksp_solve`` on plain fields,
    preconditioned by the z-sharded fused cycle: ``pc_state`` is the plain
    hierarchy and its ``FusedSharded``.  As in the JAX driver, CG takes no
    fused ``<p, Ap>`` here: ``op_lo.mv`` is K1p."""
    hier, fs = pc_state
    return cg_refined(
        op_hi.mv, op_lo.mv, b, rtol=rtol, atol=atol, divtol=divtol,
        m_lo_mv=lambda r: vcycle_fused_sharded(fs, hier, r, gamma), solver=ksp_solve, history=history,
    )


def _ssor(op):
    """The standalone ``-pc_type sor`` in CG's symmetric form (PETSc's
    ``-pc_sor_symmetric``): one forward and one reversed multicolor
    Gauss-Seidel sweep from zero (the JAX driver's ``:646-677``)."""
    dinv = 1.0 / op.diagonal_field()
    masks = op.gs_color_masks()

    def apply(r):
        x = None
        for m in masks + masks[::-1]:
            if x is None:
                x = torch.where(m, dinv * r, torch.zeros_like(r))
            else:
                x = torch.where(m, x + dinv * (r - op.mv(x)), x)
        return x

    return apply


def _standalone_pc(pc: str, op_lo):
    """The preconditioner of a standalone ``pc``, built once at setup:
    point Jacobi, SSOR, or None for none."""
    if pc == "jacobi":
        dinv = 1.0 / (op_lo.diagonal_field() if hasattr(op_lo, "diagonal_field") else op_lo.diagonal())
        return lambda r: dinv * r
    if pc == "sor":
        return _ssor(op_lo)
    return None


def _assemble_aij(grid: Grid3D, device, precision: str):
    """The aij system, flat: ``(op_hi, op_lo, b, exact)``.  Under mixed
    precision on the device (``build_system_aij``); under uniform precision,
    as the JAX driver's host route, one ``DIA`` in that dtype from
    ``assemble_poisson``, both operators."""
    if precision == "mixed":
        return build_system_aij(grid, device)
    a, b, exact = assemble_poisson(grid, dtype=np.float32 if precision == "f32" else np.float64)
    op = DIA.from_csr(a, device=device)
    return op, op, torch.as_tensor(b, device=device), torch.as_tensor(exact, device=device)


def solve_poisson(
    nx: int,
    ny: int | None = None,
    nz: int | None = None,
    *,
    device,
    rtol: float = 1e-14,
    atol: float = 1e-12,
    divtol: float = 1e5,
    maxiter: int = 10000,
    pc: str = "gamg",
    amg_params: AMGParams | None = None,
    ksp: str = "cg",
    ksp_gmres_restart: int = 30,
    ksp_richardson_scale: float = 1.0,
    mat_type: str = "stencil",
    precision: str = "mixed",
    layout: str = "auto",
    pc_dtype: str = "f32",
    mg_cycle: str = "v",
    extent: tuple[float, float, float] | None = None,
    structure_detect: bool = True,
    compute_eigenvalues: bool = False,
    cg_fusion: bool = False,
    n_devices: int = 1,
    monitor: bool = False,
    view: bool = False,
    warmup: bool = True,
) -> SolveReport:
    """End-to-end solve on the ``nx`` x ``ny`` x ``nz`` grid (``ny``/``nz``
    default to ``nx``) over the box ``extent`` = (lx, ly, lz) (the unit
    cube by default) with the reference's defaults (tolerances:
    configs/PETSc_SolverOptions_GAMG.info:1-4, AMG options: ``amg_params``
    or ``AMGParams()``) on ``device``.

    ``ksp``: the Krylov method (``_pick_ksp``).  Under mixed precision,
    as in the JAX driver, each inner solve is capped at ``cg_refined``'s
    ``inner_maxiter`` and the sweeps at its ``max_outer``, so ``maxiter``
    only enters the ``-ksp_view`` text; under uniform precision it caps the
    solve.  ``monitor`` records the residual norms (``-ksp_monitor``): the
    true residual of each outer sweep under mixed precision, the method's
    own norm of each iteration under uniform precision.  ``view`` records
    the solver's configuration text.  ``compute_eigenvalues``: the Ritz
    values of M A from CG's scalars (``solve/spectrum.py``), for
    uniform-precision CG without ``monitor``; elsewhere it warns and is
    skipped, as in the JAX driver.

    ``pc``: "gamg" (the hierarchy of ``amg_params``; ``mg_cycle`` "v" or
    "w"; ``amg_params.threshold`` > 0 builds the semicoarsening schedule of
    ``threshold_schedule`` on the stencil route), "jacobi", "sor" (SSOR, the
    stencil route's plain layout) or "none".  "bjacobi" raises on every
    route, as in the JAX driver without a host matrix.

    ``mat_type``: "stencil" or "aij", the system as a general banded matrix
    (``DIA``, and a two-float ``DFDIA`` outer operator under mixed
    precision).  With ``pc="gamg"`` and ``structure_detect`` (the JAX
    default) the driver first proves the matrix a constant-coefficient star
    (``sparse/starlift.py``) and, on success, solves it on the stencil
    route: padded, or plain where ``plain_cycle_only`` asks for the plain
    cycle, ignoring ``layout`` and ``pc_dtype`` as the JAX aij driver does;
    the proof's time is ``t_setup``'s ``setup_breakdown["star_lift"]``.
    Otherwise (or where the proof fails, ``"star_lift_refused"``) it runs
    the structure-blind route: a geometric GAMG over flat DIA levels whose
    f32 applies are kernel K5, mixed precision only.  The system is
    assembled on the device under mixed precision (``poisson_dia_device``)
    and on the host under uniform precision (``assemble_poisson``), the JAX
    driver's default ``assembly="auto"``.

    ``precision``: "mixed" (f32 inner solves under f64 defect correction),
    "f64" or "f32" (uniform: one solve in that dtype, always on plain
    fields).  "tf", the two-float outer, is not to port: it exists because
    the TPU lacks f64.

    ``layout`` (stencil, mixed precision): "padded", the padded-resident
    layout; "plain"; or "auto", the JAX driver's rule on its TPU: padded,
    unless ``plain_cycle_only`` (or ``pc="sor"``) asks for the plain
    cycle.  "padded" raises there.

    ``pc_dtype``: "f32", or "bf16", which casts the whole hierarchy
    (``cast_hierarchy``) on the stencil route's plain layout and under
    uniform precision; the cycle then takes ``r`` in bf16 and returns ``z``
    in ``r``'s dtype.  The padded route ignores it, as the JAX driver does,
    and keeps its own bf16 coarse coefficients (``cast_coarse_coefs``).

    ``n_devices``: p > 1 z-shards of the fine level, all on ``device`` (the
    z-sharded route above): the mixed-precision stencil solve under GAMG
    with a degree-2 Chebyshev or Richardson level-0 smoother, on the padded
    or automatic layout; nz must divide into p shards of at least FACE
    planes (``ValueError``).  Every other route with p > 1 raises
    ``NotImplementedError`` (ROADMAP queue 12), as does a threshold
    schedule that filters level 0.  A W-cycle passes ``gamma`` through.

    ``cg_fusion``: the full-fusion CG body, the JAX driver's
    ``TPUSPARSE_CG_FUSION`` environment switch as an argument.  It takes
    the padded mixed-precision stencil route, ``ksp="cg"``, ``pc="gamg"``
    and a degree-2 level-0 smoother, and raises elsewhere: where the JAX
    driver silently runs the unfused body, the port never reports a fused
    solve that did not run.

    Phase timing protocol (main_ksp.cpp:80-106): init = system build,
    setup = preconditioner construction (and the structure proof), solve =
    the solve.  The device is brought up before the init timer starts; the
    setup and the proof run once untimed before their timed run, and the
    solve once before its timed run, so kernel builds and first-call costs
    stay out of ``t_setup`` and ``t_solve``.  Every timer read follows a
    device synchronize.
    """
    if mat_type not in ("stencil", "aij"):
        raise ValueError(f"unknown mat_type {mat_type!r}")
    if pc == "bjacobi":
        raise ValueError(
            "pc='bjacobi' needs the JAX package's host CSR (assembly='host'),"
            " which neither route of the port keeps; -pc_bjacobi_bs with"
            " pc='gamg' is the block-Jacobi smoother"
        )
    if pc not in ("gamg", "jacobi", "sor", "none") or (mat_type == "aij" and pc == "sor"):
        raise ValueError(f"unknown pc {pc!r}")
    if mg_cycle not in ("v", "w"):
        raise ValueError(f"unknown mg_cycle {mg_cycle!r}")
    gamma = 1 if mg_cycle == "v" else 2
    if precision == "tf":
        raise NotImplementedError(
            "precision='tf' (the two-float outer) is not to port: it exists"
            " because the TPU lacks f64 (ROADMAP, Not to port)"
        )
    if precision not in ("mixed", "f64", "f32"):
        raise ValueError(f"unknown precision {precision!r} (mixed | f64 | f32)")
    if layout not in ("auto", "padded", "plain"):
        raise ValueError(f"unknown layout {layout!r} (auto | padded | plain)")
    if pc_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown pc_dtype {pc_dtype!r} (f32 | bf16)")
    params = amg_params or AMGParams()
    sharded = n_devices > 1
    if sharded:
        refusal = sharded_route_refusal(
            mat_type=mat_type, precision=precision, pc=pc, layout=layout, pc_dtype=pc_dtype, params=params,
        )
        if refusal is not None:
            raise NotImplementedError(
                f"n_devices={n_devices} with {refusal} is not ported to tpusparse_torch yet (ROADMAP queue 12:"
                f" the JAX package runs it as a GSPMD program over a (z, y) mesh)"
            )
        if cg_fusion:
            raise ValueError("cg_fusion=True is single-device: the full-fusion body has no sharded form")
    plain_only = pc == "sor" or (pc == "gamg" and plain_cycle_only(params))
    if mat_type == "stencil" and layout == "padded" and plain_only:
        raise ValueError(
            "layout='padded' is point-Jacobi + jacobi-coarse only; drop"
            " -pc_bjacobi_bs / -mg_levels_pc_type sor / -mg_coarse_pc_type lu"
            " / -pc_type sor or use layout='plain'/'auto'"
        )
    mixed = precision == "mixed"
    lift = mat_type == "aij" and pc == "gamg" and structure_detect
    if mat_type == "aij":
        route = "aij"
        if not mixed and not lift:
            raise NotImplementedError(
                f"precision={precision!r} with mat_type='aij' runs only through"
                f" the star lift (pc='gamg', structure_detect=True): the"
                f" structure-blind route in uniform precision is not ported to"
                f" tpusparse_torch yet (ROADMAP queue 1, item 9.5)"
            )
    elif sharded:
        route = "sharded"
    else:
        route = "padded" if mixed and layout != "plain" and not plain_only else "plain"
    if cg_fusion and (route != "padded" or ksp != "cg" or pc != "gamg"):
        raise ValueError(
            "cg_fusion=True is the full-fusion CG body of the padded"
            " mixed-precision stencil route: it needs ksp='cg', pc='gamg',"
            " mat_type='stencil', precision='mixed' and layout='padded'"
        )
    eigs = compute_eigenvalues
    if eigs and (mixed or ksp != "cg" or monitor):
        # PETSc computes them for any KSP; the Lanczos identity is wired
        # for uniform-precision CG (mixed precision runs many short inner
        # solves, no single Lanczos process), as in the JAX driver
        warnings.warn(
            "-ksp_compute_eigenvalues needs uniform-precision -ksp_type cg"
            " without -ksp_monitor; skipping eigenvalue computation"
        )
        eigs = False
    lx, ly, lz = extent or (1.0, 1.0, 1.0)
    grid = Grid3D(nx, ny or nx, nz or nx, lx=lx, ly=ly, lz=lz)
    ksp_solve = _pick_ksp(ksp, ksp_gmres_restart, ksp_richardson_scale, precision)
    device = torch.device(device)
    if sharded:
        mesh = make_z_mesh(n_devices, device)
        check_divisible(grid.shape, mesh)
    kw = dict(rtol=rtol, atol=atol, divtol=divtol, ksp_solve=ksp_solve, history=monitor)
    # the transfer einsums are f32 products: keep them out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.zeros((), dtype=torch.float32, device=device)  # bring-up, outside the phases
    _sync(device)

    t0 = time.perf_counter()
    if route == "padded":
        op, b, exact, op_lo = build_system(grid, device)
        layout_text = "layout: padded-resident"
    elif route in ("plain", "sharded"):
        dtype = torch.float32 if precision == "f32" else torch.float64
        op, b, exact = poisson_stencil_device(grid, dtype=dtype, device=device)
        op_lo = (
            poisson_stencil_device(grid, dtype=torch.float32, device=device)[0]
            if mixed else op
        )
        layout_text = (
            "layout: plain" if route == "plain" else
            f"layout: z-sharded, {n_devices} z-shards of {grid.nz // n_devices} planes on one device"
            f" ({device})"
        )
    else:
        op, op_lo, b, exact = _assemble_aij(grid, device, precision)
        layout_text = "mat_type: aij (DIA containers)"
    _sync(device)
    t_init = time.perf_counter() - t0

    breakdown = {}
    view_extra, t_lift = None, 0.0
    if lift:
        if warmup:
            star_lift(op_lo, op, grid.shape)
            _sync(device)
        t0 = time.perf_counter()
        lifted = star_lift(op_lo, op, grid.shape)
        proved = lifted is not None
        if proved:
            # onto the stencil route; the DIA containers go with the names
            op, op_lo = lifted
            del lifted
            b, exact = b.reshape(grid.shape), exact.reshape(grid.shape)
            route = "padded" if mixed and not plain_only else "plain"
            if route == "padded":
                op_lo = PaddedStar.from_star(op_lo)
            layout_text = "layout: padded-resident" if route == "padded" else "layout: plain"
            view_extra = (
                "mat structure: constant-coefficient star DETECTED (exact proof)"
                " -> structured executor"
            )
        _sync(device)
        t_lift = time.perf_counter() - t0
        breakdown["star_lift" if proved else "star_lift_refused"] = t_lift
        if not proved and not mixed:
            raise NotImplementedError(
                "the matrix did not prove a star, and the structure-blind aij"
                " route in uniform precision is not ported to tpusparse_torch"
                " yet (ROADMAP queue 1, item 9.5)"
            )
    bf16 = pc_dtype == "bf16" and pc == "gamg" and mat_type == "stencil" and route == "plain"

    # -pc_gamg_threshold on the stencil route: a host strength measure picks
    # a per-axis coarsening schedule (None when isotropic: the threshold-0
    # hierarchy), outside the timed setup as in the JAX driver
    sched = (
        threshold_schedule(op_lo, params.threshold, params.factor)
        if pc == "gamg" and route != "aij" else None
    )
    if route == "sharded" and sched is not None and 1 in sched[0]:
        # JAX's sharded route passes the kernels no filtered legs, so it
        # would smooth P with the full ones there (ROADMAP §3)
        raise NotImplementedError(
            f"n_devices={n_devices} with a threshold schedule that filters level 0 ({sched[0]}) is not ported"
            f" to tpusparse_torch yet (ROADMAP queue 12)"
        )
    if pc == "gamg":
        if route == "sharded":
            def setup():
                return gamg_setup(op_lo, params, factors_schedule=sched), FusedSharded.build(op_lo, mesh)
        elif route == "padded":
            def setup():
                # bf16 coarse coefficient stacks: vectors stay f32
                return cast_coarse_coefs(gamg_setup(op_lo, params, factors_schedule=sched))
        elif route == "plain":
            def setup():
                hier = gamg_setup(op_lo, params, factors_schedule=sched)
                # the bf16 V-cycle: every stored field of the hierarchy
                return cast_hierarchy(hier, torch.bfloat16) if bf16 else hier
        else:
            def setup():
                return gamg_setup_unstructured(op_lo, params)
    else:
        def setup():
            return _standalone_pc(pc, op_lo)

    def m(r):
        """The GAMG cycle of the plain and uniform routes."""
        if bf16:
            return vcycle(pc_state, r.to(torch.bfloat16), gamma=gamma).to(r.dtype)
        return vcycle(pc_state, r, gamma=gamma)

    if route == "padded":
        def solve():
            if pc == "gamg":
                return refined_solve(op, op_lo, pc_state, b, cg_fusion=cg_fusion, gamma=gamma, **kw)
            return _refined_padded(op, op_lo, b, pc_state, **kw)
    elif route == "sharded":
        def solve():
            return refined_solve_sharded(op, op_lo, pc_state, b, gamma=gamma, **kw)
    elif mixed:
        def solve():
            if pc == "gamg" and not bf16:
                return refined_solve_plain(op, pc_state, b, gamma=gamma, **kw)
            return cg_refined(
                op.mv, op_lo.mv, b, rtol=rtol, atol=atol, divtol=divtol,
                m_lo_mv=m if pc == "gamg" else pc_state, solver=ksp_solve, history=monitor,
            )
    else:
        extra = {"spectrum": True} if eigs else {"history": True} if monitor else {}

        def solve():
            return ksp_solve(
                op.mv, b, rtol=rtol, atol=atol, divtol=divtol, maxiter=maxiter,
                m_mv=m if pc == "gamg" else pc_state, **extra,
            )

    if warmup:
        setup()
        _sync(device)
    t0 = time.perf_counter()
    pc_state = setup()
    _sync(device)
    t_pc = time.perf_counter() - t0
    if pc == "gamg":
        breakdown["hierarchy_build"] = t_pc
    t_setup = t_lift + t_pc
    if route == "padded" and pc == "gamg":
        layout_text += (
            " (fused fine level)" if fused_fine_supported(pc_state)
            else " (unfused cycle, kernels K10-K16)"
        )
    if route == "sharded":
        layout_text += " (fused fine level per z-shard, kernels K3z/K4z)"

    if warmup:
        solve()
        _sync(device)
    t0 = time.perf_counter()
    res = solve()
    _sync(device)
    t_solve = time.perf_counter() - t0
    res, recorded = res if (monitor or eigs) else (res, None)

    if res.reason < 0:
        raise DivergedError(f"Diverged reason: {res.reason}")
    history = eig_list = None
    if monitor:
        # the recorded prefix: one norm per outer sweep under mixed
        # precision, per iteration under uniform precision
        count = res.outer_iters if mixed else res.iters
        history = [float(v) for v in recorded[: count + 1]]
    elif eigs:
        eig_list = [float(v) for v in ritz_values(*recorded, res.iters)]
    view_text = None
    if view:
        view_text = "\n".join([
            f"KSP Object: type {ksp}, rtol {rtol:g}, atol {atol:g}, maxit {maxiter}",
            f"  precision: {precision}, {layout_text}",
            *([f"  {view_extra}"] if view_extra else []),
            *(["  pc_dtype: bf16 (cast_hierarchy)"] if bf16 else []),
            hierarchy_summary(pc_state[0] if route == "sharded" else pc_state, gamma) if pc == "gamg"
            else f"PC Object: type {pc}",
        ])
    linf = (res.x - exact).abs().max().item()
    return SolveReport(
        nx=grid.nx, ny=grid.ny, nz=grid.nz,
        iters=res.iters,
        resnorm=res.resnorm,
        linf_error=linf,
        reason=res.reason,
        t_init=t_init,
        t_setup=t_setup,
        t_solve=t_solve,
        rtol=rtol,
        atol=atol,
        pc=pc,
        device=(
            torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type
        ),
        precision=precision,
        outer_iters=getattr(res, "outer_iters", 0),
        mat_type=mat_type,
        setup_breakdown=breakdown or None,
        residual_history=history,
        solver_view=view_text,
        eigenvalues=eig_list,
        z_shards=n_devices,
    )

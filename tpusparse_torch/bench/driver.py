"""The solve driver — port of the mixed-precision GAMG branches of
``tpusparse/bench/driver.py``.

Reproduces the protocol of the reference's ``src/main_ksp.cpp``: build
the manufactured Poisson system, set up the Krylov solver + AMG, solve, fail
on divergence, compute the Linf error against the analytic solution, and
report the phase triple ``[init, create solver, solve]`` in the reference's
text format (``src/main_ksp.cpp:124-129``) plus a JSON sidecar.

Every solve is an f32 Krylov method (``-ksp_type``, ``_pick_ksp``)
preconditioned by a GAMG V-cycle under f64 defect correction, on one
device, with a convergence check every iteration.  Two routes:

- ``mat_type="stencil"``: the 7-point stencil operator on the
  padded-resident layout and the fused fine level.  CG takes the dot-fused
  cycle (``vcycle_fused_dots``) and the fused ``<p, Ap>``
  (``PaddedStar.mv_dot``); every other method the dot-free
  ``vcycle_fused`` (the JAX driver's ``:627-642``, ``:704-709``).  Kernels
  K1-K4 for a degree-2 smoother, K6/K7 (or K6'/K7') for the reference
  config's Richardson(1).
- ``mat_type="aij"``: the structure-blind general-matrix route
  (``_solve_poisson_aij`` with ``structure_detect=False`` in the JAX
  driver).  The system is a 7-band DIA (f32 ``DIA`` for the inner solves,
  two-float ``DFDIA`` for the outer residual), the hierarchy the
  device-resident geometric GAMG (``amg/geo.py``), and the V-cycle the
  plain one over flat DIA levels; every f32 level apply is kernel K5.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time

import torch

from tpusparse_torch.amg.fused_cycle import (
    fused_fine_supported,
    vcycle_fused,
    vcycle_fused_dots,
)
from tpusparse_torch.amg.hierarchy import (
    AMGParams,
    cast_coarse_coefs,
    gamg_setup,
    hierarchy_summary,
    vcycle,
)
from tpusparse_torch.amg.unstructured import gamg_setup_unstructured
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_dia_device, poisson_stencil_device
from tpusparse_torch.solve.bcgs import bicgstab
from tpusparse_torch.solve.cg import ConvergedReason, cg
from tpusparse_torch.solve.chebyshev import chebyshev
from tpusparse_torch.solve.fgmres import fgmres
from tpusparse_torch.solve.gmres import gmres
from tpusparse_torch.solve.minres import minres
from tpusparse_torch.solve.pipelined import cg_pipelined
from tpusparse_torch.solve.refine import cg_refined
from tpusparse_torch.solve.simple import preonly, richardson
from tpusparse_torch.sparse.padded import PaddedStar, crop_field, pad_field


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
    # -ksp_monitor data: the true ||r||_2 of each outer sweep (index 0 =
    # ||b||), f32 values as the JAX package records them
    residual_history: list | None = None
    # -ksp_view text (KSPView + PCView), filled when view=True
    solver_view: str | None = None

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


def _pick_ksp(ksp: str, ksp_gmres_restart: int = 30, ksp_richardson_scale: float = 1.0):
    """The inner solver a ``-ksp_type`` name selects under mixed precision."""
    solvers = {
        "cg": cg,
        # f64 recurrence scalars and residual replacement every 5: the f32
        # recurrences NaN'd at >= 144^3 on the TPU (the JAX driver's
        # :189-217); vectors and dots stay f32
        "pipecg": functools.partial(cg_pipelined, scalar_dtype=torch.float64, replace_every=5),
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


def refined_solve(
    op, op_lo, pc_state, b, *, rtol: float, atol: float, divtol: float = 1e5,
    ksp_solve=cg, history: bool = False,
):
    """f64 defect correction around the f32 ``ksp_solve`` preconditioned
    by the fused V-cycle: CG takes the dot-fused cycle and the fused
    ``<p, Ap>``, every other method the dot-free cycle."""
    fused = (
        dict(m_lo_mv_dots=lambda r: vcycle_fused_dots(pc_state, r), a_lo_mv_dot=op_lo.mv_dot)
        if ksp_solve is cg else {}
    )
    return cg_refined(
        op.mv, op_lo.mv, b, rtol=rtol, atol=atol, divtol=divtol,
        m_lo_mv=lambda r: vcycle_fused(pc_state, r), solver=ksp_solve,
        history=history, encode=pad_field,
        decode=functools.partial(crop_field, shape=tuple(b.shape)), **fused,
    )


def build_system_aij(grid: Grid3D, device):
    """The manufactured system on ``grid`` as a general matrix, assembled
    on ``device`` (``poisson_dia_device``): ``(op_hi, op_lo, b, exact)``,
    flat.  ``op_lo`` is the f32 ``DIA`` of the inner solves and the
    hierarchy's fine level; ``op_hi`` the two-float ``DFDIA`` outer operator
    aliasing its bands; ``b``/``exact`` f64."""
    return poisson_dia_device(grid, device=device)


def refined_solve_aij(
    op_hi, pc_state, b, *, rtol: float, atol: float, divtol: float = 1e5,
    ksp_solve=cg, history: bool = False,
):
    """f64 defect correction around the f32 ``ksp_solve`` preconditioned
    by the plain V-cycle over the DIA levels, on flat vectors.  The inner
    operator is the hierarchy's fine level, as in the JAX driver."""
    return cg_refined(
        op_hi.mv, pc_state.levels[0].op.mv, b, rtol=rtol, atol=atol,
        divtol=divtol, m_lo_mv=lambda r: vcycle(pc_state, r),
        solver=ksp_solve, history=history,
    )


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
    monitor: bool = False,
    view: bool = False,
    warmup: bool = True,
) -> SolveReport:
    """End-to-end solve on the ``nx`` x ``ny`` x ``nz`` grid (``ny``/``nz``
    default to ``nx``) with the reference's defaults (tolerances:
    configs/PETSc_SolverOptions_GAMG.info:1-4, AMG options: ``amg_params``
    or ``AMGParams()``) on ``device``.

    ``ksp``: the inner Krylov method (``_pick_ksp``).  ``maxiter`` only
    enters the ``-ksp_view`` text: as in the JAX driver, mixed precision
    caps each inner solve at ``cg_refined``'s ``inner_maxiter`` and the
    sweeps at its ``max_outer``.  ``monitor`` records the true residual of
    each outer sweep, ``view`` the solver's configuration text.

    ``mat_type``: "stencil" or "aij".  "aij" is the structure-blind route,
    the JAX driver's ``structure_detect=False``: its default first proves
    the matrix a star and moves it onto the stencil route
    (``sparse/starlift.py``), which is not ported.

    Phase timing protocol (main_ksp.cpp:80-106): init = system build,
    setup = hierarchy construction, solve = the solve.  The device is
    brought up before the init timer starts; the setup runs once untimed
    before its timed run, and the solve once before its timed run, so
    kernel builds and first-call costs stay out of ``t_setup`` and
    ``t_solve``.  Every timer read follows a device synchronize.
    """
    if pc != "gamg":
        raise NotImplementedError(f"pc={pc!r}: only gamg is ported to tpusparse_torch")
    if mat_type not in ("stencil", "aij"):
        raise ValueError(f"unknown mat_type {mat_type!r}")
    grid = Grid3D(nx, ny or nx, nz or nx)
    ksp_solve = _pick_ksp(ksp, ksp_gmres_restart, ksp_richardson_scale)
    device = torch.device(device)
    params = amg_params or AMGParams()
    kw = dict(rtol=rtol, atol=atol, divtol=divtol, ksp_solve=ksp_solve, history=monitor)
    # the transfer einsums are f32 products: keep them out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.zeros((), dtype=torch.float32, device=device)  # bring-up, outside the phases
    _sync(device)

    t0 = time.perf_counter()
    if mat_type == "stencil":
        op, b, exact, op_lo = build_system(grid, device)
        layout = "layout: padded-resident (fused fine level)"

        def setup():
            # bf16 coarse coefficient stacks: vectors stay f32
            hier = cast_coarse_coefs(gamg_setup(op_lo, params))
            if not fused_fine_supported(hier):
                raise NotImplementedError(
                    f"a level-0 smoother of {hier.level_cfg(0)} on the stencil"
                    " route: the fused fine level takes chebyshev or richardson"
                    " of degree 1 or 2, and the unfused padded cycle is not"
                    " ported to tpusparse_torch yet (ROADMAP queue 6)"
                )
            return hier

        def solve():
            return refined_solve(op, op_lo, pc_state, b, **kw)
    else:
        op, op_lo, b, exact = build_system_aij(grid, device)
        layout = "mat_type: aij (DIA containers)"

        def setup():
            return gamg_setup_unstructured(op_lo, params)

        def solve():
            return refined_solve_aij(op, pc_state, b, **kw)
    _sync(device)
    t_init = time.perf_counter() - t0

    if warmup:
        setup()
        _sync(device)
    t0 = time.perf_counter()
    pc_state = setup()
    _sync(device)
    t_setup = time.perf_counter() - t0

    if warmup:
        solve()
        _sync(device)
    t0 = time.perf_counter()
    res = solve()
    _sync(device)
    t_solve = time.perf_counter() - t0
    res, history = res if monitor else (res, None)

    if res.reason < 0:
        raise DivergedError(f"Diverged reason: {res.reason}")
    view_text = None
    if view:
        view_text = "\n".join([
            f"KSP Object: type {ksp}, rtol {rtol:g}, atol {atol:g}, maxit {maxiter}",
            f"  precision: mixed, {layout}",
            hierarchy_summary(pc_state),
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
        outer_iters=res.outer_iters,
        mat_type=mat_type,
        residual_history=history,
        solver_view=view_text,
    )

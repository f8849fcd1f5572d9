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
- ``n_devices=p`` > 1: the solve split over a mesh of p blocks held by
  the W ranks of the ``torch.distributed`` process group (W = 1 without
  one: one process holds every block; ``dist/mesh.py``), each rank's
  vectors its own z-slab, every global reduction all-reduced
  (``solve/reduce.py``), the coarse levels whole on every rank.  The
  route mirrors the JAX driver's (``:396-431``, ``:766-830``): where the
  fused kernels take level 0 (``fused_route_ok``) the fused z route, the
  fine level as z-slabs, one K3z/K4z launch a stroke over the rank's slabs
  (``dist/fused_sharded.py``); every other option set the (z, y) plain
  route, JAX's GSPMD program, with level 0 sharded
  (``shard_hierarchy``).  On both the operators are ``HaloStar``s: each
  f32 apply runs kernel K1h on each of the rank's blocks after the
  boundary-plane exchange (``dist/halo.py``), f64 the torch apply.
- ``mat_type="aij"``: the system as a 7-band DIA (f32 ``DIA`` for the
  inner solves, two-float ``DFDIA`` for the outer residual; one ``DIA`` in
  the solve's dtype under uniform precision).  With GAMG and
  ``structure_detect`` (the JAX default, ``_solve_poisson_aij``'s
  ``:1062-1150``) ``sparse/starlift.py`` proves it a constant-coefficient
  star and the solve moves onto the stencil routes above (K1-K4 under mixed
  precision); an explicit ``aggregation="greedy"`` skips the proof.
  Otherwise it is the structure-blind route: ``amg/unstructured.py``'s
  GAMG (geometric on a grid pattern, greedy on the host CSR, banded on the
  device, routed as the JAX package routes) and the plain V-cycle over
  DIA-family levels in the inner dtype, every f32 band apply kernel K5
  (f64 levels apply in plain torch); ``pc`` is gamg, jacobi, bjacobi (from
  the host CSR) or none there, in any precision.
- ``solve_from_file``: a system read from a PETSc binary or MatrixMarket
  file (the JAX driver's ``:1478-1608``, PETSc's ex10), through ``KSP`` on
  the host matrix: the DIA family on the device (RCM-reordered, or the
  padded ELL, past 192 diagonals) and, with GAMG, the router's "auto"
  rule above.
- ``solve_diffusion``: the variable-coefficient diffusion problem (the
  JAX driver's ``:1341-1477``) over a ``VarStencil27`` fine level and the
  plain cycle, CG + GAMG only.

Each driver marks its phases for ``-profile`` traces
(``utils/profiling.py::annotate``): ``tpusparse:init``,
``tpusparse:setup`` and ``tpusparse:solve``.
"""

from __future__ import annotations

import contextlib
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
from tpusparse_torch.dist.fused_sharded import (
    AIJ_UNLIFTED,
    FusedSharded,
    fused_route_ok,
    sharded_route_refusal,
    vcycle_fused_sharded,
)
from tpusparse_torch.dist.halo import HaloStar
from tpusparse_torch.dist.mesh import (
    make_mesh,
    make_z_mesh,
    process_group,
    shard_hierarchy,
    shard_system,
)
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import (
    assemble_poisson,
    poisson_dia_device,
    poisson_stencil_device,
)
from tpusparse_torch.kernels._build import library as kernel_library
from tpusparse_torch.solve.bcgs import bicgstab
from tpusparse_torch.solve.bjacobi import BlockJacobi
from tpusparse_torch.solve.cg import ConvergedReason, cg
from tpusparse_torch.solve.chebyshev import chebyshev
from tpusparse_torch.solve.fgmres import fgmres
from tpusparse_torch.solve.gmres import gmres
from tpusparse_torch.solve.minres import minres
from tpusparse_torch.solve.pipelined import cg_pipelined
from tpusparse_torch.solve.refine import cg_refined
from tpusparse_torch.solve.simple import preonly, richardson
from tpusparse_torch.solve.spectrum import eigenvalue_block, ritz_values
from tpusparse_torch.sparse.csr import HostCSR
from tpusparse_torch.sparse.dia import host_dia_operators
from tpusparse_torch.sparse.io import load_matrix, read_petsc_objects, save_petsc_vec
from tpusparse_torch.sparse.padded import PaddedStar, crop_field, pad_field
from tpusparse_torch.sparse.starlift import star_lift
from tpusparse_torch.utils.profiling import annotate


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
    # the blocks of the fine level (n_devices), the mesh's (pz, py), the
    # ranks that held them and the route ("fused z" or "(z, y) plain")
    z_shards: int = 1
    mesh: list | None = None
    ranks: int = 1
    sharded_route: str | None = None
    # a file-loaded system (solve_from_file): the file, nx x ny the
    # matrix's shape, linf_error -1 where the file holds no exact solution;
    # or another grid problem than Poisson (solve_diffusion)
    source: str | None = None
    source_is_file: bool = False
    # t_init's parts in seconds where it has some: the file read
    # ("read"), the diagonal count ("diagonals"), the band extraction
    # ("host_bands") and the upload ("upload")
    init_breakdown: dict | None = None

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
        """The reference's exact output contract (src/main_ksp.cpp:124-129).

        A file-loaded system names the file and the matrix's shape in place
        of the grid line, and prints "n/a" for the error norm when the file
        holds no exact solution (``linf_error`` < 0); another grid problem
        (diffusion) is named above the grid line."""
        head = f"[Nx, Ny, Nz]: [{self.nx}, {self.ny}, {self.nz}]"
        if self.source_is_file:
            head = f"Matrix: {self.source} [{self.nx} x {self.ny}]"
        elif self.source:
            head = f"Problem: {self.source}\n{head}"
        linf = f"{self.linf_error:f}" if self.linf_error >= 0.0 else "n/a (no exact solution in file)"
        return (
            f"{head}\n"
            f"Number of iterations: {self.iters}\n"
            f"L2 norm of final residual: {self.resnorm:f}\n"
            f"Maximum norm of error: {linf}\n"
            f"Time [init, create solver, solve]: "
            f"[{self.t_init:f}, {self.t_setup:f}, {self.t_solve:f}]"
        )

    def json_sidecar(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class DivergedError(RuntimeError):
    """SETERRQ1-on-negative-reason parity (src/main_ksp.cpp:109-111)."""


def _pick_ksp(
    ksp: str, ksp_gmres_restart: int = 30, ksp_richardson_scale: float = 1.0,
    precision: str = "mixed", ksp_norm_type: str = "default",
):
    """The solver a ``-ksp_type`` name selects: the inner solver under mixed
    precision, the whole solve under uniform precision.  ``ksp_norm_type``
    ("default", "unpreconditioned", "preconditioned" or "none") reaches CG
    only, as in the JAX driver (``tpusparse/bench/driver.py:179-187``)."""
    solvers = {
        "cg": (
            functools.partial(cg, norm_type=ksp_norm_type)
            if ksp_norm_type not in ("default", "unpreconditioned") else cg
        ),
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
    if getattr(ksp_solve, "func", ksp_solve) is cg:  # CG under any norm_type
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
    **limits,
):
    """f64 defect correction around the f32 ``ksp_solve`` preconditioned by
    the padded cycle (a W-cycle for ``gamma`` 2).  Where the fine level
    takes the fused kernels, CG takes the dot-fused cycle and the fused
    ``<p, Ap>``, every other method the dot-free cycle; elsewhere every
    method takes the unfused padded cycle (K10-K16).  ``cg_fusion`` adds
    the full-fusion pair, which ``cg_refined`` puts before both (CG only;
    a degree-2 fine smoother, ``cg_fusion_supported``).  ``limits``:
    ``cg_refined``'s ``max_outer`` and ``inner_maxiter``."""
    fused = dict(limits)
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


def _standalone_pc(pc: str, op_lo, host_a=None, bjacobi_bs: int = 0):
    """The preconditioner of a standalone ``pc``, built once at setup:
    point Jacobi, SSOR, block Jacobi from the host matrix ``host_a``
    (``bjacobi_bs`` > 1 the inverted diagonal blocks, else point Jacobi
    from its diagonal; the JAX driver's ``:1216-1237``), or None for
    none.  Its dtype and device are the inner operator ``op_lo``'s."""
    if pc == "jacobi":
        dinv = 1.0 / (op_lo.diagonal_field() if hasattr(op_lo, "diagonal_field") else op_lo.diagonal())
        return lambda r: dinv * r
    if pc == "sor":
        return _ssor(op_lo)
    if pc == "bjacobi":
        if host_a is None:
            raise ValueError(
                "pc='bjacobi' needs the host CSR: a HostCSR/scipy operator on the KSP object, or"
                " assembly='host' in solve_poisson"
            )
        dtype = np.float32 if op_lo.dtype == torch.float32 else np.float64
        dev = op_lo.bands.device
        if bjacobi_bs > 1:
            return BlockJacobi.build(host_a, bjacobi_bs, dtype=dtype, device=dev).apply
        dinv = 1.0 / torch.as_tensor(host_a.diagonal().astype(dtype), device=dev)
        return lambda r: dinv * r
    return None


def _assemble_aij(grid: Grid3D, device, precision: str, on_device: bool):
    """The aij system, flat: ``(op_hi, op_lo, b, exact, host_a)``.  On the
    device (``build_system_aij``, mixed precision only; ``host_a`` None),
    or on the host (``assemble_poisson`` in the solve's dtype, f64 under
    mixed precision) and uploaded as ``host_dia_operators`` does, keeping
    the HostCSR ``host_a``."""
    if on_device:
        return (*build_system_aij(grid, device), None)
    a, b, exact = assemble_poisson(grid, dtype=np.float32 if precision == "f32" else np.float64)
    op_hi, op_lo = host_dia_operators(a, precision, device=device)
    return op_hi, op_lo, torch.as_tensor(b, device=device), torch.as_tensor(exact, device=device), a


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
    assembly: str = "auto",
    aggregation: str = "auto",
    compute_eigenvalues: bool = False,
    cg_fusion: bool = False,
    n_devices: int = 1,
    monitor: bool = False,
    view: bool = False,
    warmup: bool = True,
    ksp_norm_type: str = "default",
) -> SolveReport:
    """End-to-end solve on the ``nx`` x ``ny`` x ``nz`` grid (``ny``/``nz``
    default to ``nx``) over the box ``extent`` = (lx, ly, lz) (the unit
    cube by default) with the reference's defaults (tolerances:
    configs/PETSc_SolverOptions_GAMG.info:1-4, AMG options: ``amg_params``
    or ``AMGParams()``) on ``device``.

    ``ksp``: the Krylov method (``_pick_ksp``), with ``ksp_norm_type``
    (CG's ``norm_type``; "default" is the unpreconditioned norm) on the
    stencil route; the aij route ignores it, as the JAX driver's does (it
    does not hand it to ``_solve_poisson_aij``).  Under mixed precision,
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
    stencil route's plain layout), "bjacobi" (the aij route with the host
    CSR, ``assembly="host"``: the inverted diagonal blocks of
    ``amg_params.bjacobi_bs`` > 1, tridiagonal blocks past the dense cap by
    PCR, or point Jacobi from the host diagonal for bs 0 or 1) or "none".

    ``mat_type``: "stencil" or "aij", the system as a general banded matrix
    (``DIA``, and a two-float ``DFDIA`` outer operator under mixed
    precision).  With ``pc="gamg"`` and ``structure_detect`` (the JAX
    default) the driver first proves the matrix a constant-coefficient star
    (``sparse/starlift.py``) and, on success, solves it on the stencil
    route: padded, or plain where ``plain_cycle_only`` asks for the plain
    cycle, ignoring ``layout`` and ``pc_dtype`` as the JAX aij driver does;
    the proof's time is ``t_setup``'s ``setup_breakdown["star_lift"]``.
    An explicit ``aggregation="greedy"`` skips the proof, as in the JAX
    driver.  Otherwise (or where the proof fails, ``"star_lift_refused"``)
    it runs the structure-blind route: ``amg/unstructured.py``'s GAMG
    (``aggregation`` "auto", "geometric", "greedy" or "banded", routed as
    the JAX package routes it, the setup's sub-phases in
    ``setup_breakdown``) over DIA-family levels in the inner dtype, whose
    f32 band applies are kernel K5 (f64 levels apply in plain torch), or a
    standalone PC.  ``assembly`` (aij only, the JAX driver's rules):
    "device" assembles on the device (``poisson_dia_device``, mixed
    precision only, and neither greedy aggregation nor a ``bjacobi_bs``
    sub-PC, which need the host CSR), "host" with ``assemble_poisson`` on
    the host (and keeps the HostCSR), and "auto" on the device under mixed
    precision where the setup needs no host CSR, on the host otherwise.

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

    ``n_devices``: p > 1 blocks of the fine level over the ranks of the
    ``torch.distributed`` process group, or all in this process without one
    (the sharded routes above): every option set the JAX driver runs with
    ``n_devices > 1``.  The fused z route takes the mixed-precision solve
    under GAMG with a degree-2 Chebyshev or Richardson level-0 smoother
    on the padded or automatic layout, nz divided into p z-slabs of at
    least FACE planes, p/W a rank; every other option set takes the (z, y)
    plain route on ``make_mesh(p)``, whose (pz, py) must divide (nz, ny)
    and W pz (``ValueError``, JAX's message).  A threshold schedule that
    filters level 0 takes the (z, y) route with the filtered P smoother
    sharded, JAX's one-device answer (its fused route drops the filtered
    legs: ROADMAP §3).  Refused as the JAX driver refuses them, with its
    messages (``NotImplementedError``): a standalone SOR or block-Jacobi PC,
    and an aij matrix that does not reach the star lift.  ``device`` is
    this rank's.  The report's ``linf_error`` is all-reduced; only the
    caller decides who prints it.

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
    sharded = n_devices > 1
    if sharded:
        refusal = sharded_route_refusal(
            mat_type=mat_type, pc=pc, structure_detect=structure_detect, aggregation=aggregation,
        )
        if refusal is not None:
            raise NotImplementedError(refusal)
        if cg_fusion:
            raise ValueError("cg_fusion=True is single-device: the full-fusion body has no sharded form")
    # SSOR needs a colorable stencil, block Jacobi the aij route's host CSR
    if pc not in ("gamg", "jacobi", "sor", "bjacobi", "none") or (mat_type, pc) in (
        ("aij", "sor"), ("stencil", "bjacobi"),
    ):
        raise ValueError(f"unknown pc {pc!r}")
    if assembly not in ("auto", "device", "host"):
        raise ValueError(f"unknown assembly {assembly!r}")
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
    plain_only = pc == "sor" or (pc == "gamg" and plain_cycle_only(params))
    if mat_type == "stencil" and layout == "padded" and plain_only:
        raise ValueError(
            "layout='padded' is point-Jacobi + jacobi-coarse only; drop"
            " -pc_bjacobi_bs / -mg_levels_pc_type sor / -mg_coarse_pc_type lu"
            " / -pc_type sor or use layout='plain'/'auto'"
        )
    if aggregation not in ("auto", "geometric", "greedy", "banded"):
        raise ValueError(f"unknown aggregation {aggregation!r}")
    mixed = precision == "mixed"
    # an explicit greedy asks for the general machinery: no star proof
    lift = mat_type == "aij" and pc == "gamg" and structure_detect and aggregation != "greedy"
    if mat_type == "aij":
        route = "aij"
        if assembly == "device" and not mixed:
            raise ValueError("assembly='device' requires precision='mixed'")
        if assembly == "device" and pc == "gamg" and (aggregation == "greedy" or params.bjacobi_bs):
            raise ValueError(
                "assembly='device' leaves no host CSR, but greedy aggregation / bjacobi_bs require one"
                " — use assembly='host'"
            )
        # the setups that need no host matrix (the JAX driver's geo_route):
        # geometric and banded, and every standalone PC but bjacobi
        geo_route = pc != "gamg" or (aggregation != "greedy" and params.bjacobi_bs == 0)
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
    ksp_solve = _pick_ksp(
        ksp, ksp_gmres_restart, ksp_richardson_scale, precision,
        ksp_norm_type if mat_type == "stencil" else "default",
    )
    device = torch.device(device)
    # several ranks: every timer read follows a barrier as well
    barrier = sharded and process_group()[1] > 1

    def sync():
        _sync(device)
        if barrier:
            torch.distributed.barrier()

    kw = dict(rtol=rtol, atol=atol, divtol=divtol, ksp_solve=ksp_solve, history=monitor)
    # the transfer einsums are f32 products: keep them out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.zeros((), dtype=torch.float32, device=device)  # bring-up, outside the phases
    sync()

    t0 = time.perf_counter()
    with annotate("tpusparse:init"):
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
            layout_text = "layout: plain"
        else:
            on_device = assembly == "device" or (
                assembly == "auto" and mixed and geo_route and min(grid.shape) >= 2
            )
            op, op_lo, b, exact, host_a = _assemble_aij(grid, device, precision, on_device)
            layout_text = "mat_type: aij (DIA/HybridDIA containers)"
        sync()
    t_init = time.perf_counter() - t0

    breakdown = {}
    view_extra, t_lift = None, 0.0
    if lift:
        if warmup:
            star_lift(op_lo, op, grid.shape)
            sync()
        t0 = time.perf_counter()
        lifted = star_lift(op_lo, op, grid.shape)
        proved = lifted is not None
        if proved:
            # onto the stencil route; the DIA containers go with the names
            op, op_lo = lifted
            del lifted
            b, exact = b.reshape(grid.shape), exact.reshape(grid.shape)
            route = "sharded" if sharded else "padded" if mixed and not plain_only else "plain"
            if route == "padded":
                op_lo = PaddedStar.from_star(op_lo)
            layout_text = "layout: padded-resident" if route == "padded" else "layout: plain"
            view_extra = (
                "mat structure: constant-coefficient star DETECTED (exact proof)"
                " -> structured executor"
            )
        sync()
        t_lift = time.perf_counter() - t0
        breakdown["star_lift" if proved else "star_lift_refused"] = t_lift
        if sharded and not proved:
            raise NotImplementedError(AIJ_UNLIFTED)

    # -pc_gamg_threshold on the stencil route: a host strength measure picks
    # a per-axis coarsening schedule (None when isotropic: the threshold-0
    # hierarchy), outside the timed setup as in the JAX driver
    sched = (
        threshold_schedule(op_lo, params.threshold, params.factor)
        if pc == "gamg" and route != "aij" else None
    )
    # the global f32 operator every rank builds its hierarchy from
    op_setup, mesh = op_lo, None
    if route == "sharded":
        # the fused z route, or the (z, y) plain route (JAX's GSPMD
        # program).  A schedule that filters level 0 takes the plain route
        # with the filtered P smoother sharded: JAX's fused route passes no
        # filtered legs (ROADMAP §3)
        fused = fused_route_ok(
            precision=precision, pc=pc, layout="auto" if mat_type == "aij" else layout,
            pc_dtype="f32" if mat_type == "aij" else pc_dtype, params=params, grid_shape=grid.shape,
            n_devices=n_devices, world=process_group()[1], filtered=sched is not None and 1 in sched[0],
        )
        mesh = make_z_mesh(n_devices, device) if fused else make_mesh(n_devices, device=device)
        op, b, exact = shard_system(op, b, exact, mesh)
        op_lo = HaloStar.build(op_lo, mesh) if mixed else op
        if fused:
            where = "one device" if mesh.world == 1 else f"{mesh.world} ranks, {n_devices // mesh.world} a rank"
            layout_text = (
                f"layout: z-sharded, {n_devices} z-shards of {grid.nz // n_devices} planes on {where} ({device})"
            )
        else:
            route = "plain"
            where = "one device" if mesh.world == 1 else f"{mesh.world} ranks"
            layout_text = (
                f"layout: plain, (z, y) mesh {mesh.pz} x {mesh.py} of {grid.nz // mesh.pz} x"
                f" {grid.ny // mesh.py}-plane blocks on {where} ({device})"
            )
    bf16 = pc_dtype == "bf16" and pc == "gamg" and mat_type == "stencil" and route == "plain"
    if pc == "gamg":
        if route == "sharded":
            def setup():
                return gamg_setup(op_setup, params, factors_schedule=sched), FusedSharded.build(op_setup, mesh)
        elif route == "padded":
            def setup():
                # bf16 coarse coefficient stacks: vectors stay f32
                return cast_coarse_coefs(gamg_setup(op_lo, params, factors_schedule=sched))
        elif route == "plain":
            def setup():
                hier = gamg_setup(op_setup, params, factors_schedule=sched)
                # the bf16 V-cycle: every stored field of the hierarchy
                hier = cast_hierarchy(hier, torch.bfloat16) if bf16 else hier
                return hier if mesh is None else shard_hierarchy(hier, mesh)
        else:
            sub_phases = {}

            def setup():
                return gamg_setup_unstructured(
                    host_a, params, dtype=np.float32 if mixed else None, fine_op=op_lo,
                    timings=sub_phases, aggregation=aggregation,
                )
    else:
        def setup():
            return _standalone_pc(pc, op_lo, host_a if route == "aij" else None, params.bjacobi_bs)

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

    host_setup = route == "aij" and pc == "gamg" and not geo_route
    if warmup and not host_setup:
        setup()
        sync()
    elif warmup and device.type == "cuda":
        # the host setup is not run twice (its cost is host work no cache
        # covers, as the JAX driver reasons); the kernels are built first
        kernel_library()
    t0 = time.perf_counter()
    with annotate("tpusparse:setup"):
        pc_state = setup()
    sync()
    t_pc = time.perf_counter() - t0
    if pc == "gamg":
        breakdown["hierarchy_build"] = t_pc
        if route == "aij":
            breakdown.update({k: v for k, v in sub_phases.items() if k != "hierarchy_build"})
    t_setup = t_lift + t_pc
    if route == "padded" and pc == "gamg":
        layout_text += (
            " (fused fine level)" if fused_fine_supported(pc_state)
            else " (unfused cycle, kernels K10-K16)"
        )
    if route == "sharded":
        layout_text += " (fused fine level per z-shard, kernels K3z/K4z)"
    # a split solve's global reductions go over the ranks
    def split():
        return mesh.reductions(grid.shape) if mesh is not None else contextlib.nullcontext()

    if warmup:
        with split():
            solve()
        sync()
    t0 = time.perf_counter()
    with annotate("tpusparse:solve"), split():
        res = solve()
    sync()
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
    linf = (res.x - exact).abs().max()
    linf = (linf if mesh is None else mesh.allreduce(linf, "max")).item()
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
        mesh=None if mesh is None else [mesh.pz, mesh.py],
        ranks=1 if mesh is None else mesh.world,
        sharded_route=None if mesh is None else "fused z" if route == "sharded" else "(z, y) plain",
    )


def solve_diffusion(
    nx: int,
    ny: int | None = None,
    nz: int | None = None,
    *,
    device="cuda",
    contrast: float = 100.0,
    rtol: float = 1e-8,
    atol: float = 1e-12,
    divtol: float = 1e5,
    maxiter: int = 10000,
    precision: str = "mixed",
    amg_params: AMGParams | None = None,
    mg_cycle: str = "v",
    warmup: bool = True,
    view: bool = False,
) -> SolveReport:
    """The second problem family through the driver's protocol on
    ``device``: variable-coefficient diffusion -div(kappa grad u) = f with
    a ``contrast``-to-1 inclusion field (``grid/diffusion.py``); port of
    the JAX driver's ``solve_diffusion``.

    The fine level is a ``VarStencil27`` (the star proof fails by
    construction), preconditioned by the plain GAMG cycle of the probed
    Galerkin hierarchy built eagerly on the f32 operator; CG runs in f32
    under f64 defect correction (``cg_refined``) under mixed precision, in
    the solve's dtype otherwise.  The gate is algebraic: exact = the
    smooth field cos cos cos - 1 (zero at the pinned cell), b = A exact in
    the hi dtype, Linf against exact: the solver's accuracy, not a
    discretization error.  Phases as ``solve_poisson``'s: the setup and
    the solve run once untimed first, and every timer read follows a
    device synchronize.
    """
    from tpusparse_torch.grid.diffusion import default_kappa, diffusion_stencil

    ny = ny or nx
    nz = nz or nx
    if precision not in ("mixed", "f64", "f32"):
        raise ValueError(f"problem=diffusion supports precision mixed|f64|f32, got {precision!r}")
    if mg_cycle not in ("v", "w"):
        raise ValueError(f"unknown mg_cycle {mg_cycle!r}")
    mixed = precision == "mixed"
    hi_dtype = np.float32 if precision == "f32" else np.float64
    params = amg_params or AMGParams()
    gamma = 1 if mg_cycle == "v" else 2
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.zeros((), dtype=torch.float32, device=device)  # bring-up, outside the phases
    _sync(device)

    t0 = time.perf_counter()
    with annotate("tpusparse:init"):
        grid = Grid3D(nx, ny, nz)
        kappa = default_kappa(grid, contrast=contrast)
        op = diffusion_stencil(grid, kappa, dtype=hi_dtype, device=device)
        # the f32 operator from kappa in f32 (JAX's), not cast from the f64 one
        op_lo = diffusion_stencil(grid, kappa, dtype=np.float32, device=device) if mixed else op
        zc, yc, xc = np.meshgrid(
            grid.cell_centers("z"), grid.cell_centers("y"), grid.cell_centers("x"), indexing="ij",
        )
        exact = torch.from_numpy(
            (np.cos(2 * np.pi * xc) * np.cos(2 * np.pi * yc) * np.cos(2 * np.pi * zc) - 1.0).astype(hi_dtype)
        ).to(device)
        del kappa, zc, yc, xc
        b = op.mv(exact)
        _sync(device)
    t_init = time.perf_counter() - t0

    if warmup:
        gamg_setup(op_lo, params)
        _sync(device)
    t0 = time.perf_counter()
    with annotate("tpusparse:setup"):
        hier = gamg_setup(op_lo, params)
    _sync(device)
    t_setup = time.perf_counter() - t0

    def m(r):
        return vcycle(hier, r, gamma=gamma)

    if mixed:
        def solve():
            return cg_refined(op.mv, op_lo.mv, b, rtol=rtol, atol=atol, divtol=divtol, m_lo_mv=m)
    else:
        def solve():
            return cg(op.mv, b, rtol=rtol, atol=atol, divtol=divtol, maxiter=maxiter, m_mv=m)

    if warmup:
        solve()
        _sync(device)
    t0 = time.perf_counter()
    with annotate("tpusparse:solve"):
        res = solve()
    _sync(device)
    t_solve = time.perf_counter() - t0
    if res.reason < 0:
        raise DivergedError(f"Diverged reason: {res.reason}")

    view_text = None
    if view:
        view_text = "\n".join([
            f"KSP Object: type cg, rtol {rtol:g}, atol {atol:g}, maxit {maxiter}",
            f"  precision: {precision}, problem: diffusion (contrast {contrast:g}, VarStencil27 fine level)",
            hierarchy_summary(hier, gamma),
        ])
    return SolveReport(
        nx=nx, ny=ny, nz=nz,
        iters=res.iters,
        resnorm=res.resnorm,
        linf_error=(res.x - exact).abs().max().item(),
        reason=res.reason,
        t_init=t_init,
        t_setup=t_setup,
        t_solve=t_solve,
        rtol=rtol,
        atol=atol,
        pc="gamg",
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        precision=precision,
        outer_iters=getattr(res, "outer_iters", 0),
        mat_type="varstencil",
        solver_view=view_text,
        source=f"diffusion(contrast={contrast:g})",
    )


def solve_from_file(
    path: str,
    *,
    device="cuda",
    rtol: float = 1e-5,
    atol: float = 1e-50,
    divtol: float = 1e5,
    maxiter: int = 10000,
    ksp: str = "cg",
    pc: str = "gamg",
    precision: str = "mixed",
    amg_params: AMGParams | None = None,
    mg_cycle: str = "v",
    ksp_gmres_restart: int = 30,
    ksp_richardson_scale: float = 1.0,
    view: bool = False,
    solution_out: str = "",
    mat_reorder: str = "auto",
) -> SolveReport:
    """Solve a system read from a file on ``device`` — PETSc KSP tutorial
    ``ex10`` ("solve a linear system from a file"), ``MatLoad``/``VecLoad``
    parity; port of the JAX driver's ``solve_from_file``.

    ``path`` is a PETSc binary viewer file (``sparse/io.py``) or a
    MatrixMarket ``.mtx``.  The objects of a PETSc file, in order: the
    matrix, optionally the right-hand side, optionally the exact solution
    (then the report's Linf is taken against it, the manufactured-solution
    check of ``main_ksp.cpp:120-121``; else it is -1).  A file with no rhs
    gets b = ones, ex10's fallback.  The matrix goes through
    ``KSP.set_operators`` (the DIA family on ``device``).

    ``solution_out``: after a successful solve, write x to this path in
    PETSc binary format (``-ksp_view_solution binary:<file>``).
    ``mat_reorder`` (``-mat_reorder``): ``KSP``'s "auto" (RCM when the
    file's order occupies more than 192 diagonals), "rcm" or "none"; the
    JAX driver parses the option but leaves ``KSP`` at "auto".

    Phases (``main_ksp.cpp:80-106``): ``t_init`` the file read and the
    upload, split in ``init_breakdown`` ("read", "diagonals", "host_bands",
    "upload"),
    ``t_setup`` ``KSP.setup``, ``t_solve`` a warm second solve.  Every
    timer read follows a device synchronize.
    """
    # the KSP object runs on this module's solve functions: imported here
    from tpusparse_torch.ksp import KSP

    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.zeros((), dtype=torch.float32, device=device)  # bring-up, outside the phases
    _sync(device)

    t0 = time.perf_counter()
    with annotate("tpusparse:init"):
        exact = None
        if path.endswith((".mtx", ".mtx.gz", ".mm")):
            a, rhs = load_matrix(path)
        else:
            objs = read_petsc_objects(path)
            a = next((o for o in objs if isinstance(o, HostCSR)), None)
            if a is None:
                raise ValueError(f"no matrix object in {path}")
            vecs = [o for o in objs if not isinstance(o, HostCSR)]
            rhs = vecs[0] if vecs else None
            exact = vecs[1] if len(vecs) > 1 else None
        if a.shape[0] != a.shape[1]:
            raise ValueError(f"matrix is {a.shape[0]} x {a.shape[1]}, not square")
        if rhs is not None and rhs.size != a.shape[0]:
            raise ValueError(f"rhs length {rhs.size} != rows {a.shape[0]}")
        b_host = np.ones(a.shape[0]) if rhs is None else rhs
        init = {"read": time.perf_counter() - t0}

        solver = KSP(
            ksp_type=ksp, pc_type=pc, rtol=rtol, atol=atol, divtol=divtol, maxiter=maxiter,
            precision=precision, amg_params=amg_params, mg_cycle=mg_cycle,
            gmres_restart=ksp_gmres_restart, richardson_scale=ksp_richardson_scale,
            mat_reorder=mat_reorder,
        )
        solver.set_operators(a, device=device, timings=init)
        b = torch.as_tensor(b_host, dtype=torch.float32 if precision == "f32" else torch.float64, device=device)
        _sync(device)
    t_init = time.perf_counter() - t0

    t0 = time.perf_counter()
    with annotate("tpusparse:setup"):
        solver.setup()
    _sync(device)
    t_setup = time.perf_counter() - t0

    solver.solve(b)  # first-call costs, outside the timed solve
    _sync(device)
    t0 = time.perf_counter()
    with annotate("tpusparse:solve"):
        res = solver.solve(b)
    _sync(device)
    t_solve = time.perf_counter() - t0
    if res.reason < 0:
        raise DivergedError(f"Diverged reason: {res.reason}")

    if solution_out:
        save_petsc_vec(solution_out, res.x.cpu().numpy().astype(np.float64))
    view_text = None
    if view:
        view_text = "\n".join([
            f"KSP Object: type {ksp}, rtol {rtol:g}, atol {atol:g}, maxit {maxiter}",
            f"  precision: {precision}, mat_type: aij (loaded from {path})",
            hierarchy_summary(solver._pc_state) if pc == "gamg" else f"PC Object: type {pc}",
        ])
    linf = (
        (res.x - torch.as_tensor(exact, dtype=res.x.dtype, device=device)).abs().max().item()
        if exact is not None else -1.0
    )
    return SolveReport(
        nx=a.shape[0], ny=a.shape[1], nz=1,
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
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        precision=precision,
        outer_iters=res.outer_iters,
        mat_type="aij",
        solver_view=view_text,
        source=path,
        source_is_file=True,
        init_breakdown=init,
    )

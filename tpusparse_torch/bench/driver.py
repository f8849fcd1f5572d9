"""The solve driver — port of the mixed-precision CG + GAMG branches of
``tpusparse/bench/driver.py``.

Reproduces the protocol of the reference's ``src/main_ksp.cpp``: build
the manufactured Poisson system, set up CG + AMG, solve, fail on
divergence, compute the Linf error against the analytic solution, and
report the phase triple ``[init, create solver, solve]`` in the reference's
text format (``src/main_ksp.cpp:124-129``) plus a JSON sidecar.

Two routes, both f32 CG preconditioned by a GAMG V-cycle (point-Jacobi
Chebyshev(2)) under f64 defect correction, on one device, with a
convergence check every iteration — the defaults the JAX driver runs with:

- ``mat_type="stencil"``: the 7-point stencil operator on the
  padded-resident layout, the fused fine level and the fused ``<p, Ap>``
  (``PaddedStar.mv_dot``); kernels K1-K4.
- ``mat_type="aij"``: the structure-blind general-matrix route
  (``_solve_poisson_aij`` with ``structure_detect=False`` in the JAX
  driver).  The system is a 7-band DIA (f32 ``DIA`` for the inner solves, two-float
  ``DFDIA`` for the outer residual), the hierarchy the device-resident
  geometric GAMG (``amg/geo.py``), and the V-cycle the plain one over flat
  DIA levels; every f32 level apply is kernel K5.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time

import torch

from tpusparse_torch.amg.fused_cycle import vcycle_fused_dots
from tpusparse_torch.amg.hierarchy import AMGParams, cast_coarse_coefs, gamg_setup, vcycle
from tpusparse_torch.amg.unstructured import gamg_setup_unstructured
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_dia_device, poisson_stencil_device
from tpusparse_torch.solve.cg import ConvergedReason
from tpusparse_torch.solve.refine import cg_refined
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


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work before a timer read."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_system(n: int, device):
    """The manufactured system on the ``n``^3 grid: the f64 outer operator,
    ``b``, the exact solution, and the padded f32 operator of the inner
    solves (also the AMG's home dtype)."""
    grid = Grid3D(n, n, n)
    op, b, exact = poisson_stencil_device(grid, dtype=torch.float64, device=device)
    op_lo = PaddedStar.from_star(
        poisson_stencil_device(grid, dtype=torch.float32, device=device)[0]
    )
    return op, b, exact, op_lo


def refined_solve(op, op_lo, pc_state, b, *, rtol: float, atol: float):
    """f64 defect correction around f32 CG preconditioned by the fused
    V-cycle, with the fused ``<p, Ap>``."""
    return cg_refined(
        op.mv, op_lo.mv, b, rtol=rtol, atol=atol,
        m_lo_mv_dots=lambda r: vcycle_fused_dots(pc_state, r),
        a_lo_mv_dot=op_lo.mv_dot,
        encode=pad_field, decode=functools.partial(crop_field, shape=tuple(b.shape)),
    )


def build_system_aij(n: int, device):
    """The manufactured system on the ``n``^3 grid as a general matrix,
    assembled on ``device`` (``poisson_dia_device``): ``(op_hi, op_lo, b,
    exact)``, flat.  ``op_lo`` is the f32 ``DIA`` of the inner solves and
    the hierarchy's fine level; ``op_hi`` the two-float ``DFDIA`` outer
    operator aliasing its bands; ``b``/``exact`` f64."""
    return poisson_dia_device(Grid3D(n, n, n), device=device)


def refined_solve_aij(op_hi, pc_state, b, *, rtol: float, atol: float):
    """f64 defect correction around f32 CG preconditioned by the plain
    V-cycle over the DIA levels, on flat vectors.  The inner operator is
    the hierarchy's fine level, as in the JAX driver."""
    return cg_refined(
        op_hi.mv, pc_state.levels[0].op.mv, b, rtol=rtol, atol=atol,
        m_lo_mv=lambda r: vcycle(pc_state, r),
    )


def solve_poisson(
    n: int,
    *,
    device,
    rtol: float = 1e-14,
    atol: float = 1e-12,
    pc: str = "gamg",
    warmup: bool = True,
    mat_type: str = "stencil",
) -> SolveReport:
    """End-to-end solve on the ``n``^3 grid with the reference's defaults
    (tolerances: configs/PETSc_SolverOptions_GAMG.info:1-4, AMG options:
    ``AMGParams()``) on ``device``.

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
    device = torch.device(device)
    params = AMGParams()
    # the transfer einsums are f32 products: keep them out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.zeros((), dtype=torch.float32, device=device)  # bring-up, outside the phases
    _sync(device)

    t0 = time.perf_counter()
    if mat_type == "stencil":
        op, b, exact, op_lo = build_system(n, device)

        def setup():
            # bf16 coarse coefficient stacks: vectors stay f32
            return cast_coarse_coefs(gamg_setup(op_lo, params))

        def solve():
            return refined_solve(op, op_lo, pc_state, b, rtol=rtol, atol=atol)
    else:
        op, op_lo, b, exact = build_system_aij(n, device)

        def setup():
            return gamg_setup_unstructured(op_lo, params)

        def solve():
            return refined_solve_aij(op, pc_state, b, rtol=rtol, atol=atol)
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

    if res.reason < 0:
        raise DivergedError(f"Diverged reason: {res.reason}")
    linf = (res.x - exact).abs().max().item()
    return SolveReport(
        nx=n, ny=n, nz=n,
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
    )

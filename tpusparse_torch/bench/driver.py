"""The headline solve driver — port of the structured mixed-precision GAMG
branch of ``tpusparse/bench/driver.py``.

Reproduces the protocol of the reference's ``src/main_ksp.cpp``: build
the manufactured Poisson system, set up CG + AMG, solve, fail on
divergence, compute the Linf error against the analytic solution, and
report the phase triple ``[init, create solver, solve]`` in the reference's
text format (``src/main_ksp.cpp:124-129``) plus a JSON sidecar.

The route is fixed: the 7-point stencil operator, f32 CG preconditioned by
the fused-fine-level GAMG V-cycle (point-Jacobi Chebyshev(2)) on the
padded-resident layout, under f64 defect correction, on one device, with
the fused ``<p, Ap>`` (``PaddedStar.mv_dot``) and a convergence check every
iteration — the defaults the JAX driver runs with.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time

import torch

from tpusparse_torch.amg.fused_cycle import vcycle_fused_dots
from tpusparse_torch.amg.hierarchy import AMGParams, cast_coarse_coefs, gamg_setup
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil_device
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


def solve_poisson(
    n: int,
    *,
    device,
    rtol: float = 1e-14,
    atol: float = 1e-12,
    pc: str = "gamg",
    warmup: bool = True,
) -> SolveReport:
    """End-to-end solve on the ``n``^3 grid with the reference's defaults
    (tolerances: configs/PETSc_SolverOptions_GAMG.info:1-4, AMG options:
    ``AMGParams()``) on ``device``.

    Phase timing protocol (main_ksp.cpp:80-106): init = system build,
    setup = hierarchy construction, solve = the solve.  The device is
    brought up before the init timer starts; the setup runs once untimed
    before its timed run, and the solve once before its timed run, so
    kernel builds and first-call costs stay out of ``t_setup`` and
    ``t_solve``.  Every timer read follows a device synchronize.
    """
    if pc != "gamg":
        raise NotImplementedError(f"pc={pc!r}: only gamg is ported to tpusparse_torch")
    device = torch.device(device)
    params = AMGParams()
    # the transfer einsums are f32 products: keep them out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.zeros((), dtype=torch.float32, device=device)  # bring-up, outside the phases
    _sync(device)

    t0 = time.perf_counter()
    op, b, exact, op_lo = build_system(n, device)
    _sync(device)
    t_init = time.perf_counter() - t0

    if warmup:
        gamg_setup(op_lo, params)
        _sync(device)
    t0 = time.perf_counter()
    # bf16 coarse coefficient stacks: vectors stay f32
    pc_state = cast_coarse_coefs(gamg_setup(op_lo, params))
    _sync(device)
    t_setup = time.perf_counter() - t0

    def solve():
        return refined_solve(op, op_lo, pc_state, b, rtol=rtol, atol=atol)

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
    )

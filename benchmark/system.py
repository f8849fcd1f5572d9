"""The system under test: ``tpusparse_torch``'s ``KSP`` on a configuration's
operator, built on the device.

A configuration file gives ``grid`` (nx, ny, nz), ``extent``, ``pin``,
``route`` ("stencil": the structured ``StarStencil3D``, the DMDA route;
"aij": the system assembled as a general banded matrix, the MATAIJ route
with no structure proof), ``precision`` and the ``KSP`` options under
``ksp`` (``ksp_type``, ``pc_type``, ``rtol``, ``atol``, ``maxiter``,
``layout``) and ``gamg`` (``AMGParams``'s fields).

Under mixed precision the stencil route hands ``KSP`` the float64 star and
its float32 twin, as ``solve_poisson`` builds them, and ``KSP`` takes the
padded-resident fused route; the aij route hands it the two-float
``DFDIA`` and the float32 ``DIA`` it aliases (``poisson_dia_device``),
and ``KSP`` builds GAMG over the DIA family as ``solve_poisson(mat_type=
"aij", structure_detect=False)`` does.  Under uniform precision the one
operator is built in that precision.
"""

from __future__ import annotations

import dataclasses

import torch

from tpusparse_torch import KSP, Grid3D
from tpusparse_torch.amg.hierarchy import AMGParams
from tpusparse_torch.grid.poisson import poisson_dia_device, poisson_stencil_device

DTYPES = {"mixed": torch.float64, "f64": torch.float64, "f32": torch.float32}


@dataclasses.dataclass
class System:
    ksp: KSP
    shape: tuple[int, int, int]  # (nz, ny, nx)
    flat: bool                   # the route takes flat vectors
    dtype: torch.dtype           # of b and x

    def encode(self, b: torch.Tensor) -> torch.Tensor:
        """A float64 (nz, ny, nx) right-hand side in the form ``solve`` takes."""
        b = b.to(self.dtype)
        return b.reshape(-1) if self.flat else b

    def describe(self) -> str:
        """One line on the route the solves take (for the log)."""
        hier = getattr(self.ksp, "_pc_state", None)
        levels = getattr(hier, "levels", ())
        parts = [f"{type(lev.op).__name__}{tuple(lev.dinv.shape)}" for lev in levels]
        return (f"KSP {self.ksp.ksp_type}/{self.ksp.pc_type} precision {self.ksp.precision}, outer"
                f" {type(self.ksp._op).__name__}, inner {type(self.ksp._op_lo).__name__},"
                f" {len(parts)} levels: {' '.join(parts)}")


def grid_of(config: dict) -> Grid3D:
    nx, ny, nz = config["grid"]
    lx, ly, lz = config.get("extent", (1.0, 1.0, 1.0))
    return Grid3D(nx, ny, nz, lx=lx, ly=ly, lz=lz)


def build(config: dict, device, precision: str | None = None) -> System:
    """``KSP`` with its operator set and its preconditioner built
    (``KSPSetOperators`` + ``KSPSetUp``) for ``config`` on ``device``;
    ``precision`` overrides the configuration's."""
    precision = precision or config["precision"]
    opts = config["ksp"]
    ksp = KSP(
        ksp_type=opts["ksp_type"], pc_type=opts["pc_type"], rtol=opts["rtol"], atol=opts["atol"],
        maxiter=opts["maxiter"], precision=precision, amg_params=AMGParams(**config["gamg"]),
        layout=opts["layout"] if precision == "mixed" else "auto",
    )
    grid = grid_of(config)
    pin = bool(config["pin"])
    dtype = DTYPES[precision]
    if config["route"] == "stencil":
        op = poisson_stencil_device(grid, pin, dtype, device=device)[0]
        op_lo = poisson_stencil_device(grid, pin, torch.float32, device=device)[0] if precision == "mixed" else None
        ksp.set_operators(op, op_lo, device=device)
        flat = False
    elif config["route"] == "aij":
        if precision == "f64":
            raise ValueError("the aij route is built on the device under mixed or f32 precision only")
        op_hi, op_lo, _, _ = poisson_dia_device(grid, pin, device=device)
        ksp.set_operators(*((op_hi, op_lo) if precision == "mixed" else (op_lo,)), device=device)
        flat = True
    else:
        raise ValueError(f"unknown route {config['route']!r}")
    ksp.setup()
    return System(ksp=ksp, shape=grid.shape, flat=flat, dtype=dtype)

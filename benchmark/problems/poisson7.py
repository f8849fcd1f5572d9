"""olcf/PETSC-OpenACC's ``main_ksp`` problem: the pinned cell-centred
7-point Poisson operator (``reference/poisson7.py`` states it).

A configuration gives ``grid`` (nx, ny, nz), ``extent``, ``pin``,
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

import torch

from benchmark.reference.poisson7 import Poisson7
from benchmark.system import DTYPES, System, grid_of, new_ksp
from tpusparse_torch.grid.poisson import poisson_dia_device, poisson_stencil_device


def build(config: dict, device, precision: str | None = None) -> System:
    precision = precision or config["precision"]
    ksp = new_ksp(config, precision)
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


def reference(config: dict) -> Poisson7:
    nx, ny, nz = config["grid"]
    return Poisson7((nz, ny, nx), config.get("extent", (1.0, 1.0, 1.0)), pin=bool(config["pin"]))

"""HPCG 3.1's problem (``src/GenerateProblem_ref.cpp``): the 27-point
operator with 26 on the diagonal and -1 to each box neighbour inside the
grid (``reference/hpcg27.py`` states it), symmetric positive definite
with no pin.

A configuration gives ``grid`` (nx, ny, nz), ``precision`` and the ``KSP``
options under ``ksp`` and ``gamg`` (``AMGParams``' fields).  The operator
is ``grid/hpcg.py::hpcg_stencil``, a ``VarStencil27`` built on the
device: ``KSP`` takes it as a 27-point fine level, GAMG's plain cycle over
the probed Galerkin hierarchy.  Under mixed precision ``KSP`` gets the
float64 operator and its float32 twin, under uniform precision the one
operator in that precision.
"""

from __future__ import annotations

import torch

from benchmark.reference.hpcg27 import HPCG27
from benchmark.system import DTYPES, System, grid_of, new_ksp
from tpusparse_torch.grid.hpcg import hpcg_stencil


def build(config: dict, device, precision: str | None = None) -> System:
    precision = precision or config["precision"]
    ksp = new_ksp(config, precision)
    grid = grid_of(config)
    dtype = DTYPES[precision]
    op = hpcg_stencil(grid, dtype, device)
    op_lo = hpcg_stencil(grid, torch.float32, device) if precision == "mixed" else None
    ksp.set_operators(op, op_lo, device=device)
    ksp.setup()
    return System(ksp=ksp, shape=grid.shape, flat=False, dtype=dtype)


def reference(config: dict) -> HPCG27:
    nx, ny, nz = config["grid"]
    return HPCG27((nz, ny, nx))

"""HPCG's operator as a ``VarStencil27``, built on the device.

HPCG 3.1 (https://www.hpcg-benchmark.org, ``src/GenerateProblem_ref.cpp``)
generates, on an nx x ny x nz grid, one row a point with 26 on the
diagonal and -1 for each of its up to 26 box neighbours that lie inside
the grid.  Nothing couples past the grid's faces, so a boundary row is
strictly diagonally dominant and the matrix is symmetric positive definite
with no pin.  Its 27 couplings are the 27 offsets of a ``VarStencil27``,
so the operator takes the route of a 27-point fine level: GAMG's plain
cycle over the probed Galerkin hierarchy (``ksp.py``).
"""

from __future__ import annotations

import torch

from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.sparse.varstencil import CENTER, OFFSETS, VarStencil27


def hpcg_stencil(grid: Grid3D, dtype: torch.dtype = torch.float64, device="cuda") -> VarStencil27:
    """HPCG's matrix on ``grid`` as a (27, nz, ny, nx) stack on ``device``:
    26 in the centre plane; in each other plane o, -1 where p + o lies
    inside the grid and 0 where it does not.  Made on the device plane by
    plane, with no host array of the grid's size."""
    coef = torch.full((27, *grid.shape), -1.0, dtype=dtype, device=device)
    coef[CENTER].fill_(26.0)
    for o, off in enumerate(OFFSETS):
        for axis, d in enumerate(off):
            if d:
                # the face whose neighbour in direction d lies past the grid
                coef[o].narrow(axis, 0 if d < 0 else grid.shape[axis] - 1, 1).zero_()
    return VarStencil27(coef=coef)

"""Manufactured 3D Poisson problem — port of ``tpusparse/grid/poisson.py``.

Problem (reference ``src/main_ksp.cpp:1-20``, ``src/helper.cpp:14-18``):

    lap u = -12 pi^2 cos(2 pi x) cos(2 pi y) cos(2 pi z)   on [0,1]^3
    exact u = cos(2 pi x) cos(2 pi y) cos(2 pi z)

discretized with a cell-centered 7-point star, all-Neumann boundaries
realized by dropping out-of-domain entries (``src/helper.cpp:229-233``), and
the singular system pinned at cell 0 (``MatZeroRowsColumns`` parity,
``src/helper.cpp:250-279``).  The operator is symmetric negative definite,
exactly as the reference assembles it.

``poisson_stencil_device`` is the main path: every field is computed with
torch ops on ``device``.  ``exact_field``/``rhs_field``/``poisson_stencil``
are the host (numpy) oracles the tests compare against.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.sparse.stencil import StarStencil3D

# constants from reference src/helper.cpp:17-18
C1 = 2.0 * np.pi
C2 = -3.0 * C1 * C1


def _as_dtype(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (the value a 0-d array of that dtype holds)."""
    return torch.tensor(v, dtype=dtype, device="cpu").item()


def exact_field(grid: Grid3D, dtype=np.float64) -> np.ndarray:
    """u(x,y,z) = cos(2 pi x) cos(2 pi y) cos(2 pi z) at cell centers.

    Parity: ``generateExt`` (src/helper.cpp:120-157). Shape (nz, ny, nx).
    """
    cx = np.cos(C1 * grid.cell_centers("x", dtype)).astype(dtype)
    cy = np.cos(C1 * grid.cell_centers("y", dtype)).astype(dtype)
    cz = np.cos(C1 * grid.cell_centers("z", dtype)).astype(dtype)
    return cz[:, None, None] * cy[None, :, None] * cx[None, None, :]


def rhs_field(grid: Grid3D, dtype=np.float64) -> np.ndarray:
    """f = -12 pi^2 * exact. Parity: ``generateRHS`` (src/helper.cpp:78-116)."""
    return dtype(C2) * exact_field(grid, dtype)


def poisson_stencil_device(
    grid: Grid3D, pin: bool = True, dtype: torch.dtype = torch.float64, *,
    device,
):
    """The operator as a ``StarStencil3D`` plus ``(b, exact)`` fields, all
    computed on ``device`` in ``dtype`` — no host assembly, no transfer.

    Same arithmetic, in the same order, as the JAX version: the pinned
    diagonal ``scale`` (the mean of the unpinned diagonal) and the three
    right-hand-side corrections of the pin come in closed form.  Values
    agree with the host oracle ``poisson_stencil`` to 1-2 ulp (libm vs
    torch cos).
    """
    dt = dtype
    nz, ny, nx = grid.shape
    ax = 1.0 / (grid.dx * grid.dx)
    ay = 1.0 / (grid.dy * grid.dy)
    az = 1.0 / (grid.dz * grid.dz)

    def centers(n, h):
        return C1 * (torch.arange(n, dtype=dt, device=device) + 0.5) * h

    cxs = torch.cos(centers(nx, grid.dx))
    cys = torch.cos(centers(ny, grid.dy))
    czs = torch.cos(centers(nz, grid.dz))
    exact = czs[:, None, None] * cys[None, :, None] * cxs[None, None, :]
    b = C2 * exact

    k = torch.arange(nz, dtype=torch.int64, device=device)[:, None, None]
    j = torch.arange(ny, dtype=torch.int64, device=device)[None, :, None]
    i = torch.arange(nx, dtype=torch.int64, device=device)[None, None, :]
    diag = -(
        ax * ((i > 0).to(dt) + (i < nx - 1).to(dt))
        + ay * ((j > 0).to(dt) + (j < ny - 1).to(dt))
        + az * ((k > 0).to(dt) + (k < nz - 1).to(dt))
    )
    if pin:
        # mean of the diagonal, closed form (each interior face pair
        # contributes -coef to two rows)
        sum_diag = -2.0 * (
            ax * (nx - 1) * ny * nz
            + ay * (ny - 1) * nx * nz
            + az * (nz - 1) * nx * ny
        )
        scale = torch.tensor(sum_diag / grid.n, dtype=dt, device=device)
        e0 = exact[0, 0, 0]
        if nx > 1:
            b[0, 0, 1] += -ax * e0
        if ny > 1:
            b[0, 1, 0] += -ay * e0
        if nz > 1:
            b[1, 0, 0] += -az * e0
        diag[0, 0, 0] = scale
        b[0, 0, 0] = scale * e0
    op = StarStencil3D(
        diag=diag,
        cx=_as_dtype(ax, dt), cy=_as_dtype(ay, dt), cz=_as_dtype(az, dt),
        pinned=bool(pin),
    )
    return op, b, exact


def poisson_stencil(
    grid: Grid3D, pin: bool = True, dtype=np.float64, *, device,
):
    """Host-assembled oracle of ``poisson_stencil_device``: numpy fields
    built the way ``assemble_poisson`` (src/helper.cpp:161-279) builds the
    matrix, then moved to ``device``."""
    nz, ny, nx = grid.shape
    ax = dtype(1.0 / (grid.dx * grid.dx))
    ay = dtype(1.0 / (grid.dy * grid.dy))
    az = dtype(1.0 / (grid.dz * grid.dz))
    k = np.arange(nz)[:, None, None]
    j = np.arange(ny)[None, :, None]
    i = np.arange(nx)[None, None, :]
    diag = np.zeros(grid.shape, dtype=dtype)
    # neighbor order k-1, j-1, i-1, i+1, j+1, k+1 (PETSc's sorted columns)
    for valid, coef in (
        (k > 0, az), (j > 0, ay), (i > 0, ax),
        (i < nx - 1, ax), (j < ny - 1, ay), (k < nz - 1, az),
    ):
        diag -= np.where(valid, coef, dtype(0))

    exact = exact_field(grid, dtype)
    b = rhs_field(grid, dtype).copy()
    scale = dtype(diag.sum() / grid.n)
    if pin:
        e0 = exact[0, 0, 0]
        # neighbors of cell 0 lose their column-0 entry; move it to the RHS
        if nx > 1:
            b[0, 0, 1] -= ax * e0
        if ny > 1:
            b[0, 1, 0] -= ay * e0
        if nz > 1:
            b[1, 0, 0] -= az * e0
        diag[0, 0, 0] = scale
        b[0, 0, 0] = scale * e0

    def put(a):
        return torch.as_tensor(a, device=device)

    op = StarStencil3D(
        diag=put(diag), cx=float(ax), cy=float(ay), cz=float(az),
        pinned=bool(pin),
    )
    return op, put(b), put(exact)

"""Structured 3D cell-centered grid — the TPU-native analogue of PETSc DMDA.

Parity target: ``DMDACreate3d`` with ``DM_BOUNDARY_GHOSTED`` boundaries and a
star stencil of width 1 (reference ``src/helper.cpp:31-36``).  DMDA's natural
ordering is x-fastest: ``idx = (k*ny + j)*nx + i``; we store fields as C-order
``(nz, ny, nx)`` arrays, whose flattening reproduces exactly that ordering, so
vectors round-trip between the 3D "field" view (used by stencil operators) and
the 1D "vector" view (used by CSR/ELL operators) with a plain reshape.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """A global Nx x Ny x Nz cell-centered grid over [0,Lx]x[0,Ly]x[0,Lz].

    Cell centers sit at ``(i + 0.5) * dx`` (reference ``src/helper.cpp:104-110``).
    """

    nx: int
    ny: int
    nz: int
    lx: float = 1.0
    ly: float = 1.0
    lz: float = 1.0

    def __post_init__(self):
        if min(self.nx, self.ny, self.nz) < 1:
            raise ValueError(f"grid dims must be >= 1, got {(self.nx, self.ny, self.nz)}")

    # --- sizes -----------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int, int]:
        """Field array shape, z-slowest: (nz, ny, nx)."""
        return (self.nz, self.ny, self.nx)

    @property
    def n(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def dx(self) -> float:
        return self.lx / self.nx

    @property
    def dy(self) -> float:
        return self.ly / self.ny

    @property
    def dz(self) -> float:
        return self.lz / self.nz

    # --- index algebra (DMDA local-to-global equivalent) ------------------
    def ravel_index(self, i, j, k):
        """Natural-ordering flat index of cell (i, j, k); x fastest."""
        return (np.asarray(k) * self.ny + np.asarray(j)) * self.nx + np.asarray(i)

    def cell_centers(self, axis: str, dtype=np.float64) -> np.ndarray:
        """1D array of cell-center coordinates along 'x' | 'y' | 'z'."""
        n, d = {
            "x": (self.nx, self.dx),
            "y": (self.ny, self.dy),
            "z": (self.nz, self.dz),
        }[axis]
        return (np.arange(n, dtype=dtype) + dtype(0.5)) * dtype(d)

    def coarsen(self, factor: int = 3) -> "Grid3D":
        """Geometric coarse grid with ceil(n/factor) cells per axis."""
        cdiv = lambda a, b: -(-a // b)
        return Grid3D(
            nx=cdiv(self.nx, factor),
            ny=cdiv(self.ny, factor),
            nz=cdiv(self.nz, factor),
            lx=self.lx, ly=self.ly, lz=self.lz,
        )

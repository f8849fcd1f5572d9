"""The plain reference of the manufactured Poisson operator, and the check
of a solution against it.

The problem is olcf/PETSC-OpenACC's ``main_ksp``: the cell-centred
7-point Laplacian on an (nz, ny, nx) grid over a box of edges (lx, ly,
lz), with coefficient 1/h^2 an axis, Neumann boundaries by dropping the
couplings that leave the box (``src/helper.cpp:229-233``), and the
singular system pinned at cell 0 as ``MatZeroRowsColumns`` pins it
(``src/helper.cpp:250-279``): row 0 and column 0 lose their couplings and
row 0's diagonal becomes the mean of the unpinned diagonal.

Written from that statement in float64 torch, block by block of
z-planes so that a 720^3 check fits beside what the run holds.  It takes
nothing from the program: the grid and the pin come from the
configuration, the right-hand side from the benchmark's generator, and
the solution under judgement is only read.
"""

from __future__ import annotations

import torch


class Poisson7:
    """The pinned 7-point operator A of the configuration's grid."""

    def __init__(self, shape: tuple[int, int, int], extent=(1.0, 1.0, 1.0), pin: bool = True):
        self.shape = tuple(int(n) for n in shape)
        nz, ny, nx = self.shape
        lx, ly, lz = (float(e) for e in extent)
        self.ax = (nx / lx) ** 2
        self.ay = (ny / ly) ** 2
        self.az = (nz / lz) ** 2
        self.pin = pin
        # the mean of the unpinned diagonal: each interior face takes -a
        # from the two cells it joins
        n = nx * ny * nz
        self.pin_diagonal = -2.0 * (
            self.ax * (nx - 1) * ny * nz + self.ay * (ny - 1) * nx * nz + self.az * (nz - 1) * nx * ny
        ) / n

    def apply(self, x: torch.Tensor, z0: int, z1: int) -> torch.Tensor:
        """Rows of planes [z0, z1) of A x, for the float64 field ``x``."""
        nz, ny, nx = self.shape
        xs = x[z0:z1]
        y = torch.zeros_like(xs)
        for a, axis, n in ((self.ax, 2, nx), (self.ay, 1, ny)):
            if n > 1:
                d = xs.narrow(axis, 1, n - 1) - xs.narrow(axis, 0, n - 1)  # x[i+1] - x[i]
                y.narrow(axis, 0, n - 1).add_(d, alpha=a)    # row i:   a (x[i+1] - x[i])
                y.narrow(axis, 1, n - 1).add_(d, alpha=-a)   # row i+1: a (x[i] - x[i+1])
        if nz > 1:
            below = x[z0 - 1:z1 - 1] if z0 > 0 else torch.cat([xs[:1], x[z0:z1 - 1]])
            above = x[z0 + 1:z1 + 1] if z1 < nz else torch.cat([x[z0 + 1:z1], xs[-1:]])
            # a missing neighbour is replaced by the cell itself: no coupling
            y.add_(below - xs, alpha=self.az).add_(above - xs, alpha=self.az)
        if self.pin:
            x0 = x[0, 0, 0]
            # column 0 leaves the rows of cell 0's neighbours, row 0 its own
            for (k, j, i), a in (((0, 0, 1), self.ax), ((0, 1, 0), self.ay), ((1, 0, 0), self.az)):
                if k < nz and j < ny and i < nx and z0 <= k < z1:
                    y[k - z0, j, i] -= a * x0
            if z0 == 0:
                y[0, 0, 0] = self.pin_diagonal * x0
        return y

    def residual(self, x: torch.Tensor, b: torch.Tensor, block: int = 32) -> tuple[float, float]:
        """(||b - A x||_2, ||b||_2) in float64, ``x`` and ``b`` (nz, ny, nx)
        fields or flat vectors in the grid's order."""
        x = x.reshape(self.shape).to(torch.float64)
        b = b.reshape(self.shape).to(torch.float64)
        rr = bb = 0.0
        for z0 in range(0, self.shape[0], block):
            z1 = min(z0 + block, self.shape[0])
            r = b[z0:z1] - self.apply(x, z0, z1)
            rr += float(torch.sum(r * r))
            bb += float(torch.sum(b[z0:z1] * b[z0:z1]))
        return rr ** 0.5, bb ** 0.5

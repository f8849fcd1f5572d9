"""The plain reference of HPCG's operator, and the check of a solution
against it.

The problem is HPCG 3.1's (https://www.hpcg-benchmark.org,
``src/GenerateProblem_ref.cpp``): on an (nz, ny, nx) grid, the row of
point p has 26 on the diagonal and -1 for each of p's 26 box neighbours
that lie inside the grid; nothing couples past the grid's faces, and no
point is pinned.  So (A x)[p] = 26 x[p] - (the sum of x over p's
neighbours in the grid).

Written from that statement in float64 torch: the sum over the 3 x 3 x 3
box is taken axis by axis (x, then y, then z), each a shifted add that
leaves out what lies past the grid, block by block of z-planes so that a
432^3 check fits beside what the run holds.  It takes nothing from the
program: the grid comes from the configuration, the right-hand side from
the benchmark's generator, and the solution under judgement is only read.
"""

from __future__ import annotations

import torch


def _neighbour_sum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x plus its two neighbours along ``axis``, those past the ends left
    out."""
    n = x.shape[axis]
    s = x.clone()
    if n > 1:
        s.narrow(axis, 1, n - 1).add_(x.narrow(axis, 0, n - 1))
        s.narrow(axis, 0, n - 1).add_(x.narrow(axis, 1, n - 1))
    return s


class HPCG27:
    """HPCG's 27-point operator A on an (nz, ny, nx) grid."""

    def __init__(self, shape: tuple[int, int, int]):
        self.shape = tuple(int(n) for n in shape)

    def apply(self, x: torch.Tensor, z0: int, z1: int) -> torch.Tensor:
        """Rows of planes [z0, z1) of A x, for the float64 field ``x``."""
        lo, hi = max(z0 - 1, 0), min(z1 + 1, self.shape[0])
        box = x[lo:hi]
        for axis in (2, 1, 0):
            box = _neighbour_sum(box, axis)
        box = box[z0 - lo:z1 - lo]  # the planes whose neighbours are all in the slab
        centre = x[z0:z1]
        return 26.0 * centre - (box - centre)

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

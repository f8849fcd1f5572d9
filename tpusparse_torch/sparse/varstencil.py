"""Variable-coefficient 27-point stencil operator — port of
``tpusparse/sparse/varstencil.py``: the coarse-level Galerkin operators of
the structured AMG.

With geometric 3x3x3 aggregation and a once-smoothed prolongator every
coarse operator couples only the 27 immediate neighbours, so its action is
``sum_o coef[o] * x_shifted_by_o`` — shifted multiply-adds, no column
indices.  The apply is ``kernels/varstencil27.py``: one launch on the
card, its plain twin on the CPU.  Fields may carry leading axes (a stack
of k right-hand sides, ``KSP.mat_solve``): the shifts act on the last
three.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the offsets and the shifts live beside the kernel's twin, which sums them
from tpusparse_torch.kernels.varstencil27 import (  # noqa: F401
    CENTER,
    OFFSETS,
    pad1,
    shifted_view,
    varstencil27_mv,
)


def shift3(x: torch.Tensor, off: tuple[int, int, int]) -> torch.Tensor:
    """out[..., p] = x[..., p + off] with zero fill."""
    if all(d == 0 for d in off):
        return x
    return shifted_view(pad1(x), off, tuple(x.shape[-3:]))


@dataclasses.dataclass
class VarStencil27:
    """y[p] = sum_o coef[o][p] * x[p + o], offsets o in OFFSETS order.

    ``coef`` has shape (27, nz, ny, nx).  Coefficients whose target p + o
    lies outside the grid are never read.  After ``cast_coarse_coefs`` the
    stack is bf16 while vectors stay f32: bf16 * f32 promotes to f32, as in
    JAX, so only the coefficient bytes shrink.
    """

    coef: torch.Tensor  # (27, nz, ny, nx)

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return tuple(self.coef.shape[1:])

    @property
    def shape(self) -> tuple[int, int]:
        n = int(np.prod(self.grid_shape))
        return (n, n)

    @property
    def dtype(self) -> torch.dtype:
        return self.coef.dtype

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x on the 3D field view, or on each field of a stack with
        leading axes (same accumulation order as JAX), in one launch on the
        card: ``varstencil27_mv``."""
        return varstencil27_mv(self.coef, x)

    def mv_flat(self, x: torch.Tensor) -> torch.Tensor:
        return self.mv(x.reshape(self.grid_shape)).reshape(-1)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.mv(x) if x.dim() == 3 else self.mv_flat(x)

    def diagonal_field(self) -> torch.Tensor:
        return self.coef[CENTER]

    def _index(self):
        nz, ny, nx = self.grid_shape
        dev = self.coef.device
        return (
            torch.arange(nz, device=dev)[:, None, None],
            torch.arange(ny, device=dev)[None, :, None],
            torch.arange(nx, device=dev)[None, None, :],
        )

    def gs_color_masks(self) -> list:
        """2x2x2 octant (8-color) coloring: the 27-point stencil reaches one
        cell per axis, so points sharing (k%2, j%2, i%2) are independent —
        each masked simultaneous update is a Gauss-Seidel ordering."""
        k, j, i = self._index()
        c = (k % 2) * 4 + (j % 2) * 2 + (i % 2)
        return [c == q for q in range(8)]

    def flat_band_fields(self, max_abs_offset: int) -> dict:
        """{flat offset o: field f with f[p] = A[p, p+o]} for every offset
        with 0 < |flat o| < ``max_abs_offset``.  Coefficients whose target
        leaves the grid are masked out; 3-D offsets that alias to one flat
        offset on tiny grids accumulate, as a CSR assembly sums duplicates."""
        nz, ny, nx = self.grid_shape
        k, j, i = self._index()
        zero = torch.zeros((), dtype=self.dtype, device=self.coef.device)
        out: dict = {}
        for o3, (dk, dj, di) in enumerate(OFFSETS):
            if (dk, dj, di) == (0, 0, 0):
                continue
            o = (dk * ny + dj) * nx + di
            if o == 0 or abs(o) >= max_abs_offset:
                continue
            valid = (
                (k + dk >= 0) & (k + dk < nz) & (j + dj >= 0) & (j + dj < ny)
                & (i + di >= 0) & (i + di < nx)
            )
            f = torch.where(valid, self.coef[o3], zero)
            out[o] = out[o] + f if o in out else f
        return out

    @classmethod
    def from_csr(cls, csr, grid_shape: tuple[int, int, int], *, device) -> "VarStencil27":
        """Bin a host CSR matrix on ``grid_shape`` into the 27 offset planes,
        on ``device``.  Raises if an entry lies outside the 27-point
        neighbourhood."""
        nz, ny, nx = grid_shape
        n = nz * ny * nx
        if tuple(csr.shape) != (n, n):
            raise ValueError(f"csr shape {csr.shape} != grid {grid_shape}")
        rows = np.repeat(np.arange(n, dtype=np.int64), csr.row_nnz())
        cols = csr.indices.astype(np.int64)
        d = np.stack([
            cols // (ny * nx) - rows // (ny * nx),
            (cols // nx) % ny - (rows // nx) % ny,
            cols % nx - rows % nx,
        ])
        if np.any(np.abs(d) > 1):
            raise ValueError(f"entries beyond 27-point neighborhood (max |off|={np.abs(d).max()})")
        o = (d[0] + 1) * 9 + (d[1] + 1) * 3 + (d[2] + 1)
        coef = np.zeros((27, n), dtype=csr.data.dtype)
        coef[o, rows] = csr.data
        return cls(coef=torch.as_tensor(coef.reshape(27, nz, ny, nx), device=device))

    def to_csr(self):
        """The matrix as a host ``HostCSR`` (zero coefficients and those
        whose target leaves the grid dropped; bf16 widened to f32), for
        tests and interop."""
        import scipy.sparse as sp

        from tpusparse_torch.sparse.csr import HostCSR

        nz, ny, nx = self.grid_shape
        n = nz * ny * nx
        coef = self.coef.detach().cpu()
        coef = (coef.float() if coef.dtype == torch.bfloat16 else coef).numpy().reshape(27, n)
        k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
        rows, cols, vals = [], [], []
        for o, (dk, dj, di) in enumerate(OFFSETS):
            kk, jj, ii = k + dk, j + dj, i + di
            valid = ((kk >= 0) & (kk < nz) & (jj >= 0) & (jj < ny) & (ii >= 0) & (ii < nx)).reshape(-1)
            keep = valid & (coef[o] != 0)
            rows.append(np.flatnonzero(keep))
            cols.append(((kk * ny + jj) * nx + ii).reshape(-1)[keep])
            vals.append(coef[o][keep])
        m = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n))
        m.sum_duplicates()
        m.sort_indices()
        return HostCSR.from_scipy(m)

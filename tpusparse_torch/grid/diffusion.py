"""Variable-coefficient diffusion problem — port of
``tpusparse/grid/diffusion.py``, the second problem family.

Problem: -div(kappa(x) grad u) = f on [0,1]^3, all-Neumann boundaries
(dropped entries, as in the Poisson assembly), pinned at cell 0.  The
cell-centred finite-volume 7-point scheme takes the harmonic mean of the
two cell kappas on each face, so the operator is a 7-point stencil with
position-dependent couplings: a ``VarStencil27`` with only the 7 star
offsets filled.  Sign convention of the reference's assembly: negative
definite (diag < 0, off-diagonals > 0).

The 7 star planes are computed in numpy exactly as the JAX package
computes them (kappa's noise from ``np.random.default_rng(seed)``, the
f32 operator from kappa cast to f32, the centre plane accumulated axis by
axis, the pinned scale a numpy sum), so both packages hold the same bits;
then they are uploaded into a zeroed (27, nz, ny, nx) tensor on the
device.  The host CSR that JAX always builds is built only on request.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.sparse.varstencil import CENTER, OFFSETS, VarStencil27


def default_kappa(grid: Grid3D, contrast: float = 100.0, seed: int = 0) -> np.ndarray:
    """A standard hard test field: a smoothly varying background times a
    high-contrast checkerboard of inclusions times log-normal noise (f64,
    (nz, ny, nx))."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(
        grid.cell_centers("z"), grid.cell_centers("y"), grid.cell_centers("x"), indexing="ij",
    )
    smooth = np.exp(np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y) * 0.5)
    blocks = ((np.floor(3 * x) + np.floor(3 * y) + np.floor(3 * z)) % 2)
    jump = np.where(blocks > 0, contrast, 1.0)
    noise = np.exp(0.1 * rng.standard_normal(grid.shape))
    return smooth * jump * noise


def _face_kappa(kappa: np.ndarray, axis: int) -> np.ndarray:
    """Harmonic-mean conductivity on the interior faces along ``axis``."""
    lo = np.take(kappa, range(kappa.shape[axis] - 1), axis=axis)
    hi = np.take(kappa, range(1, kappa.shape[axis]), axis=axis)
    return 2.0 * lo * hi / (lo + hi)


def star_planes(grid: Grid3D, kappa: np.ndarray, pin: bool = True, dtype=np.float64) -> dict:
    """{offset index: (nz, ny, nx) plane} for the 7 star offsets of the
    diffusion operator, in ``dtype`` (numpy), JAX's arithmetic."""
    kappa = np.asarray(kappa, dtype)
    if kappa.shape != grid.shape:
        raise ValueError(f"kappa shape {kappa.shape} != grid {grid.shape}")
    inv_h2 = {
        0: dtype(1.0 / (grid.dz * grid.dz)),
        1: dtype(1.0 / (grid.dy * grid.dy)),
        2: dtype(1.0 / (grid.dx * grid.dx)),
    }
    planes = {CENTER: np.zeros(grid.shape, dtype=dtype)}
    center = planes[CENTER]
    for axis, (minus_off, plus_off) in {
        0: ((-1, 0, 0), (1, 0, 0)),
        1: ((0, -1, 0), (0, 1, 0)),
        2: ((0, 0, -1), (0, 0, 1)),
    }.items():
        fk = _face_kappa(kappa, axis) * inv_h2[axis]
        sl_lo = [slice(None)] * 3
        sl_lo[axis] = slice(0, grid.shape[axis] - 1)
        sl_hi = [slice(None)] * 3
        sl_hi[axis] = slice(1, grid.shape[axis])
        plus = planes.setdefault(OFFSETS.index(plus_off), np.zeros(grid.shape, dtype=dtype))
        minus = planes.setdefault(OFFSETS.index(minus_off), np.zeros(grid.shape, dtype=dtype))
        # the +face coupling of the lower cell, the -face one of the upper
        plus[tuple(sl_lo)] = fk
        minus[tuple(sl_hi)] = fk
        # Neumann-dropped entries: the diagonal absorbs only existing faces
        center[tuple(sl_lo)] -= fk
        center[tuple(sl_hi)] -= fk
    if pin:
        scale = dtype(center.sum() / grid.n)
        # column part: cell 0's neighbours lose their entry pointing at it
        for off in ((0, 0, 1), (0, 1, 0), (1, 0, 0)):
            planes[OFFSETS.index(tuple(-d for d in off))][off] = 0.0
        # row part
        for o, plane in planes.items():
            if o != CENTER:
                plane[0, 0, 0] = 0.0
        center[0, 0, 0] = scale
    return planes


def diffusion_stencil(grid: Grid3D, kappa: np.ndarray, pin: bool = True, dtype=np.float64, *,
                      device="cuda") -> VarStencil27:
    """The operator alone, on ``device``: the 7 planes of ``star_planes``
    in a zeroed (27, nz, ny, nx) tensor (what the driver builds)."""
    planes = star_planes(grid, kappa, pin, dtype)
    coef = torch.zeros((27, *grid.shape), dtype=torch.from_numpy(planes[CENTER]).dtype, device=device)
    for o, plane in planes.items():
        coef[o].copy_(torch.from_numpy(plane))
    return VarStencil27(coef=coef)


def assemble_diffusion(
    grid: Grid3D,
    kappa: np.ndarray | Callable | None = None,
    pin: bool = True,
    dtype=np.float64,
    *,
    device="cuda",
):
    """Assemble -div(kappa grad .) as ``(op, a, b)``, the JAX package's
    triple: the ``VarStencil27`` on ``device``, the same matrix as a host
    ``HostCSR`` and the manufactured right-hand side (a (nz, ny, nx)
    tensor on ``device``).  ``kappa``: an array, a function of the grid,
    or None for ``default_kappa(grid)``."""
    if kappa is None:
        kappa = default_kappa(grid)
    elif callable(kappa):
        kappa = kappa(grid)
    op = diffusion_stencil(grid, kappa, pin, dtype, device=device)
    # the manufactured zero-mean source (smooth; no closed-form solution)
    z, y, x = np.meshgrid(
        grid.cell_centers("z", dtype), grid.cell_centers("y", dtype), grid.cell_centers("x", dtype),
        indexing="ij",
    )
    b = np.cos(2 * np.pi * x) * np.cos(2 * np.pi * y) * np.cos(2 * np.pi * z)
    b = (b - b.mean()).astype(dtype)
    if pin:
        b[0, 0, 0] = 0.0
    return op, op.to_csr(), torch.from_numpy(b).to(device)

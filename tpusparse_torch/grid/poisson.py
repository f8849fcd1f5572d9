"""Manufactured 3D Poisson problem — port of ``tpusparse/grid/poisson.py``.

Problem (reference ``src/main_ksp.cpp:1-20``, ``src/helper.cpp:14-18``):

    lap u = -12 pi^2 cos(2 pi x) cos(2 pi y) cos(2 pi z)   on [0,1]^3
    exact u = cos(2 pi x) cos(2 pi y) cos(2 pi z)

discretized with a cell-centered 7-point star, all-Neumann boundaries
realized by dropping out-of-domain entries (``src/helper.cpp:229-233``), and
the singular system pinned at cell 0 (``MatZeroRowsColumns`` parity,
``src/helper.cpp:250-279``).  The operator is symmetric negative definite,
exactly as the reference assembles it.

``poisson_stencil_device`` (the structured path) and ``poisson_dia_device``
(the general-matrix path, as 7 bands) compute every field with torch ops
on ``device``.  ``exact_field``/``rhs_field``/``poisson_stencil`` and
``assemble_poisson`` are the host (numpy) oracles the tests compare
against.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.sparse.csr import HostCSR
from tpusparse_torch.sparse.dia import DFDIA, DIA
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


def _cos_fields(grid: Grid3D, dt: torch.dtype, device):
    """(exact, b) as (nz, ny, nx) fields of ``dt`` on ``device``, unpinned."""

    def centers(n, h):
        return C1 * (torch.arange(n, dtype=dt, device=device) + 0.5) * h

    cxs = torch.cos(centers(grid.nx, grid.dx))
    cys = torch.cos(centers(grid.ny, grid.dy))
    czs = torch.cos(centers(grid.nz, grid.dz))
    exact = czs[:, None, None] * cys[None, :, None] * cxs[None, None, :]
    return exact, C2 * exact


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
    exact, b = _cos_fields(grid, dt, device)

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
    nbrs = _neighbor_masks_and_coeffs(grid, dtype)
    diag = np.zeros(grid.shape, dtype=dtype)
    coefs = {}
    for name, valid, _off, coef in nbrs:
        diag -= np.where(valid, coef, dtype(0))
        coefs[name] = coef
    ax, ay, az = coefs["i-1"], coefs["j-1"], coefs["k-1"]

    exact = exact_field(grid, dtype)
    b = rhs_field(grid, dtype).copy()
    scale = dtype(diag.sum() / grid.n)
    if pin:
        e0 = exact[0, 0, 0]
        # neighbors of cell 0 lose their column-0 entry; move it to the RHS
        if grid.nx > 1:
            b[0, 0, 1] -= ax * e0
        if grid.ny > 1:
            b[0, 1, 0] -= ay * e0
        if grid.nz > 1:
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


def _neighbor_masks_and_coeffs(grid: Grid3D, dtype):
    """Validity masks and coefficients of the 6 neighbors, in ascending
    column-offset order: k-1, j-1, i-1, i+1, j+1, k+1 (the sorted column
    order PETSc stores after assembly)."""
    nz, ny, nx = grid.shape
    ax = dtype(1.0 / (grid.dx * grid.dx))
    ay = dtype(1.0 / (grid.dy * grid.dy))
    az = dtype(1.0 / (grid.dz * grid.dz))
    K = np.arange(nz)[:, None, None]
    J = np.arange(ny)[None, :, None]
    I = np.arange(nx)[None, None, :]
    ones = np.ones((nz, ny, nx), bool)
    # (name, valid mask (nz, ny, nx), flat column offset, coefficient)
    return [
        ("k-1", (K > 0) & ones, -ny * nx, az),
        ("j-1", (J > 0) & ones, -nx, ay),
        ("i-1", (I > 0) & ones, -1, ax),
        ("i+1", (I < nx - 1) & ones, +1, ax),
        ("j+1", (J < ny - 1) & ones, +nx, ay),
        ("k+1", (K < nz - 1) & ones, +ny * nx, az),
    ]


def assemble_poisson(grid: Grid3D, pin: bool = True, dtype=np.float64):
    """Assemble the 7-point Neumann Laplacian, the right-hand side and the
    exact solution on the host: ``(A: HostCSR, b (n,), exact (n,))``, with
    the reference-point pin applied to A and b when ``pin``.

    Parity: ``generateA`` (src/helper.cpp:161-246) + ``setRefPoint``
    (src/helper.cpp:250-279).  O(nnz) numpy: the oracle at test sizes.
    """
    n = grid.n
    # per-row entries in sorted column order: 3 lower nbrs, diag, 3 upper
    w = 7
    slots = [0, 1, 2, 4, 5, 6]  # slot 3 = diagonal
    offs = np.zeros(w, np.int64)
    coefs = np.zeros(w, dtype)
    mask = np.empty((n, w), dtype=bool)
    mask[:, 3] = True
    for (_name, valid, off, coef), s in zip(_neighbor_masks_and_coeffs(grid, dtype), slots):
        mask[:, s] = valid.reshape(-1)
        offs[s] = off
        coefs[s] = coef
    idx_dtype = np.int32 if n < 2**31 - 1 else np.int64
    rows = np.arange(n, dtype=idx_dtype)
    cols = rows[:, None] + offs.astype(idx_dtype)[None, :]
    vals = np.where(mask, coefs[None, :], dtype(0))
    # all-Neumann: diagonal = -(sum of the coefficients of existing nbrs);
    # coefs[3] is 0, so the whole row's sum is the neighbor sum
    diag = -vals.sum(axis=1)
    vals[:, 3] = diag

    exact = exact_field(grid, dtype).reshape(-1)
    b = rhs_field(grid, dtype).reshape(-1)

    scale = dtype(diag.sum() / n)  # mean of the diagonal (src/helper.cpp:264-272)
    if pin:
        # MatZeroRowsColumns(A, {0}, scale, x=exact, b=rhs) (src/helper.cpp:274):
        #   b[i] -= A[i,0] * exact[0] for i != 0 with a column-0 entry;
        #   row and column 0 zeroed, A[0,0] = scale, b[0] = scale * exact[0]
        for s in range(w):
            r = -int(offs[s])
            if 0 <= r < n and s != 3 and mask[r, s]:
                b[r] -= vals[r, s] * exact[0]
                mask[r, s] = False
                vals[r, s] = dtype(0)
        mask[0, :] = False
        vals[0, :] = dtype(0)
        cols[0, 3] = 0
        vals[0, 3] = scale
        mask[0, 3] = True
        b[0] = scale * exact[0]

    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(mask.sum(axis=1), out=indptr[1:])
    flat = np.flatnonzero(mask.ravel())
    a = HostCSR(
        indptr=indptr,
        indices=np.ascontiguousarray(cols.ravel()[flat], dtype=np.int32),
        data=vals.ravel()[flat],
        shape=(n, n),
    )
    return a, b, exact


def _split(c: float) -> tuple[float, float]:
    """The exact two-float split of an f64 value: (float32(c), float32(c - hi))."""
    hi = np.float32(c)
    return float(hi), float(np.float32(c - np.float64(hi)))


def poisson_dia_device(grid: Grid3D, pin: bool = True, *, device):
    """The general-matrix (MATAIJ) system assembled on ``device`` as 7 bands
    in an exact two-float split: ``(op_hi: DFDIA, op_lo: DIA, b, exact)``,
    flat, with ``b``/``exact`` f64 and ``op_lo`` aliasing ``op_hi.hi``.

    The six neighbor bands take one value each (``1/h^2``) and the diagonal
    one of 64 (one per neighbor-presence pattern); all are split into hi and
    lo on the host as scalars, with numpy's own 7-slot row sum so the f64
    rounding matches ``assemble_poisson`` entry for entry.  The bands are
    then built on the device by masks, so ``hi == float32(A64)`` and
    ``hi + lo`` carries ~48 mantissa bits, with no O(n) host work.  The pin
    moves the column-0 couplings to ``b``.  Parity oracle:
    ``assemble_poisson``.
    """
    nz, ny, nx = grid.shape
    if min(nx, ny, nz) < 2:
        raise ValueError("poisson_dia_device requires nx, ny, nz >= 2")
    n = grid.n
    ax = 1.0 / (grid.dx * grid.dx)
    ay = 1.0 / (grid.dy * grid.dy)
    az = 1.0 / (grid.dz * grid.dz)

    # band order = ascending column offset (PETSc's post-assembly order)
    offsets = (-ny * nx, -nx, -1, 0, 1, nx, ny * nx)
    csplit = [_split(c) for c in (az, ay, ax, 0.0, ax, ay, az)]
    dsplit = np.empty((2,) * 6 + (2,), np.float32)
    for bits in np.ndindex(*(2,) * 6):
        row = np.array(
            [az * bits[0], ay * bits[1], ax * bits[2], 0.0,
             ax * bits[3], ay * bits[4], az * bits[5]], np.float64,
        )
        dsplit[bits] = _split(-row.sum())
    # pinned diagonal: the mean of the unpinned diagonal, closed form
    sum_diag = -2.0 * (
        ax * (nx - 1) * ny * nz + ay * (ny - 1) * nx * nz + az * (nz - 1) * nx * ny
    )
    scale = sum_diag / n
    scale_split = _split(scale)

    k = torch.arange(nz, dtype=torch.int64, device=device)[:, None, None]
    j = torch.arange(ny, dtype=torch.int64, device=device)[None, :, None]
    i = torch.arange(nx, dtype=torch.int64, device=device)[None, None, :]
    masks = [k > 0, j > 0, i > 0, None, i < nx - 1, j < ny - 1, k < nz - 1]
    # the diagonal's neighbor-presence pattern as a 6-bit index, first bit
    # most significant (dsplit's C order)
    pattern = torch.zeros((nz, ny, nx), dtype=torch.int64, device=device)
    for s in (0, 1, 2, 4, 5, 6):
        pattern = pattern * 2 + masks[s].to(torch.int64)
    pattern = pattern.reshape(-1)
    zero = torch.zeros((), dtype=torch.float32, device=device)

    def stack(part: int) -> torch.Tensor:
        out = torch.empty((7, n), dtype=torch.float32, device=device)
        for s in range(7):
            if s == 3:
                table = torch.as_tensor(dsplit[..., part].reshape(-1), device=device)
                out[3] = table[pattern]
            else:
                c = torch.tensor(csplit[s][part], dtype=torch.float32, device=device)
                out[s] = torch.where(masks[s], c, zero).expand(nz, ny, nx).reshape(-1)
        return out

    hi, lo = stack(0), stack(1)
    exact, b = _cos_fields(grid, torch.float64, device)
    exact, b = exact.reshape(-1), b.reshape(-1)
    if pin:
        e0 = exact[0]
        # column-0 entries live in the negative-offset bands at rows
        # r = -offset (MatZeroRowsColumns, src/helper.cpp:274): move the
        # coupling to the right-hand side and zero the entry
        for s, r, c in ((0, ny * nx, az), (1, nx, ay), (2, 1, ax)):
            b[r] += -c * e0
            hi[s, r] = 0.0
            lo[s, r] = 0.0
        # row 0: every neighbor dropped, diagonal = scale
        for band in (hi, lo):
            band[:3, 0] = 0.0
            band[4:, 0] = 0.0
        hi[3, 0], lo[3, 0] = scale_split
        b[0] = scale * e0
    lo_is_zero = (
        all(c[1] == 0.0 for c in csplit)
        and not np.any(dsplit[..., 1])
        and (not pin or scale_split[1] == 0.0)
    )
    op_lo = DIA(bands=hi, offsets=offsets, shape=(n, n))
    op_hi = DFDIA(hi=hi, lo=None if lo_is_zero else lo, offsets=offsets, shape=(n, n))
    return op_hi, op_lo, b, exact

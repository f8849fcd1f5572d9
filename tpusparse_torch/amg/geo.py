"""Geometry-aware aggregation for the general-matrix (aij) path — port of
``tpusparse/amg/geo.py``.

A banded matrix with offsets ``{dz*(nx*ny) + dy*nx + dx : |dz|,|dy|,|dx| <= r}``
is a grid operator in lexicographic order, whatever its coefficients.  When
``infer_grid3d`` recognizes that shape, aggregation becomes geometric
(bz x by x bx index blocks, the 3^3 aggregation of the structured path),
the transfer becomes ``GeoTransfer`` (three axis contractions with 0/1
membership matrices), and every Galerkin coarse operator is a <= 27-band
DIA probed on the device (``galerkin_probe_geo``).  ``gamg_setup_geo``
builds the whole hierarchy on the device from the fine DIA alone.

The reference's matrix is this class (``DMSetMatType(MATAIJ)`` over a DMDA
7-point star, reference ``src/helper.cpp:31-39,161-246``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusparse_torch.amg.hierarchy import (
    AMGParams,
    Hierarchy,
    Level,
    dense_coarse_inverse,
    estimate_rho_dinv_a,
)
from tpusparse_torch.amg.transfer import _agg_matrix
from tpusparse_torch.solve.cg import np_float
from tpusparse_torch.sparse.dia import DIA


def infer_grid3d(
    offsets: tuple[int, ...], n: int, max_reach: int = 3
) -> tuple[int, int, int] | None:
    """Recover (nz, ny, nx) from a banded sparsity pattern, or None.

    Accepts offset sets of the form ``dz*(nx*ny) + dy*nx + dx`` with
    ``|d*| <= max_reach`` over some factorization ``n == nx*ny*nz``.  The
    7-point star yields ``{0, +-1, +-nx, +-nx*ny}``; Galerkin coarse
    operators of geometric 3^3 aggregation the 27-point version.

    Degenerate or ambiguous patterns (pure tridiagonal, too few distinct
    positive offsets to pin nx and nx*ny, solid bands) return None: the
    caller falls back to graph aggregation, never guesses.
    """
    offs = sorted(set(int(o) for o in offsets))
    if offs != sorted(-o for o in offs):
        return None  # structurally nonsymmetric pattern: not a grid star
    pos = [o for o in offs if o > 0]
    if len(pos) < 2 or pos[0] != 1:
        return None
    # Grid stars are clustered offset sets: each (dz, dy) plane contributes
    # a run of at most 2*max_reach+1 consecutive dx values.  A solid band
    # (e.g. an RCM-reordered scattered matrix) can decompose "validly"
    # under a small-nx factorization, so a long contiguous run is a band.
    run = longest = 1
    for a, b_ in zip(pos, pos[1:]):
        run = run + 1 if b_ == a + 1 else 1
        longest = max(longest, run)
    if longest > 2 * max_reach + 1:
        return None

    def decompose(o, nx, q):
        """o -> (dz, dy, dx) under strides (q, nx, 1), nearest rounding."""
        dz = round(o / q) if q else 0
        rem = o - dz * q
        dy = round(rem / nx)
        dx = rem - dy * nx
        return dz, dy, dx

    def valid(nx, ny, nz):
        q = nx * ny
        for o in pos:
            dz, dy, dx = decompose(o, nx, q if nz > 1 else 0)
            if nz == 1 and abs(o) >= q:
                return False
            if not (abs(dz) <= max_reach and abs(dy) <= max_reach and abs(dx) <= max_reach):
                return False
            # (dz, dy, dx) must address a real neighbor on the grid
            if abs(dy) >= ny or abs(dx) >= nx or abs(dz) >= nz:
                return False
        return True

    def score(nx, ny, nz):
        """Total |dz|+|dy|+|dx| over offsets: ties between valid
        factorizations (tiny grids whose offset clusters overlap) resolve
        toward the one of minimal neighbor reach, the real one."""
        q = nx * ny
        return sum(sum(map(abs, decompose(o, nx, q if nz > 1 else 0))) for o in pos)

    # nx candidates: the cluster of offsets just above the x-band
    big = [o for o in pos if o > max_reach]
    if not big:
        return None
    nx_cands = [o for o in big if o <= big[0] + max_reach and n % o == 0]
    found: list[tuple[int, tuple[int, int, int]]] = []
    for nx in nx_cands:
        # q candidates: the cluster just above the xy-plane band
        plane = [o for o in big if o > nx * max_reach + max_reach]
        if not plane:
            ny = n // nx
            if ny >= 1 and valid(nx, ny, 1):
                found.append((score(nx, ny, 1), (1, ny, nx)))
            continue
        q_cands = [
            o for o in plane
            if o <= plane[0] + nx * max_reach + max_reach and o % nx == 0 and n % o == 0
        ]
        for q in q_cands:
            ny = q // nx
            nz = n // q
            if ny >= 1 and nz >= 1 and valid(nx, ny, nz):
                found.append((score(nx, ny, nz), (nz, ny, nx)))
    return min(found)[1] if found else None


def geo_block_sizes(shape, factor: int = 3):
    """Per-axis aggregation block size: ``factor``, clamped to the axis."""
    return tuple(min(factor, s) for s in shape)


def coarse_dims(shape, bs):
    return tuple(-(-s // b) for s, b in zip(shape, bs))


def geo_aggregate_ids(shape, bs) -> np.ndarray:
    """The aggregate id of every fine cell under bz x by x bx index blocks,
    coarse cells in 3-D lexicographic order: (n,) int64 on the host, for
    the host route's tentative prolongator and Galerkin product."""
    nz, ny, nx = shape
    _, cys, cxs = coarse_dims(shape, bs)
    z, y, x = np.meshgrid(
        np.arange(nz) // bs[0], np.arange(ny) // bs[1], np.arange(nx) // bs[2], indexing="ij",
    )
    return (z * cys * cxs + y * cxs + x).reshape(-1)


def _ax_sizes(s, b):
    c = -(-s // b)
    out = np.full(c, b, np.float64)
    if s % b:
        out[-1] = s % b
    return out


def block_weight_field_dev(shape, bs, dtype=torch.float32, *, device):
    """Coarse-sized field of 1/sqrt(|block|) (ragged edge blocks included):
    the outer product of three per-axis size vectors, in ``dtype``."""
    sz, sy, sx = (
        torch.as_tensor(_ax_sizes(s, b), device=device).to(dtype) for s, b in zip(shape, bs)
    )
    sizes = sz[:, None, None] * sy[None, :, None] * sx[None, None, :]
    return 1.0 / torch.sqrt(sizes)


def _up(sz, sy, sx, e_c: torch.Tensor) -> torch.Tensor:
    """T0 e_c as three axis contractions with the membership matrices,
    flat -> flat, of a vector or of each column of a stack (k, n)."""
    lead = tuple(e_c.shape[:-1])
    e3 = e_c.reshape(*lead, sz.shape[1], sy.shape[1], sx.shape[1])
    t = torch.einsum("Zc,...cyx->...Zyx", sz, e3)
    t = torch.einsum("Yc,...zcx->...zYx", sy, t)
    t = torch.einsum("Xc,...zyc->...zyX", sx, t)
    return t.reshape(*lead, -1)


@dataclasses.dataclass
class GeoTransfer:
    """Smoothed-aggregation transfer over geometric index blocks.

    P = (I - omega D^-1 A) T with T the l2-normalized piecewise-constant
    tentative prolongator over bz x by x bx blocks.  T's index action is
    three contractions with the per-axis 0/1 membership matrices
    ``sz/sy/sx``; the smoothing factor reuses the level operator's mv.
    ``omega`` is a Python float holding a value of the level's dtype.
    ``prolong`` and ``restrict`` take a vector or a stack of columns (k,
    n), ``KSP.mat_solve``'s block, each column as its vector form.
    """

    w: torch.Tensor        # (n_fine,) 1/sqrt(|block|) per member
    omega: float           # prolongator-smoothing damping
    sz: torch.Tensor       # (nz, czs) 0/1 membership
    sy: torch.Tensor       # (ny, cys)
    sx: torch.Tensor       # (nx, cxs)
    fine_shape: tuple[int, int, int]
    bs: tuple[int, int, int]

    @classmethod
    def build(cls, omega: float, fine_shape, bs, dtype=torch.float32, *, device) -> "GeoTransfer":
        """The transfer over the ``bs`` blocks of ``fine_shape``: the axis
        membership matrices and the fine weight field, T0 applied to the
        coarse block weights."""
        sz, sy, sx = (
            torch.as_tensor(_agg_matrix(s, b, np.float32), device=device).to(dtype)
            for s, b in zip(fine_shape, bs)
        )
        w_c = block_weight_field_dev(fine_shape, bs, dtype, device=device)
        return cls(
            w=_up(sz, sy, sx, w_c.reshape(-1)), omega=float(omega), sz=sz, sy=sy, sx=sx,
            fine_shape=tuple(fine_shape), bs=tuple(bs),
        )

    @property
    def coarse_shape(self):
        return coarse_dims(self.fine_shape, self.bs)

    def _up(self, e_c: torch.Tensor) -> torch.Tensor:
        """T0 e_c, flat -> flat."""
        return _up(self.sz, self.sy, self.sx, e_c)

    def _down(self, v: torch.Tensor) -> torch.Tensor:
        """T0^T v as three axis contractions, flat -> flat, as ``_up``."""
        lead = tuple(v.shape[:-1])
        v3 = v.reshape(*lead, *self.fine_shape)
        t = torch.einsum("Zc,...Zyx->...cyx", self.sz, v3)
        t = torch.einsum("Yc,...zYx->...zcx", self.sy, t)
        t = torch.einsum("Xc,...zyX->...zyc", self.sx, t)
        return t.reshape(*lead, -1)

    def prolong(self, fine_op, dinv: torch.Tensor, e_c: torch.Tensor) -> torch.Tensor:
        """x_f = P e_c = (I - omega D^-1 A) T e_c."""
        t = self.w * self._up(e_c)
        return t - self.omega * (dinv * fine_op.mv(t))

    def restrict(self, fine_op, dinv: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """r_c = P^T x = T^T (I - omega A D^-1) x   (A symmetric)."""
        s = x - self.omega * fine_op.mv(dinv * x)
        return self._down(self.w * s)


def grid_reach(offsets, shape) -> tuple[int, int, int]:
    """Per-axis neighbor reach (max |dz|, |dy|, |dx|) of a banded operator
    on the given grid."""
    nz, ny, nx = shape
    q = ny * nx
    rz = ry = rx = 0
    for o in offsets:
        dz = round(o / q) if nz > 1 else 0
        rem = o - dz * q
        dy = round(rem / nx) if ny > 1 else 0
        dx = rem - dy * nx
        rz, ry, rx = max(rz, abs(dz)), max(ry, abs(dy)), max(rx, abs(dx))
    return rz, ry, rx


def _shift3(y3: torch.Tensor, d3) -> torch.Tensor:
    """out[p] = y3[p + d3], zeros shifted in."""
    out = torch.zeros_like(y3)
    src, dst = [], []
    for d, s in zip(d3, y3.shape):
        lo, hi = max(0, -d), min(s, s - d)
        if hi <= lo:
            return out
        dst.append(slice(lo, hi))
        src.append(slice(lo + d, hi + d))
    out[tuple(dst)] = y3[tuple(src)]
    return out


def galerkin_probe_geo(fine_op, dinv: torch.Tensor, transfer: GeoTransfer, dtype=None) -> DIA:
    """A_c = P^T A P by exact on-device comb probing into a <= 27-band DIA.

    Under geometric aggregation the coarse pattern is known a priori, so
    comb vectors whose members lie farther apart than the coarse reach
    recover every band exactly: no host coarse matrix, no SpGEMM.
    """
    fs = transfer.fine_shape
    cs = transfer.coarse_shape
    czs, cys, cxs = cs
    nc = czs * cys * cxs
    dt = dtype or dinv.dtype
    dev = dinv.device

    # coarse reach per axis: supports overlap iff |dc|*b < b + 3*reach
    reach = grid_reach(fine_op.offsets, fs)
    rc = tuple((b - 1 + 3 * r) // b if s > 1 else 0 for b, r, s in zip(transfer.bs, reach, cs))
    mz, my, mx = (2 * r + 1 for r in rc)
    d3s = [
        (dz, dy, dx)
        for dz in range(-rc[0], rc[0] + 1)
        for dy in range(-rc[1], rc[1] + 1)
        for dx in range(-rc[2], rc[2] + 1)
        if abs(dz) < czs and abs(dy) < cys and abs(dx) < cxs
    ]
    offsets = tuple(dz * cys * cxs + dy * cxs + dx for (dz, dy, dx) in d3s)

    kz = torch.arange(czs, device=dev)[:, None, None] % mz
    jy = torch.arange(cys, device=dev)[None, :, None] % my
    ix = torch.arange(cxs, device=dev)[None, None, :] % mx
    bands = torch.zeros((len(d3s),) + tuple(cs), dtype=dt, device=dev)
    for t in range(mz * my * mx):
        a, rem = divmod(t, my * mx)
        b, c = divmod(rem, mx)
        e3 = ((kz == a) & (jy == b) & (ix == c)).to(dt)
        y = transfer.restrict(
            fine_op, dinv, fine_op.mv(transfer.prolong(fine_op, dinv, e3.reshape(-1)))
        )
        y3 = y.reshape(cs)
        # DIA convention bands[k][r] = A[r, r+o]: row r takes the probe
        # where its column r+d3 is a comb member (right for nonsymmetric
        # operators too)
        for k, d3 in enumerate(d3s):
            col_is_member = _shift3(e3, d3) > 0.5
            bands[k] = torch.where(col_is_member, y3, bands[k])

    # ascending offsets (the DIA convention); coarse levels stay flat
    order = np.argsort(offsets)
    return DIA(
        bands=bands.reshape(len(d3s), nc)[torch.as_tensor(order, device=dev)],
        offsets=tuple(int(offsets[i]) for i in order),
        shape=(nc, nc),
    )


def gamg_setup_geo(fine_op: DIA, shape, params: AMGParams) -> Hierarchy:
    """Device-resident geometric GAMG setup from the fine DIA operator and
    its inferred grid shape: aggregation is index arithmetic, transfers are
    contractions, Galerkin products are on-device comb probes and rho is
    the on-device power iteration.  No host coarse matrix anywhere.

    Stops coarsening when the level has ``coarse_eq_limit`` rows or fewer,
    at ``max_levels``, or when every block edge is 1.  ``coarse_solve="lu"``
    inverts the coarsest DIA densely (``hierarchy.dense_coarse_inverse``).
    """
    if params.coarse_solve not in ("jacobi", "lu"):
        raise ValueError(f"unknown coarse_solve {params.coarse_solve!r} (jacobi | lu)")
    shape = tuple(shape)
    levels: list[Level] = []
    op = fine_op
    while True:
        n = int(np.prod(shape))
        dinv = 1.0 / op.diagonal()
        rho = (estimate_rho_dinv_a(op, dinv, params.rho_iters) * params.rho_safety).item()
        bs = geo_block_sizes(shape, params.factor)
        last = (
            n <= params.coarse_eq_limit
            or len(levels) + 1 >= params.max_levels
            or all(b == 1 for b in bs)
        )
        if last:
            levels.append(Level(
                op=op, dinv=dinv, rho=rho, transfer=None,
                coarse_inv=dense_coarse_inverse(op) if params.coarse_solve == "lu" else None,
            ))
            break
        f = np_float(op.dtype)
        omega = float(params.omega_scale / f(rho)) if params.nsmooths == 1 else 0.0
        transfer = GeoTransfer.build(omega, shape, bs, op.dtype, device=dinv.device)
        levels.append(Level(op=op, dinv=dinv, rho=rho, transfer=transfer))
        op = galerkin_probe_geo(op, dinv, transfer)
        shape = coarse_dims(shape, bs)
    return Hierarchy(
        levels=levels,
        damping=float(np_float(levels[0].dinv.dtype)(params.smooth_damping)),
        smoother=params.smoother,
        degree=params.degree,
        cheby_lo=params.cheby_lo,
        cheby_hi=params.cheby_hi,
    )

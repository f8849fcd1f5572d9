"""Structured smoothed-aggregation grid transfers — port of
``tpusparse/amg/transfer.py``.

GAMG parity (``configs/PETSc_SolverOptions_GAMG.info:6-9``: agg, nsmooths 1,
threshold 0.0): the prolongator is the once-smoothed tentative operator

    P = (I - omega * D^{-1} A) T,     omega = 4 / (3 * rho(D^{-1} A)),

with geometric 3x3x3 aggregates (ragged at the high boundary).  T is the
piecewise-constant injection with l2-normalized columns.  The JAX package
applies it as three contractions with 0/1 per-axis membership matrices
(XLA computes them); here a CUDA field takes one launch of
``kernels/transfer.py``'s ``agg_prolong`` / ``agg_restrict`` each way, and
a CPU field those three einsums, their plain twin.

Under ``-pc_gamg_threshold`` (``hierarchy.threshold_schedule``) an axis may
stay uncoarsened (factor 1), and P is smoothed with ``fop``, the level
operator with that axis's legs dropped (``hierarchy._filtered_op``), so that
the Galerkin product stays inside the 27-point container.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusparse_torch.kernels.transfer import agg_prolong, agg_restrict


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def norm_factors(factor) -> tuple[int, int, int]:
    """Per-axis aggregation factors: an int means isotropic blocks; a
    3-tuple (fz, fy, fx) gives per-axis factors."""
    if isinstance(factor, (tuple, list)):
        fz, fy, fx = (int(f) for f in factor)
        return (fz, fy, fx)
    return (int(factor),) * 3


def coarse_shape(fine_shape: tuple[int, int, int], factor=3):
    return tuple(cdiv(s, f) for s, f in zip(fine_shape, norm_factors(factor)))


def aggregate_sizes(fine_shape, factor=3) -> np.ndarray:
    """(ncz, ncy, ncx) array of aggregate cardinalities (ragged at the top)."""
    per_axis = []
    for s, f in zip(fine_shape, norm_factors(factor)):
        nc = cdiv(s, f)
        sz = np.full(nc, f, dtype=np.int64)
        sz[-1] = s - f * (nc - 1)
        per_axis.append(sz)
    return (
        per_axis[0][:, None, None]
        * per_axis[1][None, :, None]
        * per_axis[2][None, None, :]
    )


def _agg_matrix(n: int, factor: int, dtype) -> np.ndarray:
    """(n, ceil(n/factor)) 0/1 membership matrix: S[i, i // factor] = 1."""
    s = np.zeros((n, cdiv(n, factor)), dtype)
    s[np.arange(n), np.arange(n) // factor] = 1
    return s


@dataclasses.dataclass
class StructuredTransfer:
    """Matrix-free smoothed-aggregation transfer between one level pair.

    ``omega`` is a Python float holding a value of the level's dtype;
    ``tnorm`` the coarse-shaped field 1/sqrt(|agg|); ``sz/sy/sx`` the
    per-axis aggregation matrices; ``fop`` the filtered P-smoothing
    operator, or None (smooth with the level operator itself).
    """

    omega: float
    tnorm: torch.Tensor   # (ncz, ncy, ncx)
    sz: torch.Tensor      # (nz, ncz) 0/1
    sy: torch.Tensor      # (ny, ncy) 0/1
    sx: torch.Tensor      # (nx, ncx) 0/1
    fine_shape: tuple[int, int, int]
    factor: tuple[int, int, int]
    fop: object | None = None

    @classmethod
    def build(cls, fine_shape, omega: float, dtype: torch.dtype, factor=3, *, device, fop=None):
        fz, fy, fx = norm_factors(factor)

        def put(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return cls(
            omega=float(omega),
            tnorm=put(1.0 / np.sqrt(aggregate_sizes(fine_shape, factor))),
            sz=put(_agg_matrix(fine_shape[0], fz, np.float64)),
            sy=put(_agg_matrix(fine_shape[1], fy, np.float64)),
            sx=put(_agg_matrix(fine_shape[2], fx, np.float64)),
            fine_shape=tuple(fine_shape),
            factor=norm_factors(factor),
            fop=fop,
        )

    @property
    def c_shape(self):
        return coarse_shape(self.fine_shape, self.factor)

    def t_apply(self, e_c: torch.Tensor) -> torch.Tensor:
        """T e_c: normalized piecewise-constant interpolation (coarse ->
        fine), of a field or of each field of a stack with leading axes."""
        return agg_prolong(e_c, self.tnorm, (self.sz, self.sy, self.sx), self.factor, self.fine_shape)

    def tT_apply(self, r: torch.Tensor) -> torch.Tensor:
        """T^T r: block sums (fine -> coarse), as ``t_apply`` on stacks."""
        return agg_restrict(r, self.tnorm, (self.sz, self.sy, self.sx), self.factor, self.fine_shape)

    def prolong(self, fine_op, dinv: torch.Tensor, e_c: torch.Tensor) -> torch.Tensor:
        """x_f = P e_c = (I - omega D^{-1} A) T e_c."""
        if self.fop is not None:
            fine_op = self.fop
        t = self.t_apply(e_c)
        return t - self.omega * dinv * fine_op.mv(t)

    def restrict(self, fine_op, dinv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """r_c = P^T r = T^T (I - omega A D^{-1}) r   (A symmetric)."""
        if self.fop is not None:
            fine_op = self.fop
        s = r - self.omega * fine_op.mv(dinv * r)
        return self.tT_apply(s)

    def explicit_p_scipy(self, fine_op_csr, dinv_flat: np.ndarray):
        """Host oracle: P = (I - omega D^{-1} A) T as a scipy CSR matrix,
        from the fine operator's ``HostCSR`` and its flat D^{-1}."""
        import scipy.sparse as sp

        nz, ny, nx = self.fine_shape
        cz, cy, cx = self.c_shape
        fz, fy, fx = self.factor
        k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
        agg = (((k // fz) * cy + (j // fy)) * cx + (i // fx)).reshape(-1)
        tnorm = self.tnorm.detach().cpu().numpy().reshape(-1)
        n_f = nz * ny * nx
        t = sp.csr_matrix((tnorm[agg], (np.arange(n_f), agg)), shape=(n_f, cz * cy * cx))
        a = fine_op_csr.to_scipy()
        d = sp.diags(np.asarray(dinv_flat))
        return (t - self.omega * (d @ (a @ t))).tocsr()

"""Block-Jacobi preconditioner — port of ``tpusparse/solve/bjacobi.py``.

Real PCBJACOBI, not the point degeneracy: the bs x bs diagonal blocks of A
are assembled from a host CSR matrix (``BlockJacobi.build``, the aij
route's standalone ``-pc_type bjacobi``) or from a structured operator's
band fields (``flat_band_fields``, the ``-pc_bjacobi_bs`` sub-PC of the
GAMG level smoother, ``amg/hierarchy.py::gamg_setup``), inverted once at
setup, and applied as

    z_block = inv(A_block) @ r_block,

one batched (nb, bs, bs) x (nb, bs) product.  Tridiagonal blocks past the
dense entry cap (the x-line case, bs = nx: at 300^3 dense line blocks would
hold ~32 GB) are solved exactly by parallel cyclic reduction
(``PCRLineJacobi``) instead.  The host work of ``build`` stays numpy;
the apply is one ``torch.einsum`` over the blocks, the JAX package's XLA
einsum.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusparse_torch.sparse.csr import HostCSR


def _eye(bs: int, k: int, dtype, device) -> torch.Tensor:
    """(bs, bs) with ones on diagonal ``k`` (row j, column j + k)."""
    return torch.diag(torch.ones(bs - abs(k), dtype=dtype, device=device), k)


@dataclasses.dataclass
class BlockJacobi:
    """Inverted diagonal blocks of A: ``dinv_blocks[k] = inv(A[kb:kb+bs,
    kb:kb+bs])`` (the tail block padded with identity when bs does not
    divide n)."""

    dinv_blocks: torch.Tensor  # (nb, bs, bs)
    bs: int
    n: int

    # Dense inverted blocks cost O(n*bs) memory and work per apply.  Past
    # this many block entries (f32: 256 MiB) tridiagonal blocks go to the
    # O(n log bs) PCR solve; anything denser must shrink bs.
    DENSE_ENTRY_CAP = 64 * 2**20

    @classmethod
    def build(cls, a, bs: int, dtype=None, *, device="cuda"):
        """Extract and invert the diagonal blocks of a HostCSR (or scipy)
        matrix on the host; the blocks go to ``device`` in ``dtype`` (a
        numpy dtype; default f64).  The tail block is padded with identity
        and an empty diagonal entry is taken as 1.  Past
        ``DENSE_ENTRY_CAP`` tridiagonal blocks return a
        :class:`PCRLineJacobi`; denser ones raise."""
        if not isinstance(a, HostCSR):
            a = HostCSR.from_scipy(a)
        n = a.n_rows
        nb = -(-n // bs)
        rows = np.repeat(np.arange(n, dtype=np.int64), a.row_nnz())
        cols = a.indices.astype(np.int64)
        mask = rows // bs == cols // bs

        def put(v):
            return torch.as_tensor(v if dtype is None else v.astype(dtype), device=device)

        if nb * bs * bs > cls.DENSE_ENTRY_CAP:
            off = (cols - rows)[mask]
            if not np.all(np.abs(off) <= 1):
                raise ValueError(
                    f"bjacobi bs={bs}: dense inverted blocks would hold {nb * bs * bs:.3g} entries"
                    f" (> {cls.DENSE_ENTRY_CAP:.3g} cap) and the blocks are not tridiagonal — shrink bs"
                )
            tri = np.zeros((3, nb * bs), np.float64)
            tri[off + 1, rows[mask]] = a.data[mask]
            tri[1, n:] = 1.0  # the identity tail block
            tri[1, tri[1] == 0.0] = 1.0  # a singular block, regularized
            lo, d, up = (r.reshape(nb, bs) for r in put(tri))
            return PCRLineJacobi.build(lo, d, up, n)
        blocks = np.zeros((nb, bs, bs), np.float64)
        blocks[rows[mask] // bs, rows[mask] % bs, cols[mask] % bs] = a.data[mask]
        tail = np.arange(n, nb * bs)
        blocks[tail // bs, tail % bs, tail % bs] = 1.0  # the identity tail block
        # a structurally empty diagonal entry would make its block singular
        # (PETSc's bjacobi fails there): regularized
        dg = np.einsum("kii->ki", blocks)
        dg[dg == 0.0] = 1.0
        return cls(dinv_blocks=put(np.linalg.inv(blocks)), bs=bs, n=n)

    @classmethod
    def from_bands(cls, diag: torch.Tensor, bands: dict, bs: int):
        """Build from a structured operator's flat-offset band fields
        ({o: f} with ``f[p] = A[p, p+o]``; offsets at or beyond bs never
        land inside a block).  Couplings that straddle a block boundary are
        dropped, which is what block Jacobi means.  Returns a
        :class:`BlockJacobi` while the dense blocks fit the entry cap, a
        :class:`PCRLineJacobi` for tridiagonal blocks past it."""
        d = diag.reshape(-1)
        n = d.shape[0]
        nb = -(-n // bs)
        pad = nb * bs - n

        def prep(v, fill):
            v = v.reshape(-1).to(d.dtype)
            if pad:
                v = torch.cat([v, torch.full((pad,), fill, dtype=d.dtype, device=d.device)])
            return v.reshape(nb, bs)

        rel = {o: f for o, f in bands.items() if 0 < abs(o) < bs}
        # structurally empty diagonal entries would make a block singular;
        # the tail block pads with identity
        d2 = prep(torch.where(d == 0, torch.ones((), dtype=d.dtype, device=d.device), d), 1.0)
        if nb * bs * bs > cls.DENSE_ENTRY_CAP:
            if set(rel) <= {-1, 1}:
                zero = torch.zeros((nb, bs), dtype=d.dtype, device=d.device)
                lo = prep(rel[-1], 0.0).clone() if -1 in rel else zero.clone()
                up = prep(rel[1], 0.0).clone() if 1 in rel else zero.clone()
                lo[:, 0] = 0.0          # couplings straddling a block boundary
                up[:, bs - 1] = 0.0
                return PCRLineJacobi.build(lo, d2, up, n)
            raise ValueError(
                f"bjacobi bs={bs}: dense inverted blocks would hold {nb * bs * bs:.3g}"
                f" entries (> {cls.DENSE_ENTRY_CAP:.3g} cap) and the blocks are not"
                f" tridiagonal (offsets {sorted(rel)}) — shrink bs"
            )
        blocks = d2[:, :, None] * _eye(bs, 0, d.dtype, d.device)
        for o, f in sorted(rel.items()):
            # entry (j, j+o) of block k = f[k*bs + j]
            blocks = blocks + prep(f, 0.0)[:, :, None] * _eye(bs, o, d.dtype, d.device)
        return cls(dinv_blocks=torch.linalg.inv(blocks), bs=bs, n=n)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """z = inv(blockdiag(A)) @ r on the flat vector or any field view of
        it, or on each of a stack of them (leading axes); z keeps r's
        shape."""
        nb, bs = self.dinv_blocks.shape[0], self.bs
        rb = _blocks(r, self.n, nb, bs)
        z = torch.einsum("kij,mkj->mki", self.dinv_blocks, rb)
        return _unblock(z, self.n, r.shape)


def _blocks(r: torch.Tensor, n: int, nb: int, bs: int) -> torch.Tensor:
    """r (m fields of n values, any view) as (m, nb, bs) blocks, the tail
    block padded with zeros."""
    rf = r.reshape(-1, n)
    pad = nb * bs - n
    return (torch.nn.functional.pad(rf, (0, pad)) if pad else rf).reshape(-1, nb, bs)


def _unblock(z: torch.Tensor, n: int, shape) -> torch.Tensor:
    """Inverse of ``_blocks``: drop the tail padding, take ``shape``."""
    z = z.reshape(z.shape[0], -1)
    return (z[:, :n] if z.shape[1] != n else z).reshape(shape)


def _sh_dn(v: torch.Tensor, k: int, fill: float = 0.0) -> torch.Tensor:
    """result[..., j] = v[..., j-k] (entries below the block start read fill)."""
    return torch.cat([torch.full_like(v[..., :k], fill), v[..., :-k]], dim=-1)


def _sh_up(v: torch.Tensor, k: int, fill: float = 0.0) -> torch.Tensor:
    """result[..., j] = v[..., j+k] (entries past the block end read fill)."""
    return torch.cat([v[..., k:], torch.full_like(v[..., -k:], fill)], dim=-1)


@dataclasses.dataclass
class PCRLineJacobi:
    """Exact block-diagonal tridiagonal solve by parallel cyclic reduction:
    the x-line relaxation of PCBJACOBI (bs = nx; on a star only the +-1
    offsets land inside a line block).  ceil(log2 bs) recursive-doubling
    steps, each a few elementwise multiply-adds over the (nb, bs) batch;
    the reduction coefficients depend on the matrix only, so they are
    computed once at setup and an apply replays

        d <- d + alpha_k d_{j-2^k} + gamma_k d_{j+2^k}   (k = 0..L-1)
        x = d / b_final.
    """

    alphas: tuple        # L tensors (nb, bs): lower elimination coefficients
    gammas: tuple        # L tensors (nb, bs): upper elimination coefficients
    binv: torch.Tensor   # (nb, bs): reciprocal of the fully reduced diagonal
    bs: int
    n: int
    shifts: tuple        # L ints, the 2^k ladder

    @classmethod
    def build(cls, lo, d, up, n: int) -> "PCRLineJacobi":
        """Factor the tridiagonal blocks ``lo/d/up`` (nb, bs), with
        ``lo[:, 0] == 0`` and ``up[:, -1] == 0`` at the block boundaries."""
        nb, bs = d.shape
        a, b, c = lo, d, up
        alphas, gammas, shifts = [], [], []
        k = 1
        while k < bs:
            # eliminate the +-k couplings: row j combines rows j-k and j+k.
            # Out-of-block reads: a/c read 0 (no coupling), b reads 1
            # (identity rows) so the divisions stay finite.
            bm, bp = _sh_dn(b, k, 1.0), _sh_up(b, k, 1.0)
            alpha = -a / bm
            gamma = -c / bp
            b = b + alpha * _sh_dn(c, k) + gamma * _sh_up(a, k)
            a, c = alpha * _sh_dn(a, k), gamma * _sh_up(c, k)
            alphas.append(alpha)
            gammas.append(gamma)
            shifts.append(k)
            k *= 2
        return cls(
            alphas=tuple(alphas), gammas=tuple(gammas), binv=1.0 / b, bs=bs, n=n,
            shifts=tuple(shifts),
        )

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """z = inv(blockdiag(tridiag)) @ r: replay the PCR ladder on r.
        Same shape contract as :meth:`BlockJacobi.apply`."""
        nb, bs = self.binv.shape
        d = _blocks(r, self.n, nb, bs)
        for alpha, gamma, k in zip(self.alphas, self.gammas, self.shifts):
            d = d + alpha * _sh_dn(d, k) + gamma * _sh_up(d, k)
        return _unblock(self.binv * d, self.n, r.shape)

"""Device-resident GAMG setup for arbitrary banded (DIA) matrices — port of
``tpusparse/amg/deviceagg.py``.

For matrices that defeat ``infer_grid3d`` (periodic wrap bands, high-order
1-D stencils, irregular offset sets) every setup stage runs on the device
over band arrays, and the cycle has no gather or scatter:

- **Aggregation** is contiguous index segments of size s.  A banded
  matrix's index-adjacent rows are graph-adjacent, so the segments are
  connected aggregates, and the transfers are reshapes and broadcasts
  (``SegTransfer``).
- **The smoothed prolongator** P = (I - omega D^-1 A) T is kept as
  segment bands ``pb[d][i] = P[i, i//s + d]`` over a few coarse
  displacements d, so A_c = P^T (A P) stays O(K) bands wide at every step.
- **The Galerkin contraction** splits by residue class: (i+o)//s - i//s
  depends only on (i mod s, o), so each band product is at most two
  residue-masked terms, and coarse rows are sums over segments.

The JAX package builds each level as one jitted program over static
offsets; here the same static offsets drive plain eager torch.  Its only
host reads are one band-norm fetch a level (to drop negligible bands) and
rho.  Every f32 level apply (rho, the smoothers, the transfers' smoothing)
is K5.  ``-pc_gamg_agg_nsmooths`` 0 or 1 is honoured; ``-pc_gamg_threshold``
does not apply (the aggregation is index-structured).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tpusparse_torch.amg.hierarchy import (
    AMGParams,
    Hierarchy,
    Level,
    dense_coarse_inverse,
    estimate_rho_dinv_a,
)
from tpusparse_torch.kernels.diaband import _shift
from tpusparse_torch.solve.cg import np_float
from tpusparse_torch.sparse.dia import DIA


def _deltas(o: int, s: int) -> tuple[int, ...]:
    """The distinct coarse displacements (m + o)//s over residues m in [0, s)."""
    return tuple(sorted({(m + o) // s for m in range(s)}))


def _residue_mask(n: int, s: int, o: int, d: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """mask[i] = 1 where (i%s + o)//s == d."""
    m = torch.arange(n, device=device) % s
    return (torch.div(m + o, s, rounding_mode="floor") == d).to(dtype)


def _segsum(v: torch.Tensor, s: int, n_c: int) -> torch.Tensor:
    """The sums of v over contiguous segments of size s (v zero-padded),
    along the last axis."""
    pad = n_c * s - v.shape[-1]
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    return v.reshape(*v.shape[:-1], n_c, s).sum(dim=-1)


def _upsample(e: torch.Tensor, s: int, n: int) -> torch.Tensor:
    """e[..., i//s] for i in [0, n): a broadcast, no gather."""
    lead = tuple(e.shape[:-1])
    return e[..., None].expand(*lead, e.shape[-1], s).reshape(*lead, -1)[..., :n]


def _prolongator_bands(bands, offsets, dinv, omega: float, s: int, n: int, w: float, nsmooths: int):
    """P = (I - omega D^-1 A) T as {d: (n,)}, pb[d][i] = P[i, i//s + d],
    with T[i, J] = w [i//s == J]."""
    pb = {0: torch.full((n,), w, dtype=bands.dtype, device=bands.device)}
    if nsmooths == 0:
        return pb
    # (A T)[i, i//s + d] = w * sum_o a_o[i] [(i%s + o)//s == d]
    for k, o in enumerate(offsets):
        for d in _deltas(o, s):
            term = bands[k] * (_residue_mask(n, s, o, d, bands.dtype, bands.device) * w)
            pb[d] = pb.get(d, 0.0) - omega * dinv * term
    return pb


def _ap_bands(bands, offsets, pb: dict, s: int, n: int) -> dict:
    """Q = A P in the same form: qb[d'][i] = Q[i, i//s + d'].  With P[i+o,
    (i+o)//s + d] stored, d' = d + (i%s + o)//s."""
    qb: dict = {}
    for k, o in enumerate(offsets):
        a_o = bands[k]
        for d, pvec in pb.items():
            pshift = _shift(pvec, o, n)  # P[i+o, (i+o)//s + d]
            for dd in _deltas(o, s):
                term = a_o * pshift * _residue_mask(n, s, o, dd, a_o.dtype, a_o.device)
                qb[d + dd] = qb.get(d + dd, 0.0) + term
    return qb


def _ptq_bands(pb: dict, qb: dict, s: int, n: int, n_c: int) -> dict:
    """A_c = P^T Q as coarse bands {e: (n_c,)}: fine row i with i//s + d =
    J' adds pb[d][i] qb[d+e][i] to coarse row J'."""
    ac: dict = {}
    for dp, pvec in pb.items():
        for dq, qvec in qb.items():
            seg = _segsum(pvec * qvec, s, n_c)
            # fine segment g lands at coarse row g + dp
            ac[dq - dp] = ac.get(dq - dp, 0.0) + _shift(seg, -dp, n_c)
    return ac


def coarse_offsets(offsets: tuple[int, ...], s: int, nsmooths: int) -> tuple[int, ...]:
    """The coarse offsets ``_coarsen_once`` fills, from (offsets, s) alone."""
    dp = {0}
    if nsmooths:
        dp |= {d for o in offsets for d in _deltas(o, s)}
    dq = {d + dd for o in offsets for d in dp for dd in _deltas(o, s)}
    return tuple(sorted({q - p for p in dp for q in dq}))


def _coarsen_once(bands, offsets: tuple[int, ...], dinv, omega: float, *, s: int, n: int, nsmooths: int):
    """One Galerkin level: (coarse bands (K_c, n_c), coarse offsets)."""
    n_c = -(-n // s)
    w = float(1.0 / np.sqrt(s))
    if nsmooths == 0:
        # the tentative T^T A T: masked segment sums of the bands with
        # period-s patterns, A_c[I, I+d] = w^2 sum over segment I of a_o[i]
        # where (i%s + o)//s == d; no full-length temporaries of P or Q
        ac: dict = {}
        pad = n_c * s - n
        for k, o in enumerate(offsets):
            a2 = (torch.nn.functional.pad(bands[k], (0, pad)) if pad else bands[k]).reshape(n_c, s)
            for d in _deltas(o, s):
                pat = torch.tensor([float((m + o) // s == d) for m in range(s)], dtype=bands.dtype,
                                   device=bands.device)
                ac[d] = ac.get(d, 0.0) + (a2 * pat).sum(dim=1) * (w * w)
    else:
        pb = _prolongator_bands(bands, offsets, dinv, omega, s, n, w, nsmooths)
        qb = _ap_bands(bands, offsets, pb, s, n)
        ac = _ptq_bands(pb, qb, s, n, n_c)
        del pb, qb
    coffs = tuple(sorted(ac))
    assert coffs == coarse_offsets(offsets, s, nsmooths), (coffs, coarse_offsets(offsets, s, nsmooths))
    cb = torch.stack([ac[e] for e in coffs])
    del ac
    # zero the out-of-frame rows (the DIA convention)
    row = torch.arange(n_c, device=cb.device)
    frame = torch.stack([((row + e) >= 0) & ((row + e) < n_c) for e in coffs])
    return cb * frame.to(cb.dtype), coffs


@dataclasses.dataclass
class SegTransfer:
    """Smoothed-aggregation transfer over contiguous index segments, in
    factored form (the smoothing reuses the level operator's mv, K5):

        restrict(v) = w T0^T (v - omega A D^-1 v)
        prolong(e)  = t - omega D^-1 A t,   t = w T0 e

    with T0 the 0/1 segment injection.  ``w`` and ``omega`` are Python
    floats holding values of the level's dtype; omega 0 (a tentative
    level) skips the smoothing mv, which would subtract exact zeros.  Both
    take a vector or a stack of columns (k, n)."""

    w: float
    omega: float
    s: int
    n_fine: int
    n_coarse: int

    def prolong(self, fine_op, dinv, e_c):
        t = self.w * _upsample(e_c, self.s, self.n_fine)
        if self.omega == 0.0:
            return t
        return t - self.omega * (dinv * fine_op.mv(t))

    def restrict(self, fine_op, dinv, v):
        sm = v if self.omega == 0.0 else v - self.omega * fine_op.mv(dinv * v)
        return self.w * _segsum(sm, self.s, self.n_coarse)


def _pick_seg(seg_size: int | None) -> int:
    """Segment size: an explicit one, else 2.  The once-smoothed
    prolongator reaches one node past its aggregate, so 1-D segments must
    stay short (the JAX package measured 11 CG iterations at s = 2 and 18
    at s = 3 on the 16^3 Poisson matrix treated as banded)."""
    return max(2, int(seg_size)) if seg_size is not None else 2


def gamg_setup_banded_device(
    fine_op: DIA, params=None, seg_size: int | None = None, timings: dict | None = None,
    max_offsets: int = 192, drop_tol: float = 1e-4, smooth_k_cap: int = 12,
    n_smooth_cap: int = 8_000_000,
):
    """Smoothed-aggregation hierarchy of a banded operator, built on its
    device.  A level is smoothed while it has at most ``smooth_k_cap``
    bands and ``n_smooth_cap`` rows, else tentative (the live set of the
    smoothed build grows with n), with the cycle's transfer matched to the
    same P.  Coarse bands whose max |value| is at most ``drop_tol`` times
    the diagonal's are dropped (smoothing widens the pattern by one offset
    a level).  ``timings`` receives "rho", "galerkin" and "device_put"
    seconds."""
    params = params or AMGParams()
    if not isinstance(fine_op, DIA):
        raise ValueError(f"banded-device setup needs a DIA fine operator, got {type(fine_op).__name__}")
    if params.nsmooths not in (0, 1):
        raise ValueError("only nsmooths in {0, 1} supported")
    if params.bjacobi_bs:
        raise ValueError(
            "banded-device setup supports point smoother sub-PCs only (bjacobi blocks need a host CSR"
            " — use the greedy path)"
        )

    tm = {"rho": 0.0, "galerkin": 0.0, "device_put": 0.0}
    levels: list = []
    bands, offsets = fine_op.bands, tuple(fine_op.offsets)
    f = np_float(bands.dtype)
    n = fine_op.shape[0]
    s = _pick_seg(seg_size)
    sync = torch.cuda.synchronize if bands.device.type == "cuda" else (lambda *_: None)
    while True:
        if 0 not in offsets:
            raise ValueError("level operator has no main diagonal")
        dinv = 1.0 / bands[offsets.index(0)]
        d = DIA(bands=bands, offsets=offsets, shape=(n, n))
        t0 = time.perf_counter()
        rho = (estimate_rho_dinv_a(d, dinv, params.rho_iters) * params.rho_safety).item()
        tm["rho"] += time.perf_counter() - t0
        last = (
            n <= params.coarse_eq_limit
            or len(levels) + 1 >= params.max_levels
            or -(-n // s) >= n  # aggregation stalled
        )
        if last:
            levels.append(Level(
                op=d, dinv=dinv, rho=rho, transfer=None,
                coarse_inv=dense_coarse_inverse(d) if params.coarse_solve == "lu" else None,
            ))
            break
        nsm = params.nsmooths if len(offsets) <= smooth_k_cap and n <= n_smooth_cap else 0
        omega = float(f(params.omega_scale) / f(rho)) if nsm == 1 else 0.0
        n_c = -(-n // s)
        levels.append(Level(
            op=d, dinv=dinv, rho=rho,
            transfer=SegTransfer(w=float(f(1.0 / np.sqrt(s))), omega=omega, s=s, n_fine=n, n_coarse=n_c),
        ))
        t0 = time.perf_counter()
        cb, coffs = _coarsen_once(bands, offsets, dinv, omega, s=s, n=n, nsmooths=nsm)
        # drop the structurally zero and the negligible candidate bands:
        # one small host read a level
        norms = cb.abs().amax(dim=1).cpu().numpy()
        dnorm = norms[coffs.index(0)] if 0 in coffs else 1.0
        keep = [i for i, e in enumerate(coffs) if e == 0 or norms[i] > drop_tol * dnorm]
        if len(keep) > max_offsets:
            raise ValueError(
                f"coarse level would occupy {len(keep)} bands > max_offsets={max_offsets}; raise seg_size"
            )
        bands = cb[torch.as_tensor(keep, device=cb.device)]
        del cb
        offsets = tuple(coffs[i] for i in keep)
        n = n_c
        sync(bands.device)
        tm["galerkin"] += time.perf_counter() - t0

    if timings is not None:
        timings.update(tm)
    return Hierarchy(
        levels=levels,
        damping=float(f(params.smooth_damping)),
        smoother=params.smoother,
        degree=params.degree,
        cheby_lo=params.cheby_lo,
        cheby_hi=params.cheby_hi,
    )

"""GAMG setup for general (aij) matrices — port of
``tpusparse/amg/unstructured.py::gamg_setup_unstructured`` and its routes.

``gamg_setup_unstructured`` routes a matrix as the JAX package does
(``choose_route``):

- **geometric**: the sparsity pattern reveals a 3-D grid
  (``amg/geo.py::infer_grid3d``) and no option asks for host work; the
  whole hierarchy is built on the device from the fine DIA
  (``gamg_setup_geo``).
- **banded**: the device-resident segment aggregation of arbitrary banded
  matrices (``amg/deviceagg.py``), on request, or under "auto" when there
  is no host matrix or the fine level has more than ``GREEDY_ROW_LIMIT``
  rows.
- **host**: the setup loop on the host CSR.  Vanek greedy aggregation over
  the strength graph (the C++ engine ``native.py``; geometric index blocks
  when the pattern is a grid), the smoothed prolongator P = (I - omega
  D^-1 A)^k T, the Galerkin product P^T A P by the engine's SpGEMM, and
  rho(D^-1 A) by power iteration on the device.  Levels are DIA, or past
  192 diagonals a ``HybridDIA`` (``sparse/dia.py::auto_container``), or
  ELL on request; transfers are ``FactoredTransfer`` (T's action a gather
  and a fixed-order segment sum), explicit ``ELLTransfer`` matrices, or
  ``GeoTransfer`` contractions on a grid.  The block-Jacobi level smoother
  (``bjacobi_bs``) runs here: each level's blocks come from its host CSR.

Every f32 level apply is K5 (the band part of a ``HybridDIA`` too); the
ELL gathers, the transfers and the segment sums are plain torch, as they
are XLA glue in the JAX package.  No reduction on the apply path uses
float atomics, so a solve gives the same bits on every run.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sp
import torch

from tpusparse_torch import native
from tpusparse_torch.amg.deviceagg import gamg_setup_banded_device
from tpusparse_torch.amg.geo import (
    GeoTransfer,
    coarse_dims,
    gamg_setup_geo,
    geo_aggregate_ids,
    geo_block_sizes,
    infer_grid3d,
)
from tpusparse_torch.amg.hierarchy import (
    AMGParams,
    Hierarchy,
    Level,
    dense_coarse_inverse,
    estimate_rho_dinv_a,
)
from tpusparse_torch.solve.bjacobi import BlockJacobi
from tpusparse_torch.solve.cg import np_float
from tpusparse_torch.sparse.csr import HostCSR
from tpusparse_torch.sparse.dia import DIA, auto_container
from tpusparse_torch.sparse.ell import ELL
from tpusparse_torch.sparse.reorder import distinct_diagonals, occupied_offsets

# Routing threshold of aggregation="auto": above this many fine rows a
# banded matrix takes the device-resident segment aggregation instead of
# the host greedy setup.  The JAX package's value, so that the same options
# build the same hierarchy in both packages.
GREEDY_ROW_LIMIT = 1_500_000


@dataclasses.dataclass
class ELLTransfer:
    """Explicit prolongator / restrictor pair, R = P^T built once at setup."""

    p: ELL  # (n_fine, n_coarse)
    r: ELL  # (n_coarse, n_fine)

    def prolong(self, fine_op, dinv, e_c):
        return self.p.mv(e_c)

    def restrict(self, fine_op, dinv, x):
        return self.r.mv(x)


def member_table(agg: np.ndarray, n_coarse: int) -> np.ndarray:
    """(n_coarse, max aggregate size) int64: row J lists the fine members
    of aggregate J in ascending order, padded with ``len(agg)``, the slot
    of an appended zero.  The restriction sums through it in a fixed order,
    with no float atomics."""
    n = agg.shape[0]
    order = np.argsort(agg, kind="stable")
    sizes = np.bincount(agg, minlength=n_coarse)
    start = np.cumsum(sizes) - sizes
    rank = np.arange(n) - start[agg[order]]
    table = np.full((n_coarse, max(int(sizes.max(initial=1)), 1)), n, np.int64)
    table[agg[order], rank] = order
    return table


@dataclasses.dataclass
class FactoredTransfer:
    """P kept factored, P = (I - omega D^-1 A)^k T, instead of as a matrix.

    T's action is a gather from the coarse vector (``prolong``) and a sum
    over each aggregate's members (``restrict``, through ``members``); the
    smoothing reuses the level operator's mv (K5).  ``nsmooths`` k is
    ``-pc_gamg_agg_nsmooths``: 0 the tentative prolongator, 1 the reference
    configuration, 2 or more one fine mv more per transfer each.  ``omega``
    is a Python float holding a value of the level's dtype.  Both take a
    vector or a stack of columns (k, n)."""

    agg: torch.Tensor      # (n_fine,) int64 aggregate id
    w: torch.Tensor        # (n_fine,) 1/sqrt(|aggregate|) per member
    omega: float           # prolongator-smoothing damping (0 when nsmooths=0)
    members: torch.Tensor  # (n_coarse, max size) int64 (``member_table``)
    n_coarse: int
    nsmooths: int = 1

    def prolong(self, fine_op, dinv, e_c):
        t = self.w * e_c[..., self.agg]
        for _ in range(self.nsmooths):
            t = t - self.omega * (dinv * fine_op.mv(t))
        return t

    def restrict(self, fine_op, dinv, x):
        s = x
        for _ in range(self.nsmooths):
            s = s - self.omega * fine_op.mv(dinv * s)
        v = self.w * s
        v = torch.cat([v, v.new_zeros(*v.shape[:-1], 1)], dim=-1)
        return v[..., self.members].sum(dim=-1)


def strength_graph(a: HostCSR, threshold: float) -> np.ndarray:
    """Boolean strong-connection mask over a's entries (GAMG's
    ``-pc_gamg_threshold``): keep entry (i, j != i) when |a_ij| >
    threshold * sqrt(|a_ii| |a_jj|); threshold 0 keeps every off-diagonal
    connection."""
    rows = np.repeat(np.arange(a.n_rows), a.row_nnz())
    cols = a.indices
    off = rows != cols
    if threshold <= 0.0:
        return off
    d = np.abs(a.diagonal())
    lim = threshold * np.sqrt(d[rows] * d[cols])
    return off & (np.abs(a.data) > lim)


def greedy_aggregate(a: HostCSR, threshold: float = 0.0) -> np.ndarray:
    """Vanek greedy aggregation over the strength graph, by the C++
    engine: the aggregate id of every node (``_greedy_aggregate_py`` is its
    twin)."""
    agg, _ = native.aggregate(a, strength_graph(a, threshold))
    return agg


def _greedy_aggregate_py(a: HostCSR, strong: np.ndarray) -> np.ndarray:
    """Pure-Python twin of the engine's greedy aggregation.  Pass 1: a node
    whose strong neighbourhood is all free roots an aggregate of it; pass
    2: a node still free joins the aggregate of its first aggregated strong
    neighbour (as pass 1 left them); pass 3: the rest root aggregates of
    their free neighbours."""
    n = a.n_rows
    indptr, indices = a.indptr, a.indices
    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0

    def nbrs(i):
        sl = slice(indptr[i], indptr[i + 1])
        return indices[sl][strong[sl]]

    for i in range(n):
        if agg[i] != -1:
            continue
        nb = nbrs(i)
        if np.all(agg[nb] == -1):
            agg[i] = n_agg
            agg[nb] = n_agg
            n_agg += 1
    attach = agg.copy()
    for i in range(n):
        if agg[i] != -1:
            continue
        nb = nbrs(i)
        owned = nb[agg[nb] != -1]
        if owned.size:
            attach[i] = agg[owned[0]]
    agg = attach
    for i in range(n):
        if agg[i] == -1:
            agg[i] = n_agg
            nb = nbrs(i)
            agg[nb[agg[nb] == -1]] = n_agg
            n_agg += 1
    return agg


def tentative_prolongator(agg: np.ndarray):
    """T with l2-normalized piecewise-constant columns (scipy CSR)."""
    n = agg.shape[0]
    n_agg = int(agg.max()) + 1
    sizes = np.bincount(agg, minlength=n_agg).astype(np.float64)
    vals = 1.0 / np.sqrt(sizes[agg])
    return sp.csr_matrix((vals, (np.arange(n), agg)), shape=(n, n_agg))


def _rho_m_a(a_sp, m_apply, iters: int = 25) -> float:
    """Power iteration for rho(M^-1 A) with a host apply ``m_apply``."""
    v = np.sin(np.arange(a_sp.shape[0]) * 0.7 + 0.3)
    v /= np.linalg.norm(v)
    for _ in range(iters):
        w = m_apply(a_sp @ v)
        v = w / np.linalg.norm(w)
    return float(v @ m_apply(a_sp @ v))


def _rho_dinv_a(a_sp, dinv: np.ndarray, iters: int = 25) -> float:
    return _rho_m_a(a_sp, lambda r: dinv * r, iters)


def _ptap(p, a_sp):
    """P^T A P by the engine, as a scipy CSR with duplicates summed and
    zeros dropped."""
    ac = native.ptap(HostCSR.from_scipy(p), HostCSR.from_scipy(a_sp)).to_scipy()
    ac.sum_duplicates()
    ac.eliminate_zeros()
    return ac


def wants_banded(aggregation: str, *, n_rows: int, has_host: bool, has_fine_op: bool,
                 bjacobi_bs: int) -> bool:
    """Whether the banded route is asked for: explicitly, or under "auto"
    with no host matrix or past ``GREEDY_ROW_LIMIT`` rows (and no
    block-Jacobi smoother, which needs the host blocks)."""
    if bjacobi_bs != 0:
        return False
    if aggregation == "banded":
        return True
    return aggregation == "auto" and (
        (not has_host and has_fine_op) or (has_host and n_rows > GREEDY_ROW_LIMIT)
    )


def choose_route(aggregation: str, *, n_rows: int, has_host: bool, has_fine_op: bool,
                 dia_fine: bool, geo_shape, bjacobi_bs: int = 0, device_format: str = "auto",
                 transfer_format: str = "auto", n_diagonals: int | None = None,
                 max_offsets: int = 192) -> str:
    """The JAX package's routing rule (``unstructured.py:246-440``):
    "geometric", "banded" or "host".

    ``geo_shape`` is ``infer_grid3d``'s answer (None under greedy and
    banded, which do not ask).  ``dia_fine``: the fine operator given is a
    DIA; ``n_diagonals``: the host matrix's distinct diagonals, needed
    only where ``wants_banded`` and not ``dia_fine``.  Raises where JAX
    does: geometric without a grid, banded with block Jacobi or past
    ``max_offsets`` diagonals, and no host matrix off the device routes.
    """
    if aggregation not in ("auto", "geometric", "greedy", "banded"):
        raise ValueError(f"unknown aggregation {aggregation!r}")
    if aggregation == "geometric" and geo_shape is None:
        raise ValueError(
            "aggregation='geometric' but the sparsity pattern does not reveal a 3-D grid"
            " (infer_grid3d); use 'auto' or 'greedy'"
        )
    if (
        geo_shape is not None and transfer_format == "auto"
        and device_format in ("auto", "dia") and bjacobi_bs == 0
    ):
        return "geometric"
    if aggregation == "banded" and bjacobi_bs != 0:
        raise ValueError(
            "-pc_gamg_aggregation banded is incompatible with block-Jacobi smoothers"
            " (pc_bjacobi_bs != 0): the device-resident setup has no host factorization path;"
            " use jacobi smoothing or the greedy aggregation"
        )
    if wants_banded(aggregation, n_rows=n_rows, has_host=has_host, has_fine_op=has_fine_op,
                    bjacobi_bs=bjacobi_bs):
        if dia_fine or (has_host and n_diagonals is not None and n_diagonals <= max_offsets):
            return "banded"
        if aggregation == "banded":
            raise ValueError(
                f"aggregation='banded': matrix occupies {n_diagonals} diagonals > max_offsets={max_offsets}"
            )
    if not has_host:
        raise ValueError(
            "no host CSR and the sparsity pattern did not resolve to a device-resident setup"
            " (geometric infer_grid3d / banded segment aggregation); pass the HostCSR for greedy"
            " aggregation"
        )
    return "host"


def gamg_setup_unstructured(
    a: HostCSR | None, params: AMGParams = AMGParams(), dtype=None, *,
    device_format: str = "auto", max_offsets: int = 192, transfer_format: str = "auto",
    timings: dict | None = None, aggregation: str = "auto", fine_op=None, device="cuda",
) -> Hierarchy:
    """The AMG hierarchy of the general matrix ``a`` (a HostCSR or scipy
    matrix, or None when ``fine_op`` is given), routed by
    ``choose_route``.

    ``fine_op``: the fine level's DIA already on its device (the aij
    driver's f32 bands, which the two-float outer operator aliases); its
    offsets stand for the matrix's diagonals, and the host route reuses it
    as level 0 where it is the level the route would build.  Without it
    the levels go to ``device``.  ``dtype``: the levels' numpy dtype
    (default ``fine_op``'s, else the matrix's; the JAX package takes the
    matrix's even beside an f32 ``fine_op``); with ``fine_op`` it must be
    its dtype on the geometric route.

    ``device_format``: the host route's level container, "dia", "ell" or
    "auto" (DIA up to ``max_offsets`` diagonals, else ``auto_container``).
    ``transfer_format``: "factored" (``FactoredTransfer``), "ell"
    (``ELLTransfer``) or "auto" (factored; ``GeoTransfer`` on a grid).
    ``timings``: a dict that receives the setup's seconds ("aggregate",
    "galerkin", "rho", "device_put" on the host route; "rho", "galerkin",
    "device_put" on the banded one; "device_put", "hierarchy_build" on the
    geometric one).
    """
    if params.coarse_solve not in ("jacobi", "lu"):
        raise ValueError(f"unknown coarse_solve {params.coarse_solve!r} (jacobi | lu)")
    if params.nsmooths < 0:
        raise ValueError(f"nsmooths must be >= 0, got {params.nsmooths}")
    if params.smoother == "sor":
        raise ValueError(
            "smoother='sor' (multicolor GS) needs colorable grid operators; the unstructured"
            " DIA/ELL levels have no coloring — use chebyshev/richardson, or the structured path"
        )
    if device_format not in ("auto", "dia", "ell"):
        raise ValueError(f"unknown device_format {device_format!r}")
    if transfer_format not in ("auto", "factored", "ell"):
        raise ValueError(f"unknown transfer_format {transfer_format!r}")
    if fine_op is not None and not hasattr(fine_op, "offsets"):
        raise ValueError(f"fine_op must be a DIA-family operator, got {type(fine_op).__name__}")
    if a is None and fine_op is None:
        raise ValueError("pass the host matrix a or the fine_op DIA")
    if a is not None and not isinstance(a, HostCSR):
        a = HostCSR.from_scipy(a)
    n = a.n_rows if a is not None else fine_op.shape[0]
    dev = fine_op.bands.device if isinstance(fine_op, DIA) else (
        fine_op.hi.device if fine_op is not None else torch.device(device)
    )

    geo_shape = None
    offsets = None
    if aggregation in ("auto", "geometric"):
        offsets = tuple(fine_op.offsets) if fine_op is not None else tuple(occupied_offsets(a).tolist())
        geo_shape = infer_grid3d(offsets, n)
    banded = wants_banded(aggregation, n_rows=n, has_host=a is not None, has_fine_op=fine_op is not None,
                          bjacobi_bs=params.bjacobi_bs)
    dia_fine = isinstance(fine_op, DIA)
    n_diag = None
    if banded and not dia_fine and a is not None:
        n_diag = len(offsets) if offsets is not None else distinct_diagonals(a)
    route = choose_route(
        aggregation, n_rows=n, has_host=a is not None, has_fine_op=fine_op is not None,
        dia_fine=dia_fine, geo_shape=geo_shape, bjacobi_bs=params.bjacobi_bs,
        device_format=device_format, transfer_format=transfer_format, n_diagonals=n_diag,
        max_offsets=max_offsets,
    )
    if dtype is not None:
        want = torch.from_numpy(np.zeros(0, dtype)).dtype
    elif isinstance(fine_op, DIA):
        want = fine_op.dtype
    else:
        want = torch.from_numpy(np.zeros(0, a.data.dtype if a is not None else np.float64)).dtype

    if route == "geometric":
        tm = {}
        t0 = time.perf_counter()
        if fine_op is None:
            fine_op = DIA.from_csr(a, max_offsets=max_offsets, dtype=dtype, device=dev)
        elif dtype is not None and fine_op.dtype != want:
            raise ValueError(f"fine_op dtype {fine_op.dtype} != requested {np.dtype(dtype)}")
        tm["device_put"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        hier = gamg_setup_geo(fine_op, geo_shape, params)
        tm["hierarchy_build"] = time.perf_counter() - t0
        if timings is not None:
            timings.update(tm)
        return hier

    if route == "banded":
        cand = fine_op if dia_fine else DIA.from_csr(a, max_offsets=max_offsets, dtype=dtype, device=dev)
        if dtype is not None and cand.dtype != want:
            cand = DIA(bands=cand.bands.to(want), offsets=cand.offsets, shape=cand.shape)
        tm = {}
        hier = gamg_setup_banded_device(cand, params, timings=tm, max_offsets=max_offsets)
        if timings is not None:
            timings.update(tm)
        return hier

    return _setup_host(
        a, params, want, dev, geo_shape=geo_shape, device_format=device_format, max_offsets=max_offsets,
        transfer_format=transfer_format, timings=timings,
        fine_op=fine_op if dia_fine and fine_op.dtype == want and device_format != "ell" else None,
    )


def _setup_host(a: HostCSR, params: AMGParams, want: torch.dtype, dev, *, geo_shape, device_format: str,
                max_offsets: int, transfer_format: str, timings, fine_op):
    """The host route's level loop (JAX's ``unstructured.py:425-615``), its
    levels in ``want`` on ``dev``."""
    f = np_float(want)
    dtype = np.float32 if want == torch.float32 else np.float64

    def make_op(h):
        if device_format in ("auto", "dia"):
            try:
                return DIA.from_csr(h, max_offsets=max_offsets, dtype=dtype, device=dev)
            except ValueError:
                if device_format == "dia":
                    raise
        if device_format == "auto":
            # heavy diagonals as K5 bands, a thin ELL gather remainder
            return auto_container(h, max_bands=64, dtype=dtype, device=dev)
        return ELL.from_csr(h, dtype=dtype, device=dev)

    native.lib()  # build the engine outside the timed phases
    tm = {"aggregate": 0.0, "galerkin": 0.0, "rho": 0.0, "device_put": 0.0}
    a_sp = a.to_scipy()
    levels: list[Level] = []
    while True:
        n = a_sp.shape[0]
        dinv = 1.0 / a_sp.diagonal()
        bjac = None
        t0 = time.perf_counter()
        if params.bjacobi_bs > 1:
            # the level smoother's sub-PC: inverted bs x bs diagonal blocks;
            # Chebyshev needs rho(M^-1 A), the point-Jacobi P smoothing
            # keeps rho(D^-1 A)
            bjac = BlockJacobi.build(HostCSR.from_scipy(a_sp), params.bjacobi_bs, dtype=dtype, device=dev)
            if hasattr(bjac, "dinv_blocks"):
                inv_np = bjac.dinv_blocks.cpu().numpy().astype(np.float64)
                nb, bs = inv_np.shape[0], params.bjacobi_bs

                def m_apply(r, inv_np=inv_np, nb=nb, bs=bs, n=n):
                    rb = np.pad(r, (0, nb * bs - n)).reshape(nb, bs)
                    return np.einsum("kij,kj->ki", inv_np, rb).reshape(-1)[:n]
            else:  # tridiagonal blocks past the dense cap (PCR)
                def m_apply(r, bjac=bjac):
                    v = torch.as_tensor(r, dtype=want, device=dev)
                    return bjac.apply(v).cpu().numpy().astype(np.float64)

            rho = _rho_m_a(a_sp, m_apply, params.rho_iters) * params.rho_safety
            rho_point = _rho_dinv_a(a_sp, dinv, params.rho_iters) * params.rho_safety
            op_dev = None
        else:
            # rho(D^-1 A) on the device over the level's own container
            tp = time.perf_counter()
            op_dev = fine_op if not levels and fine_op is not None else make_op(HostCSR.from_scipy(a_sp))
            dt_put = time.perf_counter() - tp
            tm["device_put"] += dt_put
            t0 += dt_put
            dinv_dev = torch.as_tensor(dinv, device=dev).to(op_dev.dtype)
            rho = float(estimate_rho_dinv_a(op_dev, dinv_dev, params.rho_iters)) * params.rho_safety
            rho_point = rho
        tm["rho"] += time.perf_counter() - t0
        last = n <= params.coarse_eq_limit or len(levels) + 1 >= params.max_levels
        if not last:
            t0 = time.perf_counter()
            next_geo = bs = None
            if geo_shape is not None:
                # geometric index blocks: no graph walk
                bs = geo_block_sizes(geo_shape, params.factor)
                agg = geo_aggregate_ids(geo_shape, bs)
                next_geo = coarse_dims(geo_shape, bs)
            else:
                agg = greedy_aggregate(HostCSR.from_scipy(a_sp), params.threshold)
            if geo_shape is None and len(levels) < params.aggressive_coarsening:
                # -pc_gamg_aggressive_coarsening: aggregate the tentative
                # coarse graph once more and compose the two maps
                coarse_graph = native.ptap(
                    HostCSR.from_scipy(tentative_prolongator(agg)), HostCSR.from_scipy(a_sp),
                )
                agg = greedy_aggregate(coarse_graph, params.threshold)[agg]
            if agg.max() + 1 >= n:  # aggregation stalled
                last = True
            tm["aggregate"] += time.perf_counter() - t0
        if op_dev is None:  # the block-Jacobi branch built no container yet
            t0 = time.perf_counter()
            op_dev = fine_op if not levels and fine_op is not None else make_op(HostCSR.from_scipy(a_sp))
            tm["device_put"] += time.perf_counter() - t0
        common = dict(
            op=op_dev, dinv=torch.as_tensor(dinv, device=dev).to(op_dev.dtype), rho=float(f(rho)), bjac=bjac,
        )
        if last:
            levels.append(Level(
                transfer=None,
                coarse_inv=dense_coarse_inverse(op_dev) if params.coarse_solve == "lu" else None,
                **common,
            ))
            break
        omega = params.omega_scale / rho_point if params.nsmooths >= 1 else 0.0
        t0 = time.perf_counter()
        # P = (I - omega D^-1 A)^k T: the Galerkin product below takes this
        # same P, so the coarse operators match the transfers exactly
        p = tentative_prolongator(agg)
        dmat = sp.diags(dinv)
        for _ in range(params.nsmooths):
            p = (p - omega * dmat @ (a_sp @ p)).tocsr()
        tm["galerkin"] += time.perf_counter() - t0
        n_c = int(agg.max()) + 1
        sizes = np.bincount(agg, minlength=n_c).astype(np.float64)
        w = torch.as_tensor(1.0 / np.sqrt(sizes[agg]), device=dev).to(op_dev.dtype)
        if geo_shape is not None and transfer_format == "auto" and params.nsmooths <= 1:
            transfer = dataclasses.replace(
                GeoTransfer.build(float(f(omega)), geo_shape, bs, op_dev.dtype, device=dev), w=w,
            )
        elif transfer_format in ("auto", "factored"):
            transfer = FactoredTransfer(
                agg=torch.as_tensor(agg, device=dev), w=w, omega=float(f(omega)),
                members=torch.as_tensor(member_table(agg, n_c), device=dev),
                n_coarse=n_c, nsmooths=params.nsmooths,
            )
        else:
            transfer = ELLTransfer(
                p=ELL.from_csr(p, dtype=dtype, device=dev),
                r=ELL.from_csr(p.T.tocsr(), dtype=dtype, device=dev),
            )
        if geo_shape is not None:
            geo_shape = next_geo  # the Galerkin coarse op keeps 3-D lex order
        levels.append(Level(transfer=transfer, **common))
        t0 = time.perf_counter()
        a_sp = _ptap(p, a_sp)
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
        level_spec=params.level_spec,
    )

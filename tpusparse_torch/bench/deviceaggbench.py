"""The at-scale record of the banded device-resident GAMG setup — port of
``tpusparse/bench/deviceaggbench.py``.

1. **At-scale solve** (default n = 27,000,000, the 300^3 row count): the
   pinned periodic-wrap 1-D Laplacian (offsets 0, +-1, +-(n-1)) is built
   directly on the device as DIA bands, with no host matrix;
   ``gamg_setup_banded_device`` is timed twice (cold: the first call,
   kernel library loaded; warm: the same work again) with its breakdown
   and the device's peak memory, and the system is solved by
   mixed-precision CG + AMG (``cg_refined``, f64 outer) to rtol 1e-8.
   The record holds the iteration counts, the reason, the Linf error
   against the manufactured solution and the true relative residual in
   f64.
2. ``--penalty``: at n = 1e6 and 8e6 the same matrix is set up smoothed
   (the default) and all-tentative (``n_smooth_cap=0``, what the cap does
   to levels above 8M rows), and both iteration counts are recorded.
3. ``--oracle N``: at a host-feasible N the greedy host route sets up the
   same matrix (from a host CSR) and both iteration counts are recorded.

The matrix is the JAX package's, kept for parity, and ``ADVICE.md``'s
finding holds for it: the pin zeroes row and column 0, and the wrap
bands' only in-frame entries are in rows 0 and n-1, so the wrap bands are
structurally present (they defeat ``infer_grid3d``) but numerically zero —
the system is a pinned tridiagonal chain.

Run (the card; ``--device cpu`` runs the kernels' twins at a small n):

    python -m tpusparse_torch.bench.deviceaggbench [n] [--out F] [--penalty] [--oracle N]

Prints one JSON record.  x_true comes from a ``torch.Generator`` seeded
with ``SEED``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tpusparse_torch.amg.deviceagg import gamg_setup_banded_device
from tpusparse_torch.amg.hierarchy import AMGParams, vcycle
from tpusparse_torch.solve.refine import cg_refined
from tpusparse_torch.sparse.dia import DIA

SEED = 0


def periodic_bands(n: int, dtype: torch.dtype, device) -> DIA:
    """The pinned periodic-wrap 1-D Laplacian as DIA bands on ``device``:
    A = 2 I minus the wrap shifts, row and column 0 zeroed but for the
    diagonal (MatZeroRowsColumns).  SPD."""
    offsets = (-(n - 1), -1, 0, 1, n - 1)
    i = torch.arange(n, device=device)

    def off_band(o):
        keep = ((i + o) >= 0) & ((i + o) < n) & (i != 0) & ((i + o) != 0)
        return torch.where(keep, -1.0, 0.0).to(dtype)

    diag = torch.full((n,), 2.0, dtype=dtype, device=device)
    bands = torch.stack([off_band(-(n - 1)), off_band(-1), diag, off_band(1), off_band(n - 1)])
    return DIA(bands=bands, offsets=offsets, shape=(n, n))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _setup(d: DIA, params: AMGParams, **kw):
    tm: dict = {}
    t0 = time.perf_counter()
    hier = gamg_setup_banded_device(d, params, timings=tm, **kw)
    _sync(d.bands.device)
    return hier, time.perf_counter() - t0, tm


def _solve(d64: DIA, hier, rtol: float, maxiter: int = 600) -> dict:
    """The mixed-precision solve of A x = A x_true, x_true ~ N(0, 1)."""
    device = d64.bands.device
    gen = torch.Generator(device=device).manual_seed(SEED)
    x_true = torch.randn(d64.shape[0], generator=gen, dtype=torch.float64, device=device)
    b = d64.mv(x_true)
    op32 = hier.levels[0].op
    _sync(device)
    t0 = time.perf_counter()
    res = cg_refined(d64.mv, op32.mv, b, rtol=rtol, atol=0.0, m_lo_mv=lambda r: vcycle(hier, r),
                     inner_maxiter=maxiter)
    _sync(device)
    t_solve = time.perf_counter() - t0
    rel = (torch.linalg.vector_norm(b - d64.mv(res.x)) / torch.linalg.vector_norm(b)).item()
    return {
        "iters": int(res.iters),
        "outer_iters": int(res.outer_iters),
        "reason": int(res.reason),
        "resnorm": float(res.resnorm),
        "true_rel_residual": rel,
        "linf_vs_manufactured": (res.x - x_true).abs().max().item(),
        "t_solve": t_solve,
    }


def run(n: int, *, device="cuda", rtol: float = 1e-8, penalty: bool = False, oracle: int = 0) -> dict:
    """The record as a dict (``main`` prints it)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    rec: dict = {
        "matrix": "periodic_wrap_laplacian_pin",
        "offsets": [-(n - 1), -1, 0, 1, n - 1],
        "n": n,
        "rtol": rtol,
        "setup_path": "gamg_setup_banded_device",
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
    }
    params = AMGParams()
    d32 = periodic_bands(n, torch.float32, device)
    d64 = periodic_bands(n, torch.float64, device)
    _h, t_cold, _tm = _setup(d32, params)
    del _h
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    hier, t_warm, tm = _setup(d32, params)
    rec["t_setup_cold"] = t_cold
    rec["t_setup_warm"] = t_warm
    rec["setup_breakdown"] = tm
    if cuda:
        rec["peak_gb_setup"] = torch.cuda.max_memory_allocated(device) / 1e9
    rec["levels"] = len(hier.levels)
    rec["level_rows"] = [int(lev.op.shape[0]) for lev in hier.levels][:12]
    rec["level_bands"] = [int(lev.op.bands.shape[0]) for lev in hier.levels][:12]
    rec.update(_solve(d64, hier, rtol))
    if cuda:
        rec["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    del hier, d32, d64

    if penalty:
        pen = {}
        for n_p, tag in ((1_000_000, "1M_rows_100cubed"), (8_000_000, "8M_rows_200cubed")):
            p32 = periodic_bands(n_p, torch.float32, device)
            p64 = periodic_bands(n_p, torch.float64, device)
            h_sm, _, _ = _setup(p32, params)
            h_tn, _, _ = _setup(p32, params, n_smooth_cap=0)
            pen[tag] = {
                "smoothed_iters": _solve(p64, h_sm, rtol)["iters"],
                "tentative_iters": _solve(p64, h_tn, rtol)["iters"],
            }
        rec["tentative_cap_penalty"] = pen

    if oracle:
        import scipy.sparse as sp

        from tpusparse_torch.amg.unstructured import gamg_setup_unstructured
        from tpusparse_torch.sparse.csr import HostCSR

        a = sp.diags([2.0, -1.0, -1.0, -1.0, -1.0], [0, 1, -1, oracle - 1, -(oracle - 1)],
                     shape=(oracle, oracle)).tolil()
        a[0, 1:] = 0.0
        a[1:, 0] = 0.0
        o64 = periodic_bands(oracle, torch.float64, device)
        h_dev, _, _ = _setup(periodic_bands(oracle, torch.float32, device), params)
        t0 = time.perf_counter()
        h_gre = gamg_setup_unstructured(HostCSR.from_scipy(a.tocsr()), params, dtype=np.float32,
                                        aggregation="greedy", device=device)
        _sync(device)
        t_greedy = time.perf_counter() - t0
        rec["oracle"] = {
            "n": oracle,
            "banded_iters": _solve(o64, h_dev, rtol)["iters"],
            "greedy_iters": _solve(o64, h_gre, rtol)["iters"],
            "t_setup_greedy_host": t_greedy,
        }
    return rec


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=27_000_000)
    ap.add_argument("--rtol", type=float, default=1e-8)
    ap.add_argument("--out", default="")
    ap.add_argument("--penalty", action="store_true", help="tentative-cap iteration runs (1M, 8M)")
    ap.add_argument("--oracle", type=int, default=0, help="greedy host comparison at this n")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(args.n, device=args.device, rtol=args.rtol, penalty=args.penalty, oracle=args.oracle)
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return rec


if __name__ == "__main__":
    main()

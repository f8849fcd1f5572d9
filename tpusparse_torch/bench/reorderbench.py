"""The timed record of the arbitrary-sparsity path (RCM reordering and the
padded ELL) — port of ``tpusparse/bench/reorderbench.py``.

Builds the manufactured Poisson system at n^3, RANDOMLY PERMUTED (no grid
pattern, so ``infer_grid3d`` refuses it, and thousands of occupied
diagonals, so the DIA family refuses it), and solves it through ``KSP``
with ``mat_reorder="auto"``: RCM bounds the bandwidth, the reordered
matrix (still past 192 diagonals) goes to the device as the padded
``ELL`` (f64 outer, f32 inner), GAMG's host route makes level 0 a
``HybridDIA`` (its band part kernel K5), and x is unpermuted on the way
out.  Compared against the natural-order solve of the same system: the
iteration counts and the solutions' agreement.

Run (the card; ``--device cpu`` runs the kernels' twins at a small n):

    python -m tpusparse_torch.bench.reorderbench [N] [--pc gamg|jacobi] [--out F]

Prints one JSON record: the JAX package's fields (times unrounded), the
device, the outer sweeps, the natural order's sweeps and reason, and the
kernel launches of the timed reordered solve (``launches``; none on the
CPU, where the wrappers run their twins).  Every timer read follows a
device synchronize.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tpusparse_torch import kernels
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import assemble_poisson
from tpusparse_torch.ksp import KSP
from tpusparse_torch.sparse.reorder import bandwidth, distinct_diagonals, permute_csr, rcm_permutation
from tpusparse_torch.utils.profiling import sync


def run(n: int = 100, *, pc: str = "gamg", rtol: float = 1e-8, maxiter: int = 20000, seed: int = 0,
        skip_natural: bool = False, device="cuda") -> dict:
    """The record as a dict (``main`` prints it)."""
    device = torch.device(device)
    rec: dict = {
        "n": n, "rows": n**3, "pc": pc, "seed": seed,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }

    t0 = time.perf_counter()
    a, b, _exact = assemble_poisson(Grid3D(n, n, n), pin=True)
    p = np.random.default_rng(seed).permutation(a.n_rows)
    scrambled = permute_csr(a, p)
    bp = b[p]
    rec["t_build_permuted_system"] = time.perf_counter() - t0
    rec["bandwidth_scrambled"] = bandwidth(scrambled)
    rec["diagonals_scrambled"] = distinct_diagonals(scrambled)

    t0 = time.perf_counter()
    probe = permute_csr(scrambled, rcm_permutation(scrambled))
    rec["t_rcm_seconds"] = time.perf_counter() - t0
    rec["bandwidth_rcm"] = bandwidth(probe)
    rec["diagonals_rcm"] = distinct_diagonals(probe)
    del probe

    solver = KSP(rtol=rtol, atol=1e-12, maxiter=maxiter, pc_type=pc, precision="mixed")
    t0 = time.perf_counter()
    solver.set_operators(scrambled, device=device)  # runs RCM again: charged to t_init
    sync(device)
    t_init = time.perf_counter() - t0
    rec["reordered"] = solver._perm is not None
    rec["container"] = type(solver._op_lo).__name__
    t0 = time.perf_counter()
    solver.setup()
    sync(device)
    t_setup = time.perf_counter() - t0
    rec["container_level0"] = type(solver._op_lo).__name__
    b_dev = torch.as_tensor(bp, device=device)
    solver.solve(b_dev)  # first-call costs, outside the timed solve
    sync(device)
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    res = solver.solve(b_dev)
    sync(device)
    t_solve = time.perf_counter() - t0
    rec.update(
        iters=res.iters, outer_iters=res.outer_iters, reason=res.reason, resnorm=res.resnorm,
        t_init=t_init, t_setup=t_setup, t_solve=t_solve,
        launches={k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items() if v > before.get(k, 0)},
    )

    if not skip_natural:
        natural = KSP(rtol=rtol, atol=1e-12, maxiter=maxiter, pc_type=pc, precision="mixed")
        natural.set_operators(a, device=device)
        b_nat = torch.as_tensor(b, device=device)
        natural.solve(b_nat)
        sync(device)
        t0 = time.perf_counter()
        r0 = natural.solve(b_nat)
        sync(device)
        rec["natural_t_solve"] = time.perf_counter() - t0
        rec["natural_iters"] = r0.iters
        rec["natural_outer_iters"] = r0.outer_iters
        rec["natural_reason"] = r0.reason
        rec["x_agreement_linf"] = (res.x - r0.x[torch.as_tensor(p, device=device)]).abs().max().item()
    return rec


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=100)
    ap.add_argument("--pc", default="gamg", choices=["gamg", "jacobi"])
    ap.add_argument("--rtol", type=float, default=1e-8)
    ap.add_argument("--maxiter", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--skip-natural", action="store_true", help="skip the natural-order comparison solve")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(args.n, pc=args.pc, rtol=args.rtol, maxiter=args.maxiter, seed=args.seed,
              skip_natural=args.skip_natural, device=args.device)
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return rec


if __name__ == "__main__":
    main()

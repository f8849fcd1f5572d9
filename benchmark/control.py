"""Readings for the limits of ``correct``: the sound program and its control.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 --steps 2 --precision mixed,f32

For each precision in turn, builds the cell's system once at the cell's
size (the problem's ``build``, the configuration's precision overridden),
solves ``--steps`` right-hand sides for each seed, and judges each
solution by the problem's plain reference as ``run.py`` does, printing
one line a solve and the largest ||b - A x|| / ||b|| a precision.  The j-th seed solves steps
j * steps ... (j + 1) * steps - 1 of its stream, so that the seeds
together cover that many distinct fields (every seed's stream holds the
same fields, each under its own sign and scale).  "mixed" is the
configuration as stated, whose readings give the lower reading; "f32" is
the program's own uniform float32 path, the nearest precision below the
configuration's float64 defect correction: the control, whose smallest
reading is the upper one.  Not part of a
benchmark run.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from benchmark import rhs, spec


def readings(cell, precision: str, seeds: list[int], steps: int, device) -> list[float]:
    """||b - A x|| / ||b|| of each (seed, step) solve at ``precision``."""
    config, mix = cell.config, cell.traffic
    t0 = time.perf_counter()
    problem = spec.load_problem(cell.family, cell.root)
    sys_ = problem.build(config, device, precision=precision)
    print(f"{precision}: built in {time.perf_counter() - t0:.2f} s; {sys_.describe()}", flush=True)
    ref = problem.reference(config)
    out = []
    for j, seed in enumerate(seeds):
        for step in range(j * steps, (j + 1) * steps):
            b = rhs.make_rhs(mix, sys_.shape, seed, step, device=device)
            t0 = time.perf_counter()
            r = sys_.ksp.solve(sys_.encode(b))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
            rnorm, bnorm = ref.residual(r.x, b)
            out.append(rnorm / bnorm)
            print(f"{precision} seed {seed} step {step}: {r.iters} inner in"
                  f" {r.outer_iters} sweeps, reason {r.reason}, {seconds:.4f} s, ||b - A x|| / ||b|| ="
                  f" {out[-1]!r}", flush=True)
    del sys_
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(f"{precision}: largest {max(out)!r}, smallest {min(out)!r} over {len(out)} solves", flush=True)
    return out


def main(argv=None, *, device=None, config_overrides=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--precision", default="mixed,f32", help="comma-separated: mixed, f32, f64")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    cell.config = {**cell.config, **(config_overrides or {})}
    if device is None:
        if not torch.cuda.is_available():
            print("benchmark.control: no CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",")]
    for precision in args.precision.split(","):
        readings(cell, precision, seeds, args.steps, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

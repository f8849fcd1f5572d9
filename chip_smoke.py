"""Smoke test of the PyTorch/CUDA port (``tpusparse_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed before the last line; any failure raises and the
script exits non-zero without the final line:

1. Require a CUDA device; print its name and power limit (nvidia-smi).
2. Build the CUDA kernels from ``tpusparse_torch/csrc`` (nvcc, sm_90a).
3. Hold every kernel of the main path (K1 star7_mv_padded, K2 fused7_mvdot,
   K3 fused7_descent_rr, K4 fused7_ascent_rz) against its plain PyTorch
   twin on the card, at the ragged shape (40, 11, 13) and at 300^3, on
   inputs made with numpy from a fixed seed; time both at 300^3 with CUDA
   events.  Each output field must agree to rtol 1e-5, atol 1e-6 of its
   own max|want| (tests/test_fused7.py:53-69 without its 1e-3 floor, which
   would exceed the whole range of K3's x1); dots to 1e-5 relative.
4. A 24^3 solve must reproduce the JAX package's outcome at that size
   (24 +- 1 inner / 2 outer iterations, reason 2, Linf 1.117e-2).
5. The main path: ``solve_poisson(300, rtol=1e-8, atol=1e-12, pc="gamg",
   device="cuda")`` with the launch counters reset just before it.  It must
   converge with reason 2 in 3 outer and 34 +- 2 inner iterations, with
   Linf < 1e-4, and launch every kernel at least once.

Then one JSON line with each kernel's route, source, launches, error and
times, and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tpusparse_torch import kernels
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil_device
from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.fused7 import (
    fused7_ascent_rz,
    fused7_ascent_rz_torch,
    fused7_descent_rr,
    fused7_descent_rr_torch,
    fused7_mvdot,
    fused7_mvdot_torch,
)
from tpusparse_torch.kernels.stencil7 import star7_mv_padded, star7_mv_padded_torch
from tpusparse_torch.sparse.padded import PaddedStar, pad_field

SEED = 7
SHAPES = ((40, 11, 13), (300, 300, 300))
# the fused-kernel scalars of tests/test_fused7.py:32-36
G, AD, S0, GW, G2 = 0.731, 0.377, 1.618, 0.243, 0.519

KERNELS = {
    "star7_mv_padded": (
        "tpusparse_torch/csrc/stencil7.cu", "tpusparse/kernels/stencil7.py:108",
        star7_mv_padded, star7_mv_padded_torch,
    ),
    "fused7_mvdot": (
        "tpusparse_torch/csrc/fused7.cu", "tpusparse/kernels/fused7.py:515",
        fused7_mvdot, fused7_mvdot_torch,
    ),
    "fused7_descent_rr": (
        "tpusparse_torch/csrc/fused7.cu", "tpusparse/kernels/fused7.py:575",
        fused7_descent_rr, fused7_descent_rr_torch,
    ),
    "fused7_ascent_rz": (
        "tpusparse_torch/csrc/fused7.cu", "tpusparse/kernels/fused7.py:674",
        fused7_ascent_rz, fused7_ascent_rz_torch,
    ),
}


def _inputs(shape, device):
    """(args per kernel) at ``shape``: the pinned f32 Poisson operator and
    random padded fields from a fixed numpy seed."""
    grid = Grid3D(shape[2], shape[1], shape[0])
    op = PaddedStar.from_star(
        poisson_stencil_device(grid, dtype=torch.float32, device=device)[0]
    )
    rng = np.random.default_rng(SEED)

    def field():
        return pad_field(torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(device))

    x, b, t, x1 = field(), field(), field(), field()
    legs = (op.diag, op.cx, op.cy, op.cz)
    pin = (shape, op.pinned)
    return {
        "star7_mv_padded": (*legs, x, *pin),
        "fused7_mvdot": (*legs, x, *pin),
        "fused7_descent_rr": (*legs, b, S0, AD, G, GW, *pin),
        "fused7_ascent_rz": (*legs, t, b, x1, G, AD, G2, GW, *pin),
    }


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _compare(name, got, want) -> float:
    """Raise unless ``got`` matches ``want``; return the max abs field error."""
    err = 0.0
    for g, w in zip(_as_tuple(got), _as_tuple(want)):
        if w.dim() == 0:  # a fused dot
            rel = abs(g.item() - w.item()) / max(abs(w.item()), 1e-30)
            if rel > 1e-5:
                raise AssertionError(f"{name}: dot {g.item()} vs {w.item()} (rel {rel:.2e})")
            continue
        # atol from this output's own range, so that a small field such as
        # K3's x1 is held to its own scale
        atol = 1e-6 * w.abs().max().item()
        torch.testing.assert_close(g, w, rtol=1e-5, atol=atol, msg=lambda m: f"{name}: {m}")
        err = max(err, (g - w).abs().max().item())
    return err


def _time_ms(fn, args, reps=12, per=5) -> float:
    """Median over ``reps`` of the mean time of ``per`` back-to-back calls."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def check_kernels(device) -> dict:
    """Phase 3: every kernel vs its twin at each shape; times at the last."""
    rows = {}
    for shape in SHAPES:
        args = _inputs(shape, device)
        for name, (_src, _rep, kernel, twin) in KERNELS.items():
            got = kernel(*args[name])
            want = twin(*args[name])
            torch.cuda.synchronize()
            err = _compare(f"{name} {shape}", got, want)
            row = rows.setdefault(name, {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            print(f"kernel {name} {shape}: agrees with its twin, max abs err {err:.3e}")
        if shape == SHAPES[-1]:
            for name, (_src, _rep, kernel, twin) in KERNELS.items():
                rows[name]["ms"] = _time_ms(kernel, args[name])
                rows[name]["plain_ms"] = _time_ms(twin, args[name])
                print(
                    f"time {name} {shape}: kernel {rows[name]['ms']:.4f} ms,"
                    f" plain {rows[name]['plain_ms']:.4f} ms"
                )
        del args
        torch.cuda.empty_cache()
    return rows


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip())
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({lib.name})")

    rows = check_kernels(device)

    small = solve_poisson(24, rtol=1e-8, atol=1e-12, pc="gamg", device=device)
    print(f"24^3: {small.json_sidecar()}")
    # inner within +-1: the card sums the dots in another order
    _require(
        (small.reason, small.outer_iters) == (2, 2)
        and abs(small.iters - 24) <= 1
        and abs(small.linf_error - 1.117e-2) < 1e-5,
        "24^3 solve differs from the JAX package's (24 inner, 2 outer, reason 2, Linf 1.117e-2)",
    )

    kernels.reset_launches()
    rep = solve_poisson(300, rtol=1e-8, atol=1e-12, pc="gamg", device=device)
    launches = dict(kernels.LAUNCHES)
    print(rep.reference_block())
    print(rep.converged_reason_line())
    print(rep.json_sidecar())
    print(f"launches: {json.dumps(launches)}")
    _require(rep.reason == 2, f"reason {rep.reason} != 2")
    _require(np.isfinite(rep.linf_error) and rep.linf_error < 1e-4, f"Linf {rep.linf_error} >= 1e-4")
    _require(rep.outer_iters == 3, f"outer iterations {rep.outer_iters} != 3")
    _require(abs(rep.iters - 34) <= 2, f"inner iterations {rep.iters} not within 34 +- 2")
    for name, n in launches.items():
        _require(n > 0, f"kernel {name} was not launched by the main path")

    print(json.dumps({"kernels": [
        {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rows[name]["max_abs_err"],
            "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
        }
        for name, (src, replaces, _k, _t) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

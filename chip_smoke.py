"""Smoke test of the PyTorch/CUDA port (``tpusparse_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed before the last line; any failure raises and the
script exits non-zero without the final line:

1. Require a CUDA device; print its name and power limit (nvidia-smi).
2. Build the CUDA kernels from ``tpusparse_torch/csrc`` (nvcc, sm_90a).
3. Hold every kernel of the stencil path (K1 star7_mv_padded, K2
   fused7_mvdot, K3 fused7_descent_rr, K4 fused7_ascent_rz) against its
   plain PyTorch twin on the card, at the ragged shape (40, 11, 13) and at
   300^3, on inputs made with numpy from a fixed seed; time both at 300^3
   with CUDA events.  Each output field must agree to rtol 1e-5, atol 1e-6
   of its own max|want| (tests/test_fused7.py:53-69 without its 1e-3 floor,
   which would exceed the whole range of K3's x1); dots to 1e-5 relative.
4. A 24^3 stencil solve must reproduce the JAX package's outcome at that
   size (24 +- 1 inner / 2 outer iterations, reason 2, Linf 1.117e-2).
5. The stencil path: ``solve_poisson(300, rtol=1e-8, atol=1e-12, pc="gamg",
   device="cuda")`` with the launch counters reset just before it.  It must
   converge with reason 2 in 3 outer and 34 +- 2 inner iterations, with
   Linf < 1e-4, and launch K1-K4 at least once each.
6. K5 (dia_mv, the general-matrix path's banded SpMV) against its plain
   twin on the card, on numpy inputs from the same seed: the 7 Poisson star
   offsets and a 27-band set with offsets that leave the matrix at the
   ragged n = 40*11*13, then n = 300^3 with K = 7 (the fine level) and
   n = 100^3 with K = 27 (level 1), both timed; rtol 1e-5, atol 1e-6 of
   max|want|.
7. A 24^3 aij solve (``mat_type="aij"``, the structure-blind route) must
   reproduce the JAX package's CPU outcome (24 +- 1 inner / 2 outer,
   reason 2, Linf 1.117e-2 +- 1e-5).
8. The general-matrix path at full size: the same 300^3 solve with
   ``mat_type="aij"``, launch counters reset just before it.  Reason 2,
   Linf < 1e-4, 35 +- 2 inner in 2-3 outer sweeps, K5 launched and K1-K4
   not (the structure-blind route ran).

9. The kernels of the reference config's smoother and of the non-CG
   solvers (K6 fused7_descent1_rr, K7 fused7_ascent1_rz and the dot-free
   K3' fused7_descent, K4' fused7_ascent, K6' fused7_descent1, K7'
   fused7_ascent1) against their twins as in phase 3, timed at 300^3.
10. The reference's own entry point at 300^3, in process:
   ``tpusparse_torch.__main__.main([... "-config",
   "configs/SolverOptions_GAMG.info", "-ksp_converged_reason",
   "-log_view"])`` (CG + GAMG with Richardson(1), rtol 1e-14), launch
   counters reset just before.  Its JSON sidecar must show a positive
   reason (CONVERGED_STALLED, 100, is one: the f64 true-residual floor),
   Linf < 1e-4 and the port's own counts (767 +- 40 inner in 4-6 sweeps);
   K6 and K7 launched, K3 and K4 not.
11. ``-ksp_type gmres`` through the CLI at 300^3, rtol 1e-8 (Chebyshev(2)):
   positive reason, Linf < 1e-4, K3'/K4' launched.
12. ``-ksp_type bcgs`` with the reference config at 48^3: positive reason,
   Linf < 3e-3 (the discretization error there is 2.84e-3), K6'/K7'
   launched.  Not 100^3: there BiCGStab over the Richardson(1) V-cycle
   fails in both packages (PERF.md).

Then one JSON line with each kernel's route, source, launches (K1-K4 from
phase 5, K5 from phase 8, K6/K7 from phase 10, K3'/K4' from phase 11,
K6'/K7' from phase 12), error and times, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tpusparse_torch import kernels
from tpusparse_torch.__main__ import main as cli_main
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil_device
from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.diaband import dia_mv, dia_mv_torch
from tpusparse_torch.kernels.fused7 import (
    fused7_ascent,
    fused7_ascent1,
    fused7_ascent1_rz,
    fused7_ascent1_rz_torch,
    fused7_ascent1_torch,
    fused7_ascent_rz,
    fused7_ascent_rz_torch,
    fused7_ascent_torch,
    fused7_descent,
    fused7_descent1,
    fused7_descent1_rr,
    fused7_descent1_rr_torch,
    fused7_descent1_torch,
    fused7_descent_rr,
    fused7_descent_rr_torch,
    fused7_descent_torch,
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
STENCIL_KERNELS = tuple(KERNELS)
KERNELS["dia_mv"] = (
    "tpusparse_torch/csrc/diaband.cu", "tpusparse/kernels/diaband.py:248",
    dia_mv, dia_mv_torch,
)
FUSED7_SRC = "tpusparse_torch/csrc/fused7.cu"
NEW_KERNELS = {
    "fused7_descent1_rr": (FUSED7_SRC, "tpusparse/kernels/fused7.py:632",
                           fused7_descent1_rr, fused7_descent1_rr_torch),
    "fused7_ascent1_rz": (FUSED7_SRC, "tpusparse/kernels/fused7.py:650",
                          fused7_ascent1_rz, fused7_ascent1_rz_torch),
    "fused7_descent": (FUSED7_SRC, "tpusparse/kernels/fused7.py:575",
                       fused7_descent, fused7_descent_torch),
    "fused7_ascent": (FUSED7_SRC, "tpusparse/kernels/fused7.py:674",
                      fused7_ascent, fused7_ascent_torch),
    "fused7_descent1": (FUSED7_SRC, "tpusparse/kernels/fused7.py:632",
                        fused7_descent1, fused7_descent1_torch),
    "fused7_ascent1": (FUSED7_SRC, "tpusparse/kernels/fused7.py:650",
                       fused7_ascent1, fused7_ascent1_torch),
}
KERNELS.update(NEW_KERNELS)
REF_CONFIG = str(pathlib.Path(__file__).resolve().parent / "configs" / "SolverOptions_GAMG.info")
# the port's own outcome of the 300^3 reference-config solve on the H100
# (PERF.md): 767 inner in 5 sweeps, CONVERGED_STALLED.  With Richardson(1)
# the inner count follows the dots' summation order (PERF.md): 5% of it,
# and a sweep either way
REF_INNER, REF_INNER_WINDOW, REF_OUTER = 767, 40, (4, 5, 6)


def _star_offsets(nz, ny, nx):
    return (-ny * nx, -nx, -1, 0, 1, nx, ny * nx)


def _box_offsets(nz, ny, nx):
    """The 27 offsets of a geometric Galerkin level, ascending."""
    return tuple(sorted(
        dz * ny * nx + dy * nx + dx
        for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
    ))


RAGGED = 40 * 11 * 13
# (label, n, offsets, timed): the star and a 27-band set with offsets that
# leave the matrix at both ends at a ragged n, then the aij path's fine
# level (300^3, K = 7) and level 1 (100^3, K = 27)
DIA_CASES = (
    ("star7 n=40*11*13", RAGGED, _star_offsets(40, 11, 13), False),
    ("27-band n=40*11*13", RAGGED,
     (-(RAGGED - 1),) + _box_offsets(40, 11, 13)[1:-1] + (RAGGED - 1,), False),
    ("star7 n=300^3", 300**3, _star_offsets(300, 300, 300), True),
    ("box27 n=100^3", 100**3, _box_offsets(100, 100, 100), True),
)


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
        "fused7_descent": (*legs, b, S0, AD, G, GW, *pin),
        "fused7_ascent": (*legs, t, b, x1, G, AD, G2, GW, *pin),
        "fused7_descent1_rr": (*legs, b, G, GW, *pin),
        "fused7_ascent1_rz": (*legs, t, b, x1, G, GW, *pin),
        "fused7_descent1": (*legs, b, G, GW, *pin),
        "fused7_ascent1": (*legs, t, b, x1, G, GW, *pin),
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


def check_kernels(device, names=STENCIL_KERNELS) -> dict:
    """Phases 3 and 9: each kernel of ``names`` vs its twin at each shape;
    times at the last."""
    rows = {}
    for shape in SHAPES:
        args = _inputs(shape, device)
        for name in names:
            _src, _rep, kernel, twin = KERNELS[name]
            got = kernel(*args[name])
            want = twin(*args[name])
            torch.cuda.synchronize()
            err = _compare(f"{name} {shape}", got, want)
            row = rows.setdefault(name, {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            print(f"kernel {name} {shape}: agrees with its twin, max abs err {err:.3e}")
        if shape == SHAPES[-1]:
            for name in names:
                _src, _rep, kernel, twin = KERNELS[name]
                rows[name]["ms"] = _time_ms(kernel, args[name])
                rows[name]["plain_ms"] = _time_ms(twin, args[name])
                print(
                    f"time {name} {shape}: kernel {rows[name]['ms']:.4f} ms,"
                    f" plain {rows[name]['plain_ms']:.4f} ms"
                )
        del args
        torch.cuda.empty_cache()
    return rows


def check_dia(device) -> dict:
    """Phase 6: K5 against its twin at each case; times at the timed ones."""
    row = {"max_abs_err": 0.0}
    rng = np.random.default_rng(SEED)
    for label, n, offsets, timed in DIA_CASES:
        bands = torch.from_numpy(rng.standard_normal((len(offsets), n), dtype=np.float32)).to(device)
        x = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(device)
        got = dia_mv(bands, x, offsets)
        want = dia_mv_torch(bands, x, offsets)
        torch.cuda.synchronize()
        err = _compare(f"dia_mv {label}", got, want)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        print(f"kernel dia_mv {label} (K={len(offsets)}): agrees with its twin, max abs err {err:.3e}")
        if timed:
            ms = _time_ms(dia_mv, (bands, x, offsets))
            plain_ms = _time_ms(dia_mv_torch, (bands, x, offsets))
            gbs = (len(offsets) + 2) * n * 4 / (ms * 1e-3) / 1e9
            print(f"time dia_mv {label} (K={len(offsets)}): kernel {ms:.4f} ms"
                  f" ({gbs:.1f} GB/s of (K+2)*n*4 bytes), plain {plain_ms:.4f} ms")
            # the JSON line carries the fine level's times (the first timed case)
            row.setdefault("ms", ms)
            row.setdefault("plain_ms", plain_ms)
        del bands, x, got, want
        torch.cuda.empty_cache()
    return row


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def run_cli(argv: list[str]) -> tuple[dict, dict]:
    """The port's CLI in process with the launch counters reset just
    before: (its JSON sidecar, the launches it made).  Prints its output."""
    kernels.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    launches = dict(kernels.LAUNCHES)
    text = out.getvalue()
    print(text, end="")
    print(f"launches: {json.dumps({k: v for k, v in launches.items() if v})}")
    _require(rc == 0, f"{argv}: exit code {rc}")
    side = [line for line in text.splitlines() if line.startswith("JSON: ")]
    _require(len(side) == 1, f"{argv}: no JSON sidecar")
    return json.loads(side[0][len("JSON: "):]), launches


def _grid(n: int) -> list[str]:
    return ["-da_grid_x", str(n), "-da_grid_y", str(n), "-da_grid_z", str(n)]


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
    for name in STENCIL_KERNELS:
        _require(launches[name] > 0, f"kernel {name} was not launched by the stencil path")
    rows["dia_mv"] = check_dia(device)

    aij = dict(rtol=1e-8, atol=1e-12, pc="gamg", mat_type="aij")
    small = solve_poisson(24, device=device, **aij)
    print(f"24^3 aij: {small.json_sidecar()}")
    _require(
        (small.reason, small.outer_iters) == (2, 2)
        and abs(small.iters - 24) <= 1
        and abs(small.linf_error - 1.117e-2) < 1e-5,
        "24^3 aij solve differs from the JAX package's (24 inner, 2 outer, reason 2, Linf 1.117e-2)",
    )

    kernels.reset_launches()
    rep = solve_poisson(300, device=device, **aij)
    aij_launches = dict(kernels.LAUNCHES)
    print(rep.reference_block())
    print(rep.converged_reason_line())
    print(rep.json_sidecar())
    print(f"launches (aij): {json.dumps(aij_launches)}")
    _require(rep.reason == 2, f"aij reason {rep.reason} != 2")
    _require(np.isfinite(rep.linf_error) and rep.linf_error < 1e-4, f"aij Linf {rep.linf_error} >= 1e-4")
    # 35 + 2 in f32 (the TPU's 42 + 3 differs; the JAX package in f32 on
    # the CPU takes the port's counts at 100^3 and 200^3: PERF.md,
    # Findings).  The outer count sits on the rho start vector's knife edge.
    _require(rep.outer_iters in (2, 3), f"aij outer iterations {rep.outer_iters} not in 2-3")
    _require(abs(rep.iters - 35) <= 2, f"aij inner iterations {rep.iters} not within 35 +- 2")
    _require(aij_launches["dia_mv"] > 0, "dia_mv was not launched by the aij path")
    for name in STENCIL_KERNELS:
        _require(aij_launches[name] == 0, f"the aij path launched the stencil kernel {name}")
    launches["dia_mv"] = aij_launches["dia_mv"]

    rows.update(check_kernels(device, tuple(NEW_KERNELS)))

    t0 = time.perf_counter()
    ref, ref_launches = run_cli(
        [*_grid(300), "-config", REF_CONFIG, "-ksp_converged_reason", "-log_view"]
    )
    print(f"reference config 300^3: {time.perf_counter() - t0:.1f} s in all")
    _require(ref["reason"] > 0, f"reference config: reason {ref['reason']} is not positive")
    _require(np.isfinite(ref["linf_error"]) and ref["linf_error"] < 1e-4,
             f"reference config: Linf {ref['linf_error']} >= 1e-4")
    _require(abs(ref["iters"] - REF_INNER) <= REF_INNER_WINDOW and ref["outer_iters"] in REF_OUTER,
             f"reference config: {ref['iters']} inner + {ref['outer_iters']} outer, not"
             f" {REF_INNER} +- {REF_INNER_WINDOW} in {REF_OUTER}")
    for name in ("fused7_descent1_rr", "fused7_ascent1_rz"):
        _require(ref_launches[name] > 0, f"the reference config did not launch {name}")
    for name in ("fused7_descent_rr", "fused7_ascent_rz"):
        _require(ref_launches[name] == 0, f"the reference config launched {name}")

    gm, gm_launches = run_cli([*_grid(300), "-ksp_type", "gmres", "-ksp_rtol", "1e-8",
                               "-ksp_atol", "1e-12", "-ksp_converged_reason"])
    _require(gm["reason"] > 0, f"gmres: reason {gm['reason']} is not positive")
    _require(np.isfinite(gm["linf_error"]) and gm["linf_error"] < 1e-4,
             f"gmres: Linf {gm['linf_error']} >= 1e-4")
    for name in ("fused7_descent", "fused7_ascent"):
        _require(gm_launches[name] > 0, f"gmres did not launch {name}")

    bc, bc_launches = run_cli([*_grid(48), "-config", REF_CONFIG, "-ksp_type", "bcgs",
                               "-ksp_converged_reason"])
    _require(bc["reason"] > 0, f"bcgs: reason {bc['reason']} is not positive")
    _require(np.isfinite(bc["linf_error"]) and bc["linf_error"] < 3e-3,
             f"bcgs: Linf {bc['linf_error']} >= 3e-3")
    for name in ("fused7_descent1", "fused7_ascent1"):
        _require(bc_launches[name] > 0, f"bcgs did not launch {name}")
    for names, runs in (
        (("fused7_descent1_rr", "fused7_ascent1_rz"), ref_launches),
        (("fused7_descent", "fused7_ascent"), gm_launches),
        (("fused7_descent1", "fused7_ascent1"), bc_launches),
    ):
        for name in names:
            launches[name] = runs[name]

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

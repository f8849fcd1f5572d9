"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's GPUs:

1. brings up the card and loads the port's kernel library (built into
   ``tpusparse_torch/csrc/build/`` at a checkout's first run);
2. builds the configuration's operator on the device and ``KSP`` with its
   preconditioner (``KSPSetOperators`` + ``KSPSetUp``), once, by the
   configuration's problem (``problems/<family>.py``);
3. warms up with untimed steps of the same shapes;
4. runs the closed loop for ``--seconds``: each step makes the mix's next
   right-hand side from the seed, waits for the device, then solves it,
   timed from the call to the synchronised return; the loop ends with the
   step that crosses ``--seconds``; with ``--trace 1`` the first solves
   run under the profiler, each marked by a span of its own;
5. reads the peak device memory, frees the program's state and checks a
   sample of the window's solutions, drawn from the seed, against the
   problem's plain reference (``reference/``);
6. prints the solves on earlier lines, each number compared beside its
   limit as the last lines of standard error, and one JSON line last on
   standard output: the end-to-end metrics with ``--trace 0``, the
   per-layer metrics with ``--trace 1``.

Exits 2 without a result when no GPU (or too few) is present, and 3 when
JAX or the JAX package ``tpusparse`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpusparse")  # top-level module names, compared whole
SMI_FIELDS = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,power.draw,temperature.gpu"
NOTES = ("name", "source", "problem", "guarantees", "assumed", "reduced")  # a configuration's prose, not logged


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def smi_line() -> str:
    """The card's name, power limit, clocks, draw and temperature."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi: not found"
    out = subprocess.run([exe, "-i", "0", f"--query-gpu={SMI_FIELDS}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return f"nvidia-smi ({SMI_FIELDS}): {out.stdout.strip() or out.stderr.strip()}"


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    solves: list[dict]       # one a step: step, iters, outer_iters, reason, seconds, make_seconds, traced
    window_s: float          # the window's seconds, from its start to the close
    trace: object = None     # trace.Trace of the traced steps (--trace 1 on a GPU)
    launches: list | None = None  # roofline.LaunchRecorder's launches in the traced steps
    models: list | None = None
    peak: dict | None = None  # peaks.json's row for this card


def log(message: str) -> None:
    """A set-up line, stamped with the seconds since the process started."""
    print(f"[{time.perf_counter() - T_START:8.3f} s] {message}", flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device=None, root=None, config_overrides=None) -> int:
    """The command.  ``device``, ``root`` and ``config_overrides`` are for
    the tests on the CPU: a device other than the GPU, a checkout with
    added files, and a smaller grid."""
    args = parse(argv)
    from benchmark import spec

    cell = spec.load_cell(args.workload, root or spec.REPO)
    problem = spec.load_problem(cell.family, cell.root)
    config = {**cell.config, **(config_overrides or {})}
    mix = cell.traffic

    import torch

    from benchmark import rhs, roofline, trace

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s), found {count}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    tracing = bool(args.trace)

    # -- set-up -----------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False  # the transfer einsums stay float32
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        from tpusparse_torch.kernels import _build

        torch.cuda.set_device(device)
        torch.zeros((), device=device)  # the context
        log(smi_line())
        log(f"kernel library: {_build.build()}")
    settings = {k: v for k, v in config.items() if k not in NOTES}
    log(f"cell {cell.name}: problem {cell.family}, config {json.dumps(settings)}; mix {json.dumps(mix)}")
    sys_ = problem.build(config, device)
    log(f"{math.prod(sys_.shape)} unknowns; {sys_.describe()}")

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def make(index):
        """The step's right-hand side, made and waited for."""
        b = sys_.encode(rhs.make_rhs(mix, sys_.shape, args.seed, index, device=device))
        sync()
        return b

    def solve(b):
        """One solve, timed from the call to the synchronised return."""
        t0 = time.perf_counter()
        r = sys_.ksp.solve(b)
        sync()
        return r, time.perf_counter() - t0

    for w in range(int(mix["warmup_steps"])):
        r, seconds = solve(make(rhs.WARMUP - w))
        log(f"warm-up step {w}: {r.iters} inner in {r.outer_iters} sweeps, reason {r.reason}, {seconds:.4f} s")
    # the check's sample is copied out of the program's solutions between
    # steps, into buffers of set-up, so that keeping it holds none of the
    # program's memory and the window allocates nothing for it
    sample = int(mix["sample"])
    buffers = [torch.empty_like(r.x) for _ in range(sample)]
    del r
    if tracing:
        with trace.capture(device):  # the profiler's own first start
            torch.zeros(1, device=device).add_(1)
    sync()
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.4f} s")

    # -- the window -------------------------------------------------------
    kept = {}  # the reservoir: buffer slot -> step
    draw = random.Random(rhs.stream_seed(args.seed, "sample"))
    solves = []
    launches, traced = None, []
    stack = contextlib.ExitStack()
    if tracing:
        traced = stack.enter_context(trace.capture(device))
        launches = stack.enter_context(roofline.LaunchRecorder()).launches
    t_window = time.perf_counter()
    index = 0
    with stack:
        while True:
            t_make = time.perf_counter()
            b = make(index)
            make_s = time.perf_counter() - t_make
            in_trace = tracing and time.perf_counter() - t_window < float(mix["trace_seconds"])
            if tracing and not in_trace:
                stack.close()  # the profiler and the recorder stop after the traced solves
            with trace.step_span() if in_trace else contextlib.nullcontext():
                r, seconds = solve(b)
            del b
            solves.append(dict(step=index, iters=int(r.iters), outer_iters=int(r.outer_iters), reason=int(r.reason),
                               seconds=seconds, make_seconds=make_s, traced=in_trace))
            slot = index if index < sample else draw.randrange(index + 1)
            if slot < sample:
                buffers[slot].copy_(r.x)
                kept[slot] = index
            print(f"solve {index}: {r.iters} inner in {r.outer_iters} sweeps, reason {r.reason}, {seconds:.4f} s"
                  f" (right-hand side {make_s:.4f} s){' (traced)' if in_trace else ''}", flush=True)
            del r  # the program's solution goes back to its allocator before the next step
            index += 1
            if time.perf_counter() - t_window >= args.seconds:
                break
    window_s = time.perf_counter() - t_window
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        print(smi_line(), flush=True)
    made = sum(s["make_seconds"] for s in solves)
    print(f"window {window_s:.4f} s: {len(solves)} solves, {sum(s['seconds'] for s in solves):.4f} s of them"
          f" in solve calls, {made:.4f} s making right-hand sides; peak device memory {memory_peak} B", flush=True)
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3

    # -- the check --------------------------------------------------------
    del sys_
    if cuda:
        torch.cuda.empty_cache()
    ref = problem.reference(config)
    rtol, atol = config["ksp"]["rtol"], config["ksp"]["atol"]
    worst, limit, wrong = 0.0, math.inf, 0
    for slot, step in sorted(kept.items(), key=lambda kv: kv[1]):
        x = buffers[slot]
        b = rhs.make_rhs(mix, ref.shape, args.seed, step, device=device)
        rnorm, bnorm = ref.residual(x, b)
        rel = rnorm / bnorm if math.isfinite(rnorm) and bnorm > 0 else math.inf
        worst, limit = max(worst, rel), min(limit, max(rtol, atol / bnorm))
        wrong += not rnorm <= max(rtol * bnorm, atol)
        print(f"check {step}: ||b - A x|| / ||b|| = {rel!r}", flush=True)
    unconverged = sum(s["reason"] <= 0 for s in solves)
    failed = unconverged + wrong
    checks = {
        "rel_residual_max": {"value": worst, "limit": limit, "solves": len(kept)},
        "unconverged": {"value": unconverged, "limit": 0},
    }

    # -- metrics ----------------------------------------------------------
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    run = Run(setup_s=setup_s, solves=solves, window_s=window_s,
              trace=traced[0] if traced else None, launches=launches,
              models=spec.load_kernel_models(cell.root), peak=spec.load_peaks(cell.root).get(kind))
    metrics = {}
    for entry in (cell.per_layer if tracing else cell.end_to_end):
        value = spec.load_reader(entry["name"], cell.root)(run)
        if value is None:
            print(f"metric {entry['name']}: nothing to read in this run", flush=True)
            continue
        metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": failed == 0, "attempted": len(solves), "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s(), run.trace.window_s
        ops = sorted(run.trace.by_name().items(), key=lambda kv: -kv[1][0])
        result["breakdown"] = {
            "device_ops": [[name[:160], sec] for name, (sec, _) in ops[:10]],
            "idle_gaps": [[name[:160], sec] for name, sec in run.trace.idle_gaps(10)],
        }
        for name, (sec, count) in ops[:25]:
            print(f"traced device op: {sec:.6f} s in {count} events: {name[:160]}")
        if run.peak is not None:
            for kernel, (least, sec) in roofline.kernel_shares(run.models, launches, run.trace, run.peak).items():
                print(f"roofline {kernel}: {100 * least / sec:.2f}% ({least:.6f} s least of {sec:.6f} s traced)")
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the time of a solve goes, on one GPU.

    python3 -m tpusparse_torch.bench.breakdown [--n 300] [--cycles 10] [--mat-type stencil|aij]
        [--config configs/SolverOptions_GAMG.info] [--cg-fusion]

Prints, after the card's name and power limit:

- ``solve_poisson(n, rtol=1e-8, atol=1e-12, pc="gamg")`` twice (its JSON
  sidecar), then the peak device memory of the second call; with
  ``--mat-type aij`` the structure-blind general-matrix route
  (``structure_detect=False``); with
  ``--config`` the KSP method, tolerances and GAMG parameters of that
  options file, read as the CLI's ``-config`` reads it (the reference
  config: CG, rtol 1e-14, Richardson(1), so the cycle below runs K6/K7);
  with ``--cg-fusion`` the full-fusion CG body (``cg_fusion=True``), whose
  cycle below is ``vcycle_fused_rupdate`` (K9, the coarse cycle, K4);
- the setup split: the rho power iterations and the Galerkin probing of
  every level, each timed alone on the built hierarchy;
- one V-cycle (``vcycle_fused_dots`` on the stencil route,
  ``vcycle_fused_rupdate`` with ap = rhs / 2 and alpha = 0.37 on the
  full-fusion body's, ``vcycle`` over the DIA levels on the aij route) on
  the normalized fine right-hand side:
  ms per cycle by CUDA events and by the host clock, the hand-written
  kernel launches per cycle (``kernels.LAUNCHES``), then, under
  ``torch.profiler``, device-busy ms and device kernels per cycle and the
  kernels that take the most device time, each with its share of the
  device-busy time;
- one solve under ``torch.profiler``: device-busy ms, its share of the
  unprofiled solve time, launches, and the top kernels.

Device-busy time is the sum of the profiler's kernel and copy durations on
the card (one stream, so they do not overlap).
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time

import torch

from tpusparse_torch import kernels
from tpusparse_torch.amg.fused_cycle import vcycle_fused_dots, vcycle_fused_rupdate
from tpusparse_torch.amg.galerkin import galerkin_coarse
from tpusparse_torch.amg.geo import galerkin_probe_geo
from tpusparse_torch.amg.hierarchy import (
    AMGParams,
    cast_coarse_coefs,
    estimate_rho_dinv_a,
    gamg_setup,
    vcycle,
)
from tpusparse_torch.amg.unstructured import gamg_setup_unstructured
from tpusparse_torch.bench.driver import (
    _pick_ksp,
    build_system,
    build_system_aij,
    refined_solve,
    refined_solve_plain,
    solve_poisson,
)
from tpusparse_torch.config.options import load_options
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.sparse.padded import pad_field

KW = dict(rtol=1e-8, atol=1e-12)


def _timed(fn) -> float:
    """Host seconds of ``fn()``, synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _profile(fn, top: int, cpu: bool = True) -> tuple[float, int, list]:
    """(device-busy ms, device events, the ``top`` kernels by device ms) of
    ``fn()``; with ``cpu`` False the profiler records the device alone (a
    reference-config solve launches ~1M kernels and ~5M host operators)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in evs:
        by_name[e.name][0] += e.device_time_total / 1e3
        by_name[e.name][1] += 1
    busy = sum(ms for ms, _ in by_name.values())
    return busy, len(evs), sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]


def _print_top(rows, busy: float, per: int = 1) -> None:
    """The top kernels: device ms and count per ``per``, share of ``busy``."""
    for name, (ms, count) in rows:
        print(f"  {ms / per:9.4f} ms  x {count / per:7.1f}  {100 * ms / busy:5.1f}%  {name[:96]}")


def _stencil_route(n, device, params, kw):
    """The pieces of the stencil route the breakdown times: the setup, the
    Galerkin step, the preconditioner's final form, its cycle (and its
    name), the cycle's right-hand side and the solve (with the solve
    keywords ``kw``; ``cg_fusion`` among them takes the full-fusion body
    and its cycle)."""
    op, b, _, op_lo = build_system(Grid3D(n, n, n), device)
    rhs = pad_field((b / torch.linalg.vector_norm(b)).to(torch.float32))
    cycle, name = vcycle_fused_dots, "vcycle_fused_dots"
    if kw.get("cg_fusion"):
        ap, alpha = 0.5 * rhs, torch.tensor(0.37, device=device)
        cycle, name = (lambda pc_state, r: vcycle_fused_rupdate(pc_state, r, ap, alpha)), "vcycle_fused_rupdate"
    return dict(
        setup=lambda: gamg_setup(op_lo, params),
        galerkin=galerkin_coarse,
        pc=cast_coarse_coefs,
        cycle=cycle,
        name=name,
        rhs=rhs,
        solve=lambda pc_state: refined_solve(op, op_lo, pc_state, b, **kw),
    )


def _aij_route(n, device, params, kw):
    """The same pieces for the structure-blind general-matrix route."""
    op, op_lo, b, _ = build_system_aij(Grid3D(n, n, n), device)
    return dict(
        setup=lambda: gamg_setup_unstructured(None, params, fine_op=op_lo),
        galerkin=galerkin_probe_geo,
        pc=lambda hier: hier,
        cycle=vcycle,
        name="vcycle",
        rhs=(b / torch.linalg.vector_norm(b)).to(torch.float32),
        solve=lambda pc_state: refined_solve_plain(op, pc_state, b, **kw),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--cycles", type=int, default=10)
    ap.add_argument("--mat-type", choices=("stencil", "aij"), default="stencil")
    ap.add_argument("--config", help="a PETSc options file, read as the CLI's -config")
    ap.add_argument("--cg-fusion", action="store_true", help="the full-fusion CG body (stencil route)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("breakdown: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    aij = args.mat_type == "aij"
    params, ksp, kw = AMGParams(), "cg", dict(KW)
    if args.config:
        opts = load_options(["-config", args.config])
        params, ksp, kw = opts.amg_params(), opts.ksp_type, dict(rtol=opts.ksp_rtol, atol=opts.ksp_atol)
        print(f"--config {args.config}: ksp {ksp}, {kw}, {params}")

    def solve_once():
        rep = solve_poisson(args.n, pc="gamg", device=device, mat_type=args.mat_type, amg_params=params,
                            ksp=ksp, cg_fusion=args.cg_fusion, structure_detect=not aij, **kw)
        print(rep.json_sidecar())

    solve_once()
    torch.cuda.reset_peak_memory_stats()
    solve_once()
    print(f"peak device memory of solve_poisson: {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

    kw["ksp_solve"] = _pick_ksp(ksp)
    if args.cg_fusion:
        kw["cg_fusion"] = True
    route = (_aij_route if aij else _stencil_route)(args.n, device, params, kw)
    hier = route["setup"]()
    t_setup = _timed(route["setup"])
    t_rho = t_gal = 0.0
    for lev in hier.levels:
        t_rho += _timed(lambda: estimate_rho_dinv_a(
            lev.op, lev.dinv, params.rho_iters, true_shape=getattr(lev.op, "true_shape", None)))
        if lev.transfer is not None:
            t_gal += _timed(lambda: route["galerkin"](lev.op, lev.dinv, lev.transfer))
        print(f"  level shape {tuple(lev.dinv.shape)} rho {lev.rho:.6f} {type(lev.op).__name__}"
              f" offsets {len(getattr(lev.op, 'offsets', ()))}")
    print(f"setup {t_setup:.4f} s: rho {t_rho:.4f} s, galerkin {t_gal:.4f} s")

    pc_state = route["pc"](hier)
    r = route["rhs"]

    def cycles():
        for _ in range(args.cycles):
            route["cycle"](pc_state, r)

    cycles()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    cycles()
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / args.cycles
    per_cycle = {k: v / args.cycles for k, v in kernels.LAUNCHES.items() if v}
    print(f"{route['name']}: events {start.elapsed_time(end) / args.cycles:.3f} ms,"
          f" host {host_ms:.3f} ms per cycle; hand-written kernel launches per cycle {per_cycle}")
    busy, n_ev, top = _profile(cycles, top=12)
    print(f"per V-cycle: device busy {busy / args.cycles:.3f} ms"
          f" ({100 * busy / args.cycles / host_ms:.1f}% of the host clock's ms),"
          f" {n_ev / args.cycles:.1f} device events")
    _print_top(top, busy, per=args.cycles)

    def solve():
        return route["solve"](pc_state)

    solve()  # warm-up
    t_solve = _timed(solve)
    busy, n_ev, top = _profile(solve, top=12, cpu=not args.config)
    print(f"solve: unprofiled {t_solve:.4f} s; device busy {busy:.1f} ms"
          f" ({100 * busy / 1e3 / t_solve:.1f}% of the unprofiled time), {n_ev} device events")
    _print_top(top, busy)


if __name__ == "__main__":
    main()

"""Per-component ledger of one inner CG + GAMG iteration on one GPU — port
of ``tpusparse/bench/itprof.py``.

    python3 -m tpusparse_torch.bench.itprof [N] [reps]

Times each piece of the stencil route's inner solve (the padded fine level,
Chebyshev(2) smoother, bf16 coarse coefficients: ``solve_poisson``'s
default configuration) at N^3 (default 300) with CUDA events over ``reps``
(default 20) back-to-back calls, after the card's name and power limit:

- the fine-level kernels: mv (K1), mvdot (K2), descent (K3'), ascent (K4');
- the two transfer einsums (restrict + prolong), the coarse cycle (levels
  1+), the whole ``vcycle_fused``;
- the production inner iteration: ``solve/cg.py::cg``'s own loop with
  ``a_mv_dot`` (K2) and ``m_mv_dots`` (K3/K4), its host read of ||r||
  included;
- the full-fusion kernels cgmv (K8), descentu (K9), ascent_rz (K4), and the
  full-fusion iteration (the same ``cg`` with ``ab_fused``/``m_fused``: K8
  + K9 + the coarse cycle + K4), its host read included.

An iteration is timed as the difference of two ``cg`` solves that stop
after 2 and after ``reps`` + 2 iterations (rtol 0), over ``reps``: the work
before the loop cancels, and the loop is the one the solve runs.

Beside each kernel it prints the field passes the port's kernels really
make (a pass is one read or write of a padded f32 field; a kernel that
chains launches through device memory makes more than its bound) and the
GB/s they come to.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from tpusparse_torch.amg.fused_cycle import (
    _fine_scalars,
    vcycle_fused,
    vcycle_fused_dots,
    vcycle_fused_rupdate,
)
from tpusparse_torch.amg.hierarchy import AMGParams, cast_coarse_coefs, gamg_setup, vcycle
from tpusparse_torch.bench.driver import build_system
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.kernels.fused7 import (
    fused7_ascent,
    fused7_ascent_rz,
    fused7_descent,
    fused7_descentu,
)
from tpusparse_torch.solve.cg import cg
from tpusparse_torch.sparse.padded import pad_field

# field passes of each kernel as the port launches it (csrc/fused7.cu's
# header): each is one launch at its bound's count (K3', K4 and K4', K9
# march through shared memory)
PASSES = {"mv": 3, "mvdot": 3, "descent": 4, "ascent": 5, "cgmv": 7, "descentu": 6, "ascent_rz": 5}


def time_ms(fn, reps: int) -> float:
    """Mean ms of ``reps`` back-to-back calls of ``fn`` by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def iteration_ms(op, b, reps: int, **body) -> float:
    """ms of one iteration of ``cg``'s loop with the callables ``body``:
    the difference of solves of 2 and ``reps`` + 2 iterations."""

    def run(k):
        def solve():
            res = cg(op.mv, b, rtol=0.0, maxiter=k, **body)
            if res.iters != k:
                raise RuntimeError(f"cg stopped after {res.iters} of {k} iterations ({res.reason})")
        return time_ms(solve, 3)

    return (run(reps + 2) - run(2)) / reps


def report(name: str, ms: float, field_bytes: int, passes: int | None = None) -> None:
    if passes is None:
        print(f"{name:40s} {ms:8.3f} ms")
        return
    nbytes = passes * field_bytes
    print(f"{name:40s} {ms:8.3f} ms  {passes:3d} passes {nbytes / 1e6:9.1f} MB"
          f" {nbytes / (ms * 1e-3) / 1e9:8.1f} GB/s")


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 300
    reps = int(argv[1]) if len(argv) > 1 else 20
    if not torch.cuda.is_available():
        sys.exit("itprof: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False

    _, b, _, op = build_system(Grid3D(n, n, n), device)
    hier = cast_coarse_coefs(gamg_setup(op, AMGParams()))
    b_p = pad_field((b / torch.linalg.vector_norm(b)).to(torch.float32))
    # distinct operands for the kernels that read several fields: aliased
    # ones would be read from HBM once
    f2, f3 = 0.5 * b_p, 0.25 * b_p
    field = b_p.numel() * b_p.element_size()
    print(f"# {n}^3, one padded f32 field = {field / 1e6:.2f} MB, reps={reps}")

    lev = hier.levels[0]
    tr = lev.transfer
    s0, ad, g = _fine_scalars(hier, lev)
    legs = (op.diag, op.cx, op.cy, op.cz)
    pin = (op.true_shape, op.pinned)

    def piece(name, key, fn):
        report(name, time_ms(fn, reps), field, PASSES.get(key))

    # --- fine-level kernels ----------------------------------------------------
    piece("mv (K1)", "mv", lambda: op.mv(b_p))
    piece("mvdot (K2)", "mvdot", lambda: op.mv_dot(b_p))
    piece("descent (K3')", "descent", lambda: fused7_descent(*legs, b_p, s0, ad, g, tr.omega, *pin))
    piece("ascent (K4')", "ascent",
          lambda: fused7_ascent(*legs, f2, b_p, f3, s0, ad, g, tr.omega, *pin))

    # --- transfers, coarse hierarchy, whole preconditioner ----------------------
    e_c = tr.tT_apply_padded(b_p)  # a coarse right-hand side as the cycle makes one
    report("tT + t einsums (2 fine passes)",
           time_ms(lambda: tr.t_apply_padded(tr.tT_apply_padded(b_p)), reps), field, 2)
    piece("coarse vcycle (levels 1+)", None, lambda: vcycle(hier, e_c, level=1))
    piece("vcycle_fused (full M^-1 r)", None, lambda: vcycle_fused(hier, b_p))

    # --- one inner CG iteration, the production body (solve/cg.py) ---------------
    report("FULL CG+AMG iteration", iteration_ms(
        op, b_p, reps, a_mv_dot=op.mv_dot, m_mv_dots=lambda r: vcycle_fused_dots(hier, r),
    ), field)

    # --- the full-fusion kernels and iteration -----------------------------------
    al = torch.tensor(0.37, dtype=torch.float32, device=device)
    be = torch.tensor(0.61, dtype=torch.float32, device=device)
    piece("cgmv (K8)", "cgmv", lambda: op.cgmv(b_p, f2, f3, al, be))
    piece("descentu (K9)", "descentu",
          lambda: fused7_descentu(*legs, b_p, f2, s0, ad, g, tr.omega, al, *pin))
    piece("ascent_rz (K4)", "ascent_rz",
          lambda: fused7_ascent_rz(*legs, f2, b_p, f3, s0, ad, g, tr.omega, *pin))
    report("FULL fused-CG iteration", iteration_ms(
        op, b_p, reps, ab_fused=op.cgmv,
        m_fused=lambda r, ap, alpha: vcycle_fused_rupdate(hier, r, ap, alpha),
    ), field)


if __name__ == "__main__":
    main()

"""The headline bench entries of the port: the 300^3 Poisson CG + GAMG solve
to rtol 1e-8 on one GPU — port of ``bench.py`` and, with ``--aij``, of
``bench_aij.py``.

    python -m tpusparse_torch.bench.headline [N] [--device cpu]
    python -m tpusparse_torch.bench.headline --aij [--nodetect] [N] [--device cpu]

Prints exactly one JSON line on stdout, ``bench.py``'s (``metric``,
``value`` = ``t_solve`` in seconds, ``unit``, ``vs_baseline`` = 30 s /
``t_solve``); the reference block and the JSON sidecar go to stderr.  The
baseline is the reference's best single node (16 Opteron cores + K20x)
at ~25-35 s of KSPSolve time (``BASELINE.md``), taken as 30 s.

``--aij`` solves the same system assembled as a general matrix
(``mat_type="aij"``, DMSetMatType(MATAIJ) parity), metric
``poisson{N}_aij_cg_gamg_solve_s``: by default with structure detection,
which proves the matrix a star and lifts it onto the stencil route;
``--nodetect`` (``poisson{N}_aij_nodetect_cg_gamg_solve_s``) keeps the
structure-blind banded route (kernel K5).  Each needs a CUDA device unless
given ``--device cpu`` and raises without one; ``run`` takes any device
(the tests run it on the CPU at small N).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from tpusparse_torch.bench.driver import SolveReport, solve_poisson

BASELINE_SOLVE_S = 30.0  # the reference's best-node KSPSolve (BASELINE.md)
N = 300
RTOL = 1e-8  # BASELINE.json's gate


def run(n: int = N, *, device="cuda", mat_type: str = "stencil", structure_detect: bool = True,
        **kw) -> tuple[SolveReport, dict]:
    """The headline solve at ``n``^3 on ``device`` (``mat_type`` "stencil"
    or "aij"; ``kw`` to ``solve_poisson``): (its report, the JSON line's
    object)."""
    rep = solve_poisson(n, rtol=RTOL, atol=1e-12, pc="gamg", device=device, mat_type=mat_type,
                        structure_detect=structure_detect, **kw)
    tag = "" if mat_type == "stencil" else "_aij" if structure_detect else "_aij_nodetect"
    line = {
        "metric": f"poisson{n}{tag}_cg_gamg_solve_s",
        "value": rep.t_solve,
        "unit": "s",
        "vs_baseline": BASELINE_SOLVE_S / rep.t_solve,
    }
    return rep, line


def main(argv: list[str] | None = None, *, device="cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n", nargs="?", type=int, default=N)
    ap.add_argument("--aij", action="store_true", help="bench_aij.py's solve (mat_type aij)")
    ap.add_argument("--nodetect", action="store_true", help="with --aij: no structure detection")
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    if args.nodetect and not args.aij:
        ap.error("--nodetect needs --aij")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the headline bench needs a CUDA device")
    rep, line = run(args.n, device=args.device, mat_type="aij" if args.aij else "stencil",
                    structure_detect=not args.nodetect)
    print(rep.reference_block(), file=sys.stderr)
    print(rep.json_sidecar(), file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

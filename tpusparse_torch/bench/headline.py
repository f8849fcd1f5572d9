"""The headline bench entry of the port: the 300^3 Poisson CG + GAMG solve to
rtol 1e-8 on one GPU — port of ``bench.py``.

    python -m tpusparse_torch.bench.headline [N]

Prints exactly one JSON line on stdout, ``bench.py``'s (``metric``,
``value`` = ``t_solve`` in seconds, ``unit``, ``vs_baseline`` = 30 s /
``t_solve``); the reference block and the JSON sidecar go to stderr.  The
baseline is the reference's best single node (16 Opteron cores + K20x)
at ~25-35 s of KSPSolve time (``BASELINE.md``), taken as 30 s.  It needs
a CUDA device and raises without one; ``run`` takes any device (the tests
run it on the CPU at small N).
"""

from __future__ import annotations

import json
import sys

import torch

from tpusparse_torch.bench.driver import SolveReport, solve_poisson

BASELINE_SOLVE_S = 30.0  # the reference's best-node KSPSolve (BASELINE.md)
N = 300
RTOL = 1e-8  # BASELINE.json's gate


def run(n: int = N, *, device="cuda") -> tuple[SolveReport, dict]:
    """The headline solve at ``n``^3 on ``device``: (its report, the JSON
    line's object)."""
    rep = solve_poisson(n, rtol=RTOL, atol=1e-12, pc="gamg", device=device)
    line = {
        "metric": f"poisson{n}_cg_gamg_solve_s",
        "value": rep.t_solve,
        "unit": "s",
        "vs_baseline": BASELINE_SOLVE_S / rep.t_solve,
    }
    return rep, line


def main(argv: list[str] | None = None, *, device="cuda") -> int:
    args = sys.argv[1:] if argv is None else argv
    n = int(args[0]) if args else N
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the headline bench needs a CUDA device")
    rep, line = run(n, device=device)
    print(rep.reference_block(), file=sys.stderr)
    print(rep.json_sidecar(), file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

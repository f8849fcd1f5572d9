"""The work of the program's hand-written kernel launches, against the time
the trace gives them.

Every hand-written launch of ``tpusparse_torch`` goes through one
function, ``tpusparse_torch.kernels._build.launch(entry, argtypes, device,
*args)``.  ``LaunchRecorder`` wraps it for the traced steps and keeps each
launch's entry point and integer arguments: the shapes the launch was
given.  A kernel model (``kernel_models/<kernel>.json``) names an entry
point, the device kernel it runs (a substring of the name the profiler
shows), which arguments are which shape (``args``: name -> position), a
``check`` on them, and the unique ``bytes`` and the ``flops`` one launch
needs as expressions of those names.  The least time of a launch is the
larger of bytes over the card's published bandwidth and flops over its
float32 peak (``peaks.json``).
"""

from __future__ import annotations

import ast
import operator

from benchmark.trace import Trace

_BINARY = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul, ast.Mod: operator.mod}
_COMPARE = {ast.Lt: operator.lt, ast.LtE: operator.le, ast.Gt: operator.gt, ast.GtE: operator.ge,
            ast.Eq: operator.eq, ast.NotEq: operator.ne}


def evaluate(expr: str, names: dict[str, int]):
    """Integer arithmetic, comparisons and ``and`` over ``names``; nothing
    else is allowed in a model file."""

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return node.value
        if isinstance(node, ast.Name):
            return names[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in _BINARY:
            return _BINARY[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.And):
            return all(ev(v) for v in node.values)
        if isinstance(node, ast.Compare) and len(node.ops) == 1 and type(node.ops[0]) in _COMPARE:
            return _COMPARE[type(node.ops[0])](ev(node.left), ev(node.comparators[0]))
        raise ValueError(f"not allowed in a kernel model: {ast.dump(node)}")

    return ev(ast.parse(expr, mode="eval"))


class LaunchRecorder:
    """Within ``with``: every hand-written launch's (entry point, integer
    arguments), in order."""

    def __init__(self):
        self.launches: list[tuple[str, tuple]] = []

    def __enter__(self):
        from tpusparse_torch.kernels import _build

        self._build, self._launch = _build, _build.launch
        launches, launch = self.launches, self._launch

        def recording(name, argtypes, device, *args):
            launches.append((name, tuple(a if isinstance(a, int) else None for a in args)))
            return launch(name, argtypes, device, *args)

        _build.launch = recording
        return self

    def __exit__(self, *exc):
        self._build.launch = self._launch
        return False


def least_seconds(model: dict, args: tuple, peak: dict) -> float:
    """The least time of one launch of ``model`` with ``args``; raise
    ``ValueError`` when the arguments fail the model's check."""
    names = {k: args[i] for k, i in model["args"].items()}
    if not evaluate(model["check"], names):
        raise ValueError(f"{model['name']}: arguments {names} fail the check {model['check']!r}")
    return max(evaluate(model["bytes"], names) / peak["hbm_bytes_per_s"],
               evaluate(model["flops"], names) / peak["f32_flops_per_s"])


def kernel_shares(models: list[dict], launches: list, trace: Trace, peak: dict) -> dict[str, tuple[float, float]]:
    """For each device kernel that a model covers and that ran: (least
    seconds, traced seconds) summed over its launches.  A kernel whose
    recorded launches do not match the trace's count one for one is left
    out, with a line saying so on the log.

    The recorder and the profiler cover the same stretch of the run, so the
    launches are matched to every event of the capture, not only to those
    inside the steps: the profiler puts device events on the host's clock
    only to within about half a millisecond, and a kernel at a step's edge
    can fall outside its span."""
    by_entry = {m["entry"]: m for m in models}
    mask = trace.kernel_mask(whole=True)
    names = [trace.gpu_name[i] for i in range(len(trace.gpu_name)) if mask[i]]
    seconds = (trace.gpu_end - trace.gpu_start)[mask] / 1e9
    out = {}
    for kernel in sorted({m["kernel"] for m in models}):
        entries = {m["entry"] for m in models if m["kernel"] == kernel}
        recorded = [(e, a) for e, a in launches if e in entries]
        hits = [i for i, n in enumerate(names) if kernel in n]
        if not recorded and not hits:
            continue
        if len(recorded) != len(hits):
            print(f"roofline: {kernel}: {len(recorded)} launches recorded, {len(hits)} in the trace: left out")
            continue
        try:
            least = sum(least_seconds(by_entry[e], a, peak) for e, a in recorded)
        except ValueError as err:
            print(f"roofline: {err}: left out")
            continue
        out[kernel] = (least, float(sum(seconds[i] for i in hits)))
    return out

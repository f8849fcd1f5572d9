"""The fine level's ``varstencil27_mv`` launches in a traced run: those on
the largest grid the run recorded, where a 27-point fine level
(``VarStencil27``) is that grid.

The launches the ``roofline.LaunchRecorder`` kept for the entry point of
the kernel model ``V27`` (``kernel_models/V27.json``) are matched one for
one, in order, to the capture's device events of its kernel, taken in the
order they started (the port issues them on one stream), as
``roofline.kernel_shares`` matches counts over the whole capture; where
the counts differ nothing is read.  Then each of the matched launches
whose grid (nz, ny, nx) is the largest recorded is a fine launch, of
either dtype pair: the float32 inner applies and the float64 residuals.
"""

from __future__ import annotations

import numpy as np

V27 = "V27"  # the kernel model of varstencil27_mv


def fine_launches(run):
    """(model, [(launch arguments, device event index)]) of the fine
    ``varstencil27_mv`` launches, or None where the run has no trace, no
    recorded launch of the kernel, or counts that do not match."""
    if run.trace is None or not run.launches or not run.models:
        return None
    model = next((m for m in run.models if m["name"] == V27), None)
    if model is None:
        return None
    recorded = [args for entry, args in run.launches if entry == model["entry"]]
    if not recorded:
        return None
    trace = run.trace
    hits = np.array([i for i, name in enumerate(trace.gpu_name) if model["kernel"] in name], dtype=np.int64)
    if len(recorded) != hits.size:
        print(f"fine level: {model['kernel']}: {len(recorded)} launches recorded, {hits.size} in the trace:"
              " nothing read", flush=True)
        return None
    hits = hits[np.argsort(trace.gpu_start[hits], kind="stable")]
    pos = model["args"]

    def grid(args):
        return tuple(args[pos[name]] for name in ("nz", "ny", "nx"))

    largest = max((grid(a) for a in recorded), key=lambda g: g[0] * g[1] * g[2])
    return model, [(a, int(i)) for a, i in zip(recorded, hits) if grid(a) == largest]

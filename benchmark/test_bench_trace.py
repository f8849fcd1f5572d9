"""The trace reductions and the kernel models on synthetic events, and the
models' argument positions against the port's launch calls on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.roofline import LaunchRecorder, evaluate, kernel_shares, least_seconds
from benchmark.trace import Trace

PEAK = {"hbm_bytes_per_s": 1e9, "f32_flops_per_s": 1e12}


def _trace(gpu, spans, cpu=()):
    a = np.array
    return Trace([g[0] for g in gpu], a([g[1] for g in gpu], dtype=np.int64), a([g[2] for g in gpu], dtype=np.int64),
                 [c[0] for c in cpu], a([c[1] for c in cpu], dtype=np.int64), a([c[2] for c in cpu], dtype=np.int64),
                 spans=a(spans, dtype=np.int64))


def test_busy_is_the_union_inside_the_steps():
    t = _trace([("k1", 0, 10), ("k2", 5, 20), ("Memcpy DtoH", 30, 40), ("k3", 60, 70), ("k4", 200, 210)],
               spans=[(0, 50), (60, 100)],
               cpu=[("benchmark:step", 0, 50), ("aten::item", 18, 32), ("cudaStreamSynchronize", 20, 30),
                    ("aten::add", 70, 100)])
    assert t.window_s == pytest.approx(90e-9)
    assert t.busy_s() == pytest.approx(40e-9)          # [0, 20) + [30, 40) + [60, 70); k4 lies outside
    assert int(t.kernel_mask().sum()) == 3              # the copy is no kernel
    gaps = t.idle_gaps(3)
    assert gaps[0] == ("aten::add", pytest.approx(30e-9))
    assert gaps[1] == ("cudaStreamSynchronize", pytest.approx(10e-9))
    assert t.by_name()["k2"] == (pytest.approx(15e-9), 1)


def test_evaluate_takes_arithmetic_only():
    assert evaluate("(k + 2) * n * 4", {"k": 7, "n": 10}) == 360
    assert evaluate("n > 0 and k <= 192", {"k": 7, "n": 10})
    for bad in ("__import__('os')", "n.real", "[n]"):
        with pytest.raises(ValueError):
            evaluate(bad, {"n": 1})


def test_kernel_shares_match_launches_to_the_trace():
    models = [{"name": "K5", "entry": "tps_dia_mv", "kernel": "dia_mv_window_kernel", "args": {"n": 3, "k": 4},
               "check": "n > 0", "bytes": "(k + 2) * n * 4", "flops": "2 * k * n"}]
    launches = [("tps_dia_mv", (1, 2, 3, 100, 7, None)), ("tps_other", (0,))]
    t = _trace([("(anonymous namespace)::dia_mv_window_kernel(float const*)", 0, 7200), ("other", 7200, 9000)],
               spans=[(0, 10000)])
    least, sec = kernel_shares(models, launches, t, PEAK)["dia_mv_window_kernel"]
    assert least == pytest.approx(3600 / 1e9) and sec == pytest.approx(7.2e-6)
    # a count that does not match leaves the kernel out
    assert kernel_shares(models, launches * 2, t, PEAK) == {}


def test_kernel_shares_keep_a_kernel_at_a_steps_edge():
    # the profiler puts device events on the host's clock only to within
    # about half a millisecond: the first launch of the second step reads
    # as starting before its span, the last as ending after it
    models = [{"name": "K5", "entry": "tps_dia_mv", "kernel": "dia_mv_window_kernel", "args": {"n": 3, "k": 4},
               "check": "n > 0", "bytes": "(k + 2) * n * 4", "flops": "2 * k * n"}]
    launches = [("tps_dia_mv", (1, 2, 3, 100, 7, None))] * 3
    t = _trace([("dia_mv_window_kernel", 100, 7300), ("dia_mv_window_kernel", 19_950, 27_150),
                ("dia_mv_window_kernel", 32_850, 40_050)], spans=[(0, 10_000), (20_000, 40_000)])
    assert int(t.kernel_mask().sum()) == 1 and int(t.kernel_mask(whole=True).sum()) == 3
    least, sec = kernel_shares(models, launches, t, PEAK)["dia_mv_window_kernel"]
    assert least == pytest.approx(3 * 3600 / 1e9) and sec == pytest.approx(3 * 7.2e-6)


def test_every_model_file_is_well_formed():
    for m in spec.load_kernel_models():
        assert {"entry", "kernel", "args", "check", "bytes", "flops", "source"} <= set(m)
        names = {k: 1000 for k in m["args"]}
        for expr in (m["bytes"], m["flops"]):
            assert evaluate(expr, names) > 0


def _record(monkeypatch, call):
    """The launches ``call`` makes, with the launch itself replaced."""
    from tpusparse_torch.kernels import _build

    monkeypatch.setattr(_build, "launch", lambda name, argtypes, device, *args: None)
    with LaunchRecorder() as rec:
        call()
    return rec.launches


def test_model_positions_match_the_ports_launches(monkeypatch):
    """K3 and K4, whose launch helpers take CPU tensors; the wrappers of the
    others dispatch a CPU tensor to its twin, and the models' checks hold
    their positions on the card."""
    from tpusparse_torch.kernels import fused7
    from tpusparse_torch.kernels.stencil7 import padded_shape

    models = {m["entry"]: m for m in spec.load_kernel_models()}
    shape = (6, 5, 7)
    f = torch.zeros(padded_shape(shape), dtype=torch.float32)
    calls = {
        "tps_descent": lambda: fused7._launch_descent("fused7_descent_rr", True, f, 1.0, 1.0, 1.0, f, 0.1, 0.2,
                                                      0.3, 0.4, shape, True, None),
        "tps_ascent": lambda: fused7._launch_ascent("fused7_ascent_rz", True, f, 1.0, 1.0, 1.0, f, f, f, 0.1, 0.2,
                                                    0.3, 0.4, shape, True, None),
    }
    for entry, call in calls.items():
        (name, args), = _record(monkeypatch, call)
        assert name == entry
        m = models[entry]
        names = {k: args[i] for k, i in m["args"].items()}
        assert evaluate(m["check"], names), names
        if "nz" in names:
            assert (names["nz"], names["ny"], names["nx"]) == shape and names.get("q", 1) == 1
        least_seconds(m, args, PEAK)


"""The span readers (``benchmark/spans.py``, ``metrics/host_wait_pct.solve``,
``idle_in_pc_pct.solve``, ``idle_in_krylov_pct.solve``,
``coarse_launches_per_iter.solve``) on hand-built traces: the interval
arithmetic against a nanosecond-by-nanosecond count, nested and repeated
spans, idle time split at span edges, and no reading where the spans are
missing (a program that opens none, or a run on the CPU); and, on the card,
the four metrics read from a traced run with the spans on the device
events' clock."""

from __future__ import annotations

import contextlib
import json

import numpy as np
import pytest

from benchmark import run as bench_run
from benchmark import spans, spec, trace
from benchmark.run import Run
from benchmark.test_bench_harness import CELLS, _copy, card  # noqa: F401  (card: a fixture)
from benchmark.trace import Trace

# the profiler places device events on the host's clock to within some
# hundreds of microseconds: on the H100, kernels read as starting up to
# 0.38 ms before their launch call, and ending up to 0.55 ms after the
# synchronised close of their step
CLOCK_NS = 2_000_000
NAMES = ("host_wait_pct.solve", "idle_in_pc_pct.solve", "idle_in_krylov_pct.solve", "coarse_launches_per_iter.solve")
L0, L1 = spans.level(0), spans.level(1)


def _trace(gpu, steps, cpu):
    a = np.array
    cpu = [("benchmark:step", s, e) for s, e in steps] + list(cpu)
    return Trace([g[0] for g in gpu], a([g[1] for g in gpu], dtype=np.int64).reshape(-1),
                 a([g[2] for g in gpu], dtype=np.int64).reshape(-1),
                 [c[0] for c in cpu], a([c[1] for c in cpu], dtype=np.int64), a([c[2] for c in cpu], dtype=np.int64),
                 spans=a(steps, dtype=np.int64))


def _run(trace, iters=(2, 1), untraced=(10,)):
    solves = [dict(iters=i, traced=True) for i in iters] + [dict(iters=i, traced=False) for i in untraced]
    return Run(setup_s=1.0, solves=solves, window_s=1.0, trace=trace)


def _read(name, run):
    return spec.load_reader(name)(run)


def _launch(name, t):
    return (name, t, t + 1)


# two steps of 100 ns; the hand count of each reader is in its test
GPU = [("k1", 0, 10), ("k2", 40, 60), ("Memcpy DtoH", 80, 90), ("k3", 200, 250), ("k4", 400, 410)]
STEPS = [(0, 100), (200, 300)]
CPU = [
    (spans.KSP_SOLVE, 2, 98), (spans.KSP_SOLVE, 202, 299),
    (L0, 12, 70), (L1, 20, 50), (L1, 55, 65),                  # one cycle, its coarse level entered twice
    (L0, 210, 260), (L1, 215, 240), (spans.level(2), 220, 230),
    (spans.READ, 70, 85), (spans.READ, 72, 80),                # a read across an idle edge, one inside it
    (spans.READ, 90, 95), (spans.READ, 260, 290), (spans.READ, 150, 160),  # the last outside the steps
    _launch("cudaLaunchKernel", 1), _launch("cudaLaunchKernel", 21), _launch("cudaLaunchKernel", 41),
    _launch("cudaLaunchKernel", 56), _launch("cudaLaunchKernel", 216), _launch("cudaLaunchKernel", 230),
    _launch("cuLaunchKernel", 222), _launch("cudaLaunchKernelExC", 65), _launch("cudaMemcpyAsync", 25),
    _launch("cudaLaunchKernel", 150),
]


def test_the_readers_count_by_hand():
    run = _run(_trace(GPU, STEPS, CPU))
    # busy [0,10) [40,60) [80,90) [200,250): idle [10,40) [60,80) [90,100) [250,300), 110 of 200 ns
    assert spans.seconds(spans.idle(run.trace)) == pytest.approx(110e-9)
    # reads: [70,85) + [90,95) + [260,290) = 50 ns
    assert _read("host_wait_pct.solve", run) == pytest.approx(25.0)
    # idle inside level 0: [12,40) + [60,70) + [250,260) = 48 ns
    assert _read("idle_in_pc_pct.solve", run) == pytest.approx(24.0)
    # idle inside the solves, outside level 0: [10,12) + [70,80) + [90,98) + [260,299) = 59 ns
    assert _read("idle_in_krylov_pct.solve", run) == pytest.approx(29.5)
    # launch calls starting in [20,50) [55,65) [215,240): 21, 41, 56, 216, 222, 230 (65 is the edge, out)
    assert _read("coarse_launches_per_iter.solve", run) == pytest.approx(6 / 3)


def test_pc_and_krylov_split_the_idle_time_of_the_solves():
    run = _run(_trace(GPU, STEPS, CPU))
    in_solves = spans.seconds(spans.intersect(spans.idle(run.trace), spans.named(run.trace, spans.KSP_SOLVE)))
    split = _read("idle_in_pc_pct.solve", run) + _read("idle_in_krylov_pct.solve", run)
    assert split == pytest.approx(100 * in_solves / run.trace.window_s)
    device_idle = spec.load_reader("device_idle_pct.solve")(run)
    assert split <= device_idle and device_idle - split == pytest.approx(100 * 3e-9 / 200e-9)  # [98,100) [299,300)


def _mask(iv, n):
    m = np.zeros(n, dtype=bool)
    for s, e in iv:
        m[s:e] = True
    return m


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_interval_arithmetic_matches_a_count_of_each_nanosecond(seed):
    rng = np.random.default_rng(seed)
    n = 400

    def random_intervals(k):
        s = rng.integers(0, n - 1, k)
        return np.stack([s, np.minimum(n, s + rng.integers(0, 60, k))], axis=1)

    a, b = random_intervals(12), random_intervals(9)
    ua, ub = spans.union(a), spans.union(b)
    ma, mb = _mask(a, n), _mask(b, n)
    assert np.array_equal(_mask(ua, n), ma) and np.all(ua[1:, 0] > ua[:-1, 1])
    assert np.array_equal(_mask(spans.intersect(ua, ub), n), ma & mb)
    assert np.array_equal(_mask(spans.subtract(ua, ub), n), ma & ~mb)
    points = rng.integers(0, n, 50)
    assert np.array_equal(spans.member(points, ua), ma[points])


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_the_split_holds_on_random_traces(seed):
    rng = np.random.default_rng(seed)
    steps = [(0, 1000), (1500, 2600)]
    gpu = [(f"k{i}", s, s + int(rng.integers(1, 40))) for i, s in enumerate(rng.integers(0, 2600, 60))]
    cpu = [(spans.KSP_SOLVE, 5, 990), (spans.KSP_SOLVE, 1510, 2590)]
    # cycles lie inside the solves, as the program nests them; reads may
    # run past a cycle's end
    for s in np.concatenate([rng.integers(10, 920, 10), rng.integers(1515, 2500, 10)]):
        cpu += [(L0, s, s + 60), (L1, s + 10, s + 30), (spans.READ, s + 50, s + 75)]
    run = _run(_trace(gpu, steps, cpu))
    split = _read("idle_in_pc_pct.solve", run) + _read("idle_in_krylov_pct.solve", run)
    idle = _mask(spans.idle(run.trace), 2600)
    assert split == pytest.approx(100 * (idle & _mask(spans.named(run.trace, spans.KSP_SOLVE), 2600)).sum() / 2100)
    assert split <= spec.load_reader("device_idle_pct.solve")(run) + 1e-9


def test_no_reading_without_the_spans():
    for name in NAMES:
        assert _read(name, Run(setup_s=1.0, solves=[dict(iters=3, traced=True)], window_s=1.0)) is None
    # a program that opens no span (the benchmark laid over an older commit)
    bare = _run(_trace(GPU, STEPS, [c for c in CPU if not c[0].startswith("tpusparse:")]))
    assert [_read(name, bare) for name in NAMES] == [None] * 4
    assert spans.report(bare) == [f"spans: idle outside {spans.KSP_SOLVE} 0.000000 s (55.000%); launch calls in"
                                  f" the steps 8"]
    # a run on the CPU: the reads are there, no device event is
    cpu_only = _run(_trace([], STEPS, CPU))
    assert _read("host_wait_pct.solve", cpu_only) == pytest.approx(25.0)
    assert [_read(name, cpu_only) for name in NAMES[1:]] == [None] * 3
    # a cycle with no coarse level reads no coarse launches
    flat = _run(_trace(GPU, STEPS, [c for c in CPU if c[0] not in (L1, spans.level(2))]))
    assert _read("coarse_launches_per_iter.solve", flat) is None
    assert _read("idle_in_pc_pct.solve", flat) == pytest.approx(24.0)


def test_the_report_splits_by_level():
    run = _run(_trace(GPU, STEPS, CPU))
    lines = spans.report(run)
    assert [line.split(":")[1] for line in lines[:3]] == ["level0", "level1", "level2"]
    # level 1's own launches: 21, 41, 56, 216, 230 (222 lies in level 2), over 3 inner iterations
    assert "launch calls of its own 1.67 an inner iteration" in lines[1]
    assert "launch calls of its own 0.33 an inner iteration" in lines[2]
    assert lines[-1].endswith("launch calls in the steps 8")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card_reads_the_spans(capsys, tmp_path, monkeypatch, card, workload):
    """On the card at 64^3, the profile cut to the first step: every
    per-layer metric read, the two idle shares within 2 points of (and not
    above) ``device_idle_pct.solve``, the coarse launches no more than all
    launches, each solve's span inside its step and opened before the
    step's first device event (the spans share the device events' clock,
    to within ``CLOCK_NS``), and the launch calls in the steps within 2% of
    the kernels the trace shows there.  The traced window's clock starts
    before the first right-hand side is made, which takes milliseconds, so
    ``trace_seconds`` is 0.05: the first step is traced, and no other."""
    captured = []
    capture = trace.capture

    @contextlib.contextmanager
    def keep(device):
        with capture(device) as out:
            captured.append(out)
            yield out

    monkeypatch.setattr(trace, "capture", keep)
    root = _copy(tmp_path)
    path = root / "benchmark/traffic/rhs_stream.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "trace_seconds": 0.05}))
    rc = bench_run.main(["--workload", workload, "--seed", "3000000031", "--seconds", "2", "--trace", "1"],
                        root=root, config_overrides={"grid": [64, 64, 64]})
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"] is True and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"inner_iters.solve", "launches_per_iter.solve", "kernel_roofline_pct.solve",
                                      "device_idle_pct.solve", *NAMES}
    value = {name: m["value"] for name, m in result["metrics"].items()}
    split = value["idle_in_pc_pct.solve"] + value["idle_in_krylov_pct.solve"]
    assert value["device_idle_pct.solve"] - 2 <= split <= value["device_idle_pct.solve"] + 1e-9
    assert 0 < value["coarse_launches_per_iter.solve"] <= value["launches_per_iter.solve"]
    (t,) = captured[-1]
    steps, solves = spans.steps(t), spans.named(t, spans.KSP_SOLVE)
    assert len(solves) == len(steps) and spans.subtract(solves, steps).size == 0
    for (start, end), (opened, _) in zip(steps, solves):
        assert t.gpu_start[(t.gpu_start >= start) & (t.gpu_start < end)].min() >= opened - CLOCK_NS
    kernels = int(t.kernel_mask().sum())
    assert abs(int(spans.member(spans.launch_starts(t), steps).sum()) - kernels) <= 0.02 * kernels

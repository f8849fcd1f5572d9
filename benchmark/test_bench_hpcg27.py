"""HPCG's configuration (``hpcg432_stencil27``): the program's operator
against the plain reference and HPCG's row counts, the cell end to end on
the CPU at 16^3 and its control, the three fine-level readers
(``fine_roofline_pct.solve``, ``fine_applies_per_iter.solve``,
``defect_pct.solve``) on hand-built traces, and, on the card, every
per-layer metric of the cell at 64^3 and the fine kernel at 432^3, whose
float64 coefficient stack holds more than 2^31 elements."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import control, run, spec
from benchmark.reference.hpcg27 import HPCG27
from benchmark.roofline import least_seconds
from benchmark.run import Run
from benchmark.test_bench_harness import _copy, card, run_cell  # noqa: F401  (card: a fixture)
from benchmark.test_bench_spans import _trace
from benchmark.test_bench_trace import PEAK
from tpusparse_torch import Grid3D
from tpusparse_torch.grid.hpcg import hpcg_stencil

CELL = "hpcg432_stencil27.rhs_stream"
SMALL = {"grid": [16, 16, 16]}
FINE = ("fine_roofline_pct.solve", "fine_applies_per_iter.solve")


@pytest.mark.parametrize("shape", [(12, 12, 12), (7, 5, 6)])
def test_the_operator_is_the_references(shape):
    nz, ny, nx = shape
    x = torch.randn(shape, dtype=torch.float64, generator=torch.Generator().manual_seed(12))
    got = hpcg_stencil(Grid3D(nx, ny, nz), torch.float64, "cpu").mv(x)
    ref = HPCG27(shape)
    want = ref.apply(x, 0, nz)
    assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())
    # the reference's blocks join up: planes 2 at a time equal all at once
    assert torch.equal(torch.cat([ref.apply(x, z, min(z + 2, nz)) for z in range(0, nz, 2)]), want)
    rnorm, bnorm = ref.residual(x, want, block=3)
    assert rnorm <= 1e-13 * bnorm


def test_rows_count_as_hpcgs():
    """8, 12, 18 and 27 nonzeros at the corners, edges, faces and interior
    of 12^3 (GenerateProblem_ref.cpp's nonzerosInRow), 26 on the diagonal
    and -1 elsewhere."""
    a = hpcg_stencil(Grid3D(12, 12, 12), torch.float64, "cpu").to_csr().to_scipy()
    counts = np.bincount(np.diff(a.indptr))
    assert {int(c): int(counts[c]) for c in np.flatnonzero(counts)} == {8: 8, 12: 12 * 10, 18: 6 * 100, 27: 1000}
    assert np.all(a.diagonal() == 26.0) and set(np.unique(a.data)) == {-1.0, 26.0}
    assert (a != a.T).nnz == 0


def test_the_cell_runs_on_the_cpu_and_is_correct(capsys):
    cell = spec.load_cell(CELL)
    assert cell.family == "hpcg27" and cell.config["grid"] == [432, 432, 432]
    rc, result = run_cell(capsys, CELL, trace=1)
    assert rc == 0 and result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 4
    assert result["checks"]["rel_residual_max"]["value"] <= 1e-8


def test_the_float32_control_is_not_correct(capsys):
    cell = spec.load_cell(CELL)
    cell.config = {**cell.config, **SMALL}
    assert max(control.readings(cell, "mixed", [101, 102], 2, torch.device("cpu"))) <= 1e-8
    assert min(control.readings(cell, "f32", [101, 102, 103], 1, torch.device("cpu"))) > 3e-8
    rc, result = run_cell(capsys, CELL, config_overrides={**SMALL, "precision": "f32"})
    assert rc == 0 and result["correct"] is False and result["failed"] > 0


# --- the readers on hand-built traces ------------------------------------

V27_KERNEL = "void (anonymous namespace)::varstencil27_kernel<{}, {}, true>(...)"


def _v27(n: int, pair: int) -> tuple:
    """A recorded varstencil27_mv launch's integer arguments on an n^3 grid."""
    return (None, None, None, n, n, n, 1, pair, -(-n // 64), -(-n // 16))


def _fine_run(launches, gpu, cpu=(), steps=((0, 1000), (2000, 3000)), iters=(2, 3)):
    trace = _trace(gpu, list(steps), list(cpu))
    solves = [dict(iters=i, traced=True) for i in iters] + [dict(iters=50, traced=False)]
    return Run(setup_s=1.0, solves=solves, window_s=1.0, trace=trace, launches=launches,
               models=spec.load_kernel_models(), peak=PEAK)


def _read(name, run):
    return spec.load_reader(name)(run)


# launches in order: fine f32 on 8^3, coarse f32 on 3^3, fine f64, fine f32
# between the steps, a K5 launch; the trace lists its events out of order
LAUNCHES = [("tps_varstencil27_mv", _v27(8, 1)), ("tps_varstencil27_mv", _v27(3, 1)),
            ("tps_varstencil27_mv", _v27(8, 2)), ("tps_dia_mv", (1, 2, 3, 100, 7)),
            ("tps_varstencil27_mv", _v27(8, 1))]
GPU = [("dia_mv_window_kernel", 500, 600),
       (V27_KERNEL.format("double", "double"), 300, 400),
       (V27_KERNEL.format("float", "float"), 1500, 1600),   # after the first step: not inside one
       (V27_KERNEL.format("float", "float"), 10, 110),
       (V27_KERNEL.format("float", "float"), 200, 250)]     # the coarse launch


def test_the_fine_readers_count_by_hand():
    r = _fine_run(LAUNCHES, GPU)
    model = next(m for m in r.models if m["name"] == "V27")
    least = sum(least_seconds(model, _v27(8, pair), PEAK) for pair in (1, 1, 2))
    assert least == pytest.approx((512 * 116 * 2 + 512 * 232) / PEAK["hbm_bytes_per_s"])
    # the three fine launches' 100 ns each; the 3^3 launch is not counted
    assert _read("fine_roofline_pct.solve", r) == pytest.approx(100 * least / 300e-9)
    # two of them ran inside the steps, over 5 traced inner iterations
    assert _read("fine_applies_per_iter.solve", r) == pytest.approx(2 / 5)


def test_a_launch_on_a_smaller_grid_is_not_fine():
    only_coarse = _fine_run([LAUNCHES[1]], [GPU[4]])
    model = next(m for m in only_coarse.models if m["name"] == "V27")
    # alone, the 3^3 launch is the largest grid recorded, and so the fine one
    assert _read("fine_roofline_pct.solve", only_coarse) == pytest.approx(
        100 * least_seconds(model, _v27(3, 1), PEAK) / 50e-9)
    # beside an 8^3 launch it is left out, though it ran in the step
    two = _fine_run([LAUNCHES[1], LAUNCHES[0]], [GPU[4], GPU[3]])
    assert _read("fine_applies_per_iter.solve", two) == pytest.approx(1 / 5)


def test_no_fine_reading_without_a_match():
    # a count that does not match the trace's, no recorded launch, no trace
    for r in (_fine_run(LAUNCHES, GPU[:-1]), _fine_run(LAUNCHES[3:4], GPU[:1]),
              Run(setup_s=1.0, solves=[dict(iters=3, traced=True)], window_s=1.0, launches=LAUNCHES)):
        assert [_read(name, r) for name in FINE] == [None, None]


# two steps of 1000 ns, busy [0,400) [500,700) and [2000,2600); the defect
# spans: one in the first step over [300,600), one past the steps
BUSY = [("k", 0, 400), ("k", 500, 700), ("k", 2000, 2600)]
DEFECTS = [("tpusparse:defect", 300, 600), ("tpusparse:read", 550, 600), ("tpusparse:defect", 1200, 1300)]


def test_defect_pct_counts_by_hand():
    # busy inside the defect span: [300,400) + [500,600) = 200 of 1200 ns;
    # the second step has none and adds only to the whole
    assert _read("defect_pct.solve", _fine_run([], BUSY, DEFECTS)) == pytest.approx(100 * 200 / 1200)


def test_a_step_with_no_defect_span_gives_0():
    assert _read("defect_pct.solve", _fine_run([], BUSY, DEFECTS[2:])) == 0.0
    # a program that opens no such span (the parent's) gives no reading
    assert _read("defect_pct.solve", _fine_run([], BUSY, DEFECTS[1:2])) is None
    assert _read("defect_pct.solve", _fine_run([], [], DEFECTS)) is None  # a run on the CPU


# --- on the card ---------------------------------------------------------


@pytest.mark.requires_cuda
def test_the_cell_on_the_card_reads_every_metric(capsys, tmp_path, card):
    """At 64^3, the profile cut to the first step: correct, every per-layer
    metric BENCHMARK.json lists for the cell read, each share of a roofline
    at most 100%, and 6 to 10 fine applies an inner iteration."""
    root = _copy(tmp_path)
    path = root / "benchmark/traffic/rhs_stream.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "trace_seconds": 0.05}))
    rc = run.main(["--workload", CELL, "--seed", "3000000031", "--seconds", "2", "--trace", "1"],
                  root=root, config_overrides={"grid": [64, 64, 64]})
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"] is True and result["device"]["platform"] == "gpu"
    metrics = {name: m["value"] for name, m in result["metrics"].items()}
    assert set(metrics) == {m["name"] for m in spec.load_cell(CELL, root).per_layer}
    for name in ("kernel_roofline_pct.solve", "fine_roofline_pct.solve"):
        assert 0 < metrics[name] <= 100
    assert 6 <= metrics["fine_applies_per_iter.solve"] <= 10
    assert 0 < metrics["defect_pct.solve"] < 100


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_fine_kernel_at_432_equals_the_twin(card, dtype):
    """One ``varstencil27_mv`` launch at 432^3 on random coefficients and x
    against the twin (``varstencil27_mv_torch`` on the CUDA tensors) on the
    first, a middle and the last plane: the last plane's coefficients lie
    past 2^31 elements (float64: past 2^34 bytes) of the stack."""
    from tpusparse_torch.kernels.varstencil27 import varstencil27_mv, varstencil27_mv_torch

    n = 432
    gen = torch.Generator(device="cuda").manual_seed(432)
    coef = torch.randn((27, n, n, n), dtype=dtype, device="cuda", generator=gen)
    x = torch.randn((n, n, n), dtype=dtype, device="cuda", generator=gen)
    assert coef.numel() > 2 ** 31
    y = varstencil27_mv(coef, x)
    for k in (0, n // 2, n - 1):
        lo, hi = max(k - 1, 0), min(k + 2, n)
        want = varstencil27_mv_torch(coef[:, lo:hi], x[lo:hi])[k - lo]
        assert torch.equal(y[k], want), k

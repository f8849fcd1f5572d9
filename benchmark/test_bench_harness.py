"""The harness end to end on the CPU at a tiny grid, its files found by name,
and the contract's shape of ``BENCHMARK.json``.

    python -m pytest benchmark/ -q

The driver's ``pytest tests/`` does not collect these.
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import rhs, run, spec

REPO = spec.REPO
CELLS = ["poisson720_stencil.rhs_stream", "poisson300_aij.rhs_stream"]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}
SMALL = {"grid": [16, 16, 16]}


def run_cell(capsys, workload, trace=0, seed=3000000019, seconds=1.0, **kw):
    """``run.main`` on the CPU; (exit code, the last line's JSON or None)."""
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                  device="cpu", config_overrides=kw.pop("config_overrides", SMALL), **kw)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_end_to_end_on_cpu(capsys, workload, trace):
    rc, result = run_cell(capsys, workload, trace)
    assert rc == 0
    assert KEYS <= set(result) and list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 4
    assert result["device"]["platform"] == "cpu"
    want = {"setup_s", "solve_s"} if trace == 0 else {"inner_iters.solve"}
    assert want <= set(result["metrics"])
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    if trace:
        assert "breakdown" in result and "window_s" in result["device"]


def test_the_same_seed_gives_the_same_inputs(capsys):
    mix = spec.load_cell(CELLS[1]).traffic
    for step in range(3):
        assert torch.equal(rhs.make_rhs(mix, (6, 5, 4), 77, step, device="cpu"),
                           rhs.make_rhs(mix, (6, 5, 4), 77, step, device="cpu"))
    counts = []
    for _ in range(2):
        run.main(["--workload", CELLS[1], "--seed", "77", "--seconds", "0.5", "--trace", "0"], device="cpu",
                 config_overrides=SMALL)
        counts.append([line.split(" in ")[0] for line in capsys.readouterr().out.splitlines()
                       if line.startswith("solve ")])
    n = min(map(len, counts))
    assert n >= 2 and counts[0][:n] == counts[1][:n]


def test_no_gpu_means_no_result(capsys):
    # this sandbox has no CUDA device: the command refuses, as on a machine short of cards
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""


def test_a_bare_benchmark_directory_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([*bench["command"], "--workload", CELLS[1], "--seed", "5", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert not proc.stdout.strip().endswith("}")


def _copy(tmp_path) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_added_files_are_found_by_name(capsys, tmp_path):
    """A configuration, a mix, a per-layer metric and a kernel model added
    as files alone, with their entries in BENCHMARK.json."""
    root = _copy(tmp_path)
    cfg = json.loads((root / "benchmark/configs/poisson300_aij.json").read_text())
    cfg.update(name="poisson12_stencil", route="stencil", grid=[12, 12, 12])
    cfg["ksp"]["layout"] = "padded"
    (root / "benchmark/configs/poisson12_stencil.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "benchmark/traffic/rhs_stream.json").read_text())
    mix.update(modes=2, noise_share=0.05)
    (root / "benchmark/traffic/two_mode_stream.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/outer_iters.solve.py").write_text(
        "def read(run):\n    return sum(s['outer_iters'] for s in run.solves) / len(run.solves)\n")
    (root / "benchmark/kernel_models/K99.json").write_text(json.dumps(
        {"entry": "tps_new", "kernel": "new_kernel", "args": {"n": 3}, "check": "n > 0",
         "bytes": "8 * n", "flops": "n", "source": "a test"}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "poisson12_stencil", "source": "https://example.org/paper",
                             "file": "benchmark/configs/poisson12_stencil.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "poisson12_stencil.two_mode_stream", "config": "poisson12_stencil",
                               "traffic": "two_mode_stream", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "outer_iters.solve", "unit": "sweeps", "better": "lower",
                               "source": "program_counter", "layer": "Krylov", "moves": "solve_s",
                               "workloads": ["poisson12_stencil.two_mode_stream"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, result = run_cell(capsys, "poisson12_stencil.two_mode_stream", trace=1, root=root, config_overrides={})
    assert rc == 0 and result["correct"] is True
    assert "outer_iters.solve" in result["metrics"]
    assert "K99" in {m["name"] for m in spec.load_kernel_models(root)}
    out = run_cell(capsys, "poisson12_stencil.two_mode_stream", root=root, config_overrides={})[1]
    assert set(out["metrics"]) == {"setup_s", "solve_s"}


@pytest.mark.parametrize("change", [{"noise_share": 0.0}, {"scale_exponent": 0}, {"modes": 1, "wavenumber_max": 1},
                                    {"warmup_steps": 2, "sample": 1}])
def test_mix_parameters(capsys, tmp_path, change):
    root = _copy(tmp_path)
    path = root / "benchmark/traffic/rhs_stream.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **change}))
    rc, result = run_cell(capsys, CELLS[0], root=root)
    assert rc == 0 and result["correct"] is True


def _imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (REPO / "benchmark").rglob("*.py"):
        found = _imported_tops(path) & set(run.FORBIDDEN)
        assert not found, f"{path} imports {found}"


def test_a_run_loads_no_jax_module():
    code = ("import sys\nfrom benchmark import run\n"
            "rc = run.main(['--workload', 'poisson300_aij.rhs_stream', '--seed', '9', '--seconds', '0.2',"
            " '--trace', '0'], device='cpu', config_overrides={'grid': [12, 12, 12]})\n"
            "print('LOADED', run.forbidden_modules(), rc)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert "LOADED [] 0" in proc.stdout, proc.stderr[-2000:]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpusparse_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpusparse.sub", sys)
    assert run.forbidden_modules() == ["tpusparse"]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keeps_to_the_contract():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    cells = bench["workloads"]
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert (REPO / "benchmark/traffic" / f"{w['traffic']}.json").is_file()
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= {w["name"] for w in cells}
        assert (REPO / "benchmark/metrics" / f"{m['name']}.py").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower", "higher")
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card_reads_every_metric(capsys, tmp_path, card, workload):
    """On the card at 64^3: correct, and every per-layer metric that
    BENCHMARK.json lists for the cell read from the trace, each roofline
    share at most 100%.  The profile is cut to the first steps: seconds of
    64^3 solves are more events than the profiler keeps."""
    root = _copy(tmp_path)
    path = root / "benchmark/traffic/rhs_stream.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "trace_seconds": 0.05}))
    rc = run.main(["--workload", workload, "--seed", "3000000031", "--seconds", "2", "--trace", "1"],
                  root=root, config_overrides={"grid": [64, 64, 64]})
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"] is True and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {m["name"] for m in spec.load_cell(workload, root).per_layer}
    assert 0 < result["metrics"]["kernel_roofline_pct.solve"]["value"] <= 100
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]

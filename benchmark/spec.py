"""Finding a cell's pieces by the names ``BENCHMARK.json`` gives them.

Every lookup takes the checkout's root, so a test can point the harness
at a copy that holds added files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DEFAULT_FAMILY = "poisson7"  # a configuration without ``family``


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    chips: int
    config: dict            # configs/<config>.json
    family: str             # the configuration's problem: problems/<family>.py
    traffic: dict           # traffic/<traffic>.json
    end_to_end: list[dict]  # the metric entries this cell reports with --trace 0
    per_layer: list[dict]   # ... and with --trace 1
    root: Path


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = REPO) -> Cell:
    """The cell named ``workload`` in ``root``/BENCHMARK.json; raise
    ``KeyError`` when it is not there and ``FileNotFoundError`` when a file
    it names is missing."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{entry['traffic']}.json").read_text())
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=config,
        family=config.get("family", DEFAULT_FAMILY),
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
        root=root,
    )


def _load_module(path: Path, name: str, what: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {what} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str, root: Path = REPO):
    """The ``read(run)`` function of ``benchmark/metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    return _load_module(path, f"benchmark_metric_{metric.replace('.', '_')}", f"reader for metric {metric!r}").read


def load_problem(family: str, root: Path = REPO):
    """The module ``benchmark/problems/<family>.py``: its ``build`` and
    ``reference`` (``benchmark/problems/__init__.py`` has the contract)."""
    path = root / "benchmark" / "problems" / f"{family}.py"
    return _load_module(path, f"benchmark_problem_{family.replace('.', '_')}", f"problem {family!r}")


def load_kernel_models(root: Path = REPO) -> list[dict]:
    """Every ``benchmark/kernel_models/*.json``, each with its file's stem
    as ``name``."""
    models = []
    for path in sorted((root / "benchmark" / "kernel_models").glob("*.json")):
        model = json.loads(path.read_text())
        model["name"] = path.stem
        models.append(model)
    return models


def load_peaks(root: Path = REPO) -> dict:
    """The table of published peaks, by the name the card reports."""
    return json.loads((root / "benchmark" / "peaks.json").read_text())

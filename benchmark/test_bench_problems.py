"""A configuration's problem, found by name: the two cells' Poisson7, a
family added in a copy of the checkout by new files alone and judged by its
own plain reference, and an unknown family refused before any solve."""

from __future__ import annotations

import json

import pytest

from benchmark import run, spec
from benchmark.test_bench_harness import CELLS, REPO, _copy, _imported_tops, run_cell
from tpusparse_torch import StarStencil3D
from tpusparse_torch.sparse.dia import DFDIA

SMALL = {"grid": [16, 16, 16]}


@pytest.mark.parametrize("workload,op_type", [(CELLS[0], StarStencil3D), (CELLS[1], DFDIA)])
def test_the_cells_build_poisson7(workload, op_type):
    cell = spec.load_cell(workload)
    assert cell.family == "poisson7"
    problem = spec.load_problem(cell.family)
    config = {**cell.config, **SMALL}
    sys_ = problem.build(config, "cpu")
    assert type(sys_.ksp._op) is op_type and sys_.shape == (16, 16, 16)
    ref = problem.reference(config)
    assert type(ref).__name__ == "Poisson7" and ref.shape == (16, 16, 16)


def test_no_reference_imports_the_program():
    for path in (REPO / "benchmark" / "reference").rglob("*.py"):
        found = _imported_tops(path) & {"tpusparse_torch", *run.FORBIDDEN}
        assert not found, f"{path} imports {found}"


# HPCG's operator: 26 on the diagonal and -1 to each of the 26 neighbours in
# the box, zero-filled past the grid; a plain reference and the program's
# build, each a file of its own
BOX27_REFERENCE = '''
import torch
import torch.nn.functional as F


class Box27:
    def __init__(self, shape):
        self.shape = tuple(shape)

    def residual(self, x, b):
        x = x.reshape(self.shape).to(torch.float64)
        b = b.reshape(self.shape).to(torch.float64)
        box = F.conv3d(F.pad(x[None, None], (1,) * 6), torch.ones((1, 1, 3, 3, 3), dtype=torch.float64))[0, 0]
        return float(torch.linalg.vector_norm(b - (27 * x - box))), float(torch.linalg.vector_norm(b))
'''

BOX27_PROBLEM = '''
import importlib.util
from pathlib import Path

import numpy as np
import scipy.sparse as sp

from benchmark.reference.poisson7 import Poisson7
from benchmark.system import DTYPES, System, new_ksp


def build(config, device, precision=None):
    precision = precision or config["precision"]
    nx, ny, nz = config["grid"]
    line = [sp.diags([np.ones(n - 1), np.ones(n), np.ones(n - 1)], [-1, 0, 1]) for n in (nz, ny, nx)]
    a = (27 * sp.identity(nx * ny * nz) - sp.kron(sp.kron(line[0], line[1]), line[2])).tocsr()
    ksp = new_ksp(config, precision)
    ksp.set_operators(a, device=device)
    ksp.setup()
    return System(ksp=ksp, shape=(nz, ny, nx), flat=True, dtype=DTYPES[precision])


def reference(config):
    nx, ny, nz = config["grid"]
    path = Path(__file__).resolve().parent.parent / "reference" / "box27.py"
    spec = importlib.util.spec_from_file_location("box27_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return {reference}
'''


def _add_box27(root, reference: str) -> str:
    """The family ``box27``, its 12^3 configuration and one cell, added as
    files to the copy at ``root``; the cell's name."""
    (root / "benchmark/reference/box27.py").write_text(BOX27_REFERENCE)
    (root / "benchmark/problems/box27.py").write_text(BOX27_PROBLEM.replace("{reference}", reference))
    cfg = json.loads((root / "benchmark/configs/poisson300_aij.json").read_text())
    for key in ("route", "pin", "extent", "problem"):
        del cfg[key]
    cfg.update(name="box27_12", family="box27", grid=[12, 12, 12])
    (root / "benchmark/configs/box27_12.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "box27_12", "source": "https://www.hpcg-benchmark.org",
                             "file": "benchmark/configs/box27_12.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "box27_12.rhs_stream", "config": "box27_12", "traffic": "rhs_stream",
                               "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return "box27_12.rhs_stream"


@pytest.mark.parametrize("reference,correct", [("module.Box27((nz, ny, nx))", True),
                                               ("Poisson7((nz, ny, nx), (2.0, 2.0, 2.0), pin=False)", False)])
def test_a_family_added_by_files_alone_is_judged_by_its_own_reference(capsys, tmp_path, reference, correct):
    """The right reference passes the program's solves; a reference of
    another operator (Poisson7 on another extent) fails the same solves."""
    root = _copy(tmp_path)
    workload = _add_box27(root, reference)
    assert spec.load_cell(workload, root).family == "box27"
    rc, result = run_cell(capsys, workload, root=root, config_overrides={})
    assert rc == 0 and result["attempted"] >= 4
    checks = result["checks"]
    assert checks["unconverged"]["value"] == 0
    assert result["correct"] is correct
    over = checks["rel_residual_max"]["value"] > checks["rel_residual_max"]["limit"]
    assert over is not correct and (result["failed"] > 0) is not correct


def test_an_unknown_family_fails_before_any_solve(capsys, tmp_path, monkeypatch):
    root = _copy(tmp_path)
    path = root / "benchmark/configs/poisson300_aij.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "family": "poisson9"}))
    from tpusparse_torch.ksp import KSP

    def no_solve(*args, **kwargs):
        raise AssertionError("a solve ran")

    monkeypatch.setattr(KSP, "solve", no_solve)
    monkeypatch.setattr(KSP, "setup", no_solve)
    with pytest.raises(FileNotFoundError, match="no problem 'poisson9' at") as err:
        run_cell(capsys, CELLS[1], root=root)
    assert str(root / "benchmark/problems/poisson9.py") in str(err.value)
    assert capsys.readouterr().out == ""

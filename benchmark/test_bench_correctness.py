"""What decides ``correct``, shown to fail where it must: the control (the
program's own uniform float32 path, the nearest precision below the
configuration's float64 defect correction) reads above the limit, and a
run whose timed path is broken underneath comes out not correct."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from benchmark import control, spec
from tpusparse_torch.ksp import KSP

from benchmark.test_bench_harness import CELLS, run_cell

SMALL = {"grid": [20, 20, 20]}


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limit_and_the_program_meets_it(workload):
    cell = spec.load_cell(workload)
    cell.config = {**cell.config, **SMALL}
    limit = cell.config["ksp"]["rtol"]
    sound = control.readings(cell, "mixed", [101, 102, 103], 2, torch.device("cpu"))
    low = control.readings(cell, "f32", [101, 102, 103], 1, torch.device("cpu"))
    assert max(sound) <= limit
    assert min(low) > 3 * limit


def _zeroed(res, b):
    return dataclasses.replace(res, x=torch.zeros_like(res.x))


def _half(res, b):
    x = res.x.clone().reshape(-1)
    x[x.numel() // 2:] = 0
    return dataclasses.replace(res, x=x.reshape(res.x.shape))


def _altered(res, b):
    x = res.x.clone().reshape(-1)
    x[x.numel() // 3] += 1e-3 * float(x.abs().max())
    return dataclasses.replace(res, x=x.reshape(res.x.shape))


def _unconverged(res, b):
    return dataclasses.replace(res, reason=-3)


# a step that returns its state (x0 = 0) unchanged; half of the answer left
# out; an answer altered where it is produced; a solve that gave up.  The
# exchange between chips has no place in a one-chip cell.
FAULTS = {"unchanged": _zeroed, "half": _half, "altered": _altered, "unconverged": _unconverged}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(capsys, monkeypatch, workload, fault):
    solve = KSP.solve

    def broken(self, b, x0=None):
        return FAULTS[fault](solve(self, b, x0), b)

    monkeypatch.setattr(KSP, "solve", broken)
    rc, result = run_cell(capsys, workload)
    assert rc == 0 and result["correct"] is False and result["failed"] > 0
    assert json.dumps(result).endswith("}}")

"""The kernel model of ``varstencil27_mv`` (``kernel_models/V27.json``):
its bytes and flops by dtype pair, its check, and its argument positions
against the wrapper's own launch."""

from __future__ import annotations

import re

import pytest
import torch

from benchmark import spec
from benchmark.roofline import evaluate, least_seconds
from benchmark.test_bench_trace import PEAK, _record
from benchmark.test_bench_harness import REPO

SHAPE = (5, 6, 7)  # (nz, ny, nx), each extent its own
N = 5 * 6 * 7


def _model() -> dict:
    (model,) = [m for m in spec.load_kernel_models() if m["name"] == "V27"]
    return model


@pytest.mark.parametrize("pair,per_cell", [(0, 62), (1, 116), (2, 232), (3, 58)])
def test_bytes_and_flops_by_dtype_pair(pair, per_cell):
    m = _model()
    names = {"nz": SHAPE[0], "ny": SHAPE[1], "nx": SHAPE[2], "k": 1, "pair": pair}
    assert evaluate(m["check"], names)
    assert evaluate(m["bytes"], names) == N * per_cell
    assert evaluate(m["flops"], names) == 53 * N
    # k columns: the coefficients once, each column's field read and written
    s_x = {0: 4, 1: 4, 2: 8, 3: 2}[pair]
    assert evaluate(m["bytes"], {**names, "k": 3}) == N * (per_cell + 4 * s_x)
    assert evaluate(m["flops"], {**names, "k": 3}) == 53 * N * 3


@pytest.mark.parametrize("bad", [{"pair": 4}, {"pair": -1}, {"k": 0}, {"nz": 0}, {"ny": 0}, {"nx": 0}])
def test_the_check_refuses_what_the_kernel_cannot_run(bad):
    m = _model()
    names = {"nz": 3, "ny": 3, "nx": 3, "k": 1, "pair": 0, **bad}
    assert not evaluate(m["check"], names)
    args = [None] * 10
    for name, i in m["args"].items():
        args[i] = names[name]
    with pytest.raises(ValueError, match="fail the check"):
        least_seconds(m, tuple(args), PEAK)


class _OnCard:
    """A CPU tensor that reports a CUDA device, so that the wrapper takes
    its launch branch; the launch itself is replaced."""

    device = torch.device("cuda", 0)

    def __init__(self, t: torch.Tensor):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.mark.parametrize("dtypes,pair", [((torch.bfloat16, torch.float32), 0), ((torch.float32, torch.float32), 1),
                                         ((torch.float64, torch.float64), 2),
                                         ((torch.bfloat16, torch.bfloat16), 3)])
def test_model_positions_match_the_wrappers_launch(monkeypatch, dtypes, pair):
    from tpusparse_torch.kernels.varstencil27 import varstencil27_mv

    m = _model()
    coef = torch.zeros((27, *SHAPE), dtype=dtypes[0])
    x = torch.zeros((3, *SHAPE), dtype=dtypes[1])  # k = 3 columns
    (name, args), = _record(monkeypatch, lambda: varstencil27_mv(_OnCard(coef), _OnCard(x)))
    assert name == m["entry"]
    names = {k: args[i] for k, i in m["args"].items()}
    assert names == {"nz": 5, "ny": 6, "nx": 7, "k": 3, "pair": pair}
    assert least_seconds(m, args, PEAK) > 0


def test_the_kernel_name_is_the_sources():
    source = (REPO / "tpusparse_torch/csrc/varstencil27.cu").read_text()
    m = _model()
    assert re.search(rf"__global__[^;{{]*\b{m['kernel']}\(", source)
    assert f'extern "C" int {m["entry"]}(' in source

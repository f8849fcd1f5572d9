"""The spans inside the port's solve path (``utils/profiling.py``): off,
and no ``record_function`` built, without a recording profiler; under
one, on every route that runs on the CPU, one ``tpusparse:ksp.solve`` a
solve holding its reads and level-0 cycles, each ``tpusparse:level<l+1>``
inside a ``tpusparse:level<l>`` down to the coarsest level, and as many
spans as the code makes reads and preconditioner applications; one
``tpusparse:defect`` a defect-correction sweep, holding its residual's
read; a traced solve bit-equal to an untraced one."""

import numpy as np
import pytest
import torch

from tpusparse_torch import KSP, Grid3D
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.grid.hpcg import hpcg_stencil
from tpusparse_torch.grid.poisson import poisson_dia_device, poisson_stencil_device
from tpusparse_torch.utils.profiling import annotate, read

N = 16
TOL = dict(rtol=1e-8, atol=1e-12)
# (precision, layout or "aij", nonzero initial guess)
ROUTES = {
    "padded": ("mixed", "padded", False),
    "plain": ("mixed", "plain", False),
    "aij": ("mixed", "aij", False),
    "f64": ("f64", "plain", False),
    "plain-x0": ("mixed", "plain", True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _system(route):
    """(KSP with its preconditioner built, b, x0 or None)."""
    precision, layout, warm = ROUTES[route]
    grid = Grid3D(N, N, N)
    if layout == "aij":
        hi, lo, b, _ = poisson_dia_device(grid, device="cpu")
        ksp = KSP(**TOL).set_operators(hi, lo)
    else:
        op, b, _ = poisson_stencil_device(grid, device="cpu")
        ksp = KSP(precision=precision, layout=layout, **TOL).set_operators(op)
    ksp.setup()
    x0 = 0.5 * torch.ones_like(b) if warm else None
    return ksp, b, x0


def _profiled(call):
    """``call()``'s result and its ``tpusparse:`` spans by name, each an
    (m, 2) array of (start, end) on the profiler's clock."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = call()
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("tpusparse:"):
            spans.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out, {k: np.array(sorted(v), dtype=np.int64) for k, v in spans.items()}


def _inside(inner, outer) -> bool:
    """Every interval of ``inner`` lies within one of ``outer``."""
    return all(bool(np.any((outer[:, 0] <= s) & (e <= outer[:, 1]))) for s, e in inner)


def _levels(spans) -> list:
    depth = sum(name.startswith("tpusparse:level") for name in spans)
    return [spans[f"tpusparse:level{level}"] for level in range(depth)]


def _check_levels(levels, n_levels):
    assert len(levels) == n_levels  # the deepest span is the coarsest level
    for finer, coarser in zip(levels, levels[1:]):
        assert _inside(coarser, finer)


def test_no_profiler_builds_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert annotate("tpusparse:a") is annotate("tpusparse:b")  # the one shared no-op
    ksp, b, _ = _system("plain")
    assert ksp.solve(b).reason > 0


def test_read_is_item():
    for t in (torch.tensor(2.5, dtype=torch.float64), torch.tensor(3.25), torch.tensor(7)):
        got = read(t)
        assert got == t.item() and type(got) is type(t.item())
    _, spans = _profiled(lambda: read(torch.tensor(1.0)))
    assert len(spans["tpusparse:read"]) == 1


@pytest.mark.parametrize("route", list(ROUTES))
def test_a_solve_gives_its_spans(route):
    ksp, b, x0 = _system(route)
    plain = ksp.solve(b, x0)
    res, spans = _profiled(lambda: ksp.solve(b, x0))
    assert torch.equal(res.x, plain.x) and (res.iters, res.reason) == (plain.iters, plain.reason)
    (solve,) = spans["tpusparse:ksp.solve"]
    for name in ("tpusparse:read", "tpusparse:level0"):
        assert _inside(spans[name], solve[None])
    _check_levels(_levels(spans), len(ksp._pc_state.levels))
    # CG applies the preconditioner once a call and once an iteration; it
    # reads ||b|| and the first residual, then one norm an iteration, and
    # defect correction reads ||b|| and the first true residual (r = b),
    # then one a sweep
    mixed = ROUTES[route][0] == "mixed"
    sweeps = res.outer_iters if mixed else 1
    assert len(spans["tpusparse:level0"]) == res.iters + sweeps
    reads = 2 * sweeps + res.iters + (res.outer_iters + 2 if mixed else 0) + (x0 is not None)
    assert len(spans["tpusparse:read"]) == reads


@pytest.mark.parametrize("kw", [dict(n_devices=4), dict(cg_fusion=True)], ids=["sharded", "fusion"])
def test_the_fused_level_zero_forms_open_level_zero(kw):
    """The z-sharded fused cycle and the full-fusion body, reached through
    ``solve_poisson``: the timed solve (inside ``tpusparse:solve``) applies the
    preconditioner once an iteration and once a sweep, each a level-0
    span holding the coarse levels'."""
    rep, spans = _profiled(lambda: solve_poisson(N, device="cpu", **kw, **TOL))
    timed = spans["tpusparse:solve"]
    levels = [lv[[_inside(iv[None], timed) for iv in lv]] for lv in _levels(spans)]
    assert len(levels[0]) == rep.iters + rep.outer_iters
    _check_levels(levels, 3)  # 16^3 coarsens to 3 levels
    assert all(len(lv) == len(levels[0]) for lv in levels)


def test_spans_follow_the_profiler():
    """Off before a profiler records, on while it records, off after it:
    no setting."""
    assert annotate("x") is annotate("y")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(annotate("x"), torch.profiler.record_function)
    assert annotate("x") is annotate("y")


@pytest.mark.parametrize("route", ["padded", "plain", "aij", "f64", "varstencil27"])
def test_cg_refined_opens_one_defect_span_a_sweep(route, monkeypatch):
    """Under a recording profiler, one ``tpusparse:defect`` inside the solve
    for each sweep of defect correction (none under uniform precision),
    each holding one read, its residual's norm; without one, no span is
    built."""
    if route == "varstencil27":  # HPCG's operator, the 27-point fine level
        grid = Grid3D(N, N, N)
        ksp = KSP(**TOL).set_operators(hpcg_stencil(grid, torch.float64, "cpu"),
                                       hpcg_stencil(grid, torch.float32, "cpu"), device="cpu").setup()
        b = torch.cos(torch.arange(grid.n, dtype=torch.float64)).reshape(grid.shape)
    else:
        ksp, b, _ = _system(route)
    res, spans = _profiled(lambda: ksp.solve(b))
    mixed = route != "f64"
    defects = spans.get("tpusparse:defect", np.zeros((0, 2), dtype=np.int64))
    assert len(defects) == (res.outer_iters if mixed else 0) and (res.outer_iters >= 2) is mixed
    assert _inside(defects, spans["tpusparse:ksp.solve"])
    reads = spans["tpusparse:read"]
    for s, e in defects:
        assert int(np.sum((s <= reads[:, 0]) & (reads[:, 1] <= e))) == 1
    built = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: built.append(name))
    assert ksp.solve(b).outer_iters == res.outer_iters and built == []

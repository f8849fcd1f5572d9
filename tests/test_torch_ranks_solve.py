"""``solve_poisson(12, 12, 24, n_devices=p)`` on W = 2 and W = 4 gloo ranks
against the same solve in one process (W = 1): the JAX package's
``_SOLVE_WORKER`` case (``tests/test_multiprocess.py:84-120``: uniform f64
CG + GAMG, ``coarse_eq_limit=30``, rtol 1e-8, maxiter 100), the fused z
route and the (z, y) plain route.  Each: the same reason and counts, and
Linf to f32 rounding (1e-6 of itself).  The dots are all-reduced over the
ranks, so they sum in another order than one process's: the counts are
held equal at rtol 1e-8, where no run sits on the f32 floor.  Every rank
ends within 60 s or the case fails.
"""

import pytest
import torch

from torch_ranks import run_ranks, solve, solve_each

WORKER = dict(precision="f64", rtol=1e-8, maxiter=100, amg_params=dict(coarse_eq_limit=30))
# (W, p, options, route, mesh): W divides the mesh's z-rows
CASES = [
    (2, 4, WORKER, "(z, y) plain", [2, 2]),
    (4, 8, WORKER, "(z, y) plain", [4, 2]),
    (2, 4, dict(rtol=1e-8), "fused z", [4, 1]),
    (4, 4, dict(rtol=1e-8), "fused z", [4, 1]),
    (2, 4, dict(rtol=1e-8, layout="plain"), "(z, y) plain", [2, 2]),
    (4, 8, dict(rtol=1e-8, layout="plain"), "(z, y) plain", [4, 2]),
]


@pytest.mark.parametrize("world, p, kw, route, mesh", CASES,
                         ids=["f64-W2", "f64-W4", "fused-W2", "fused-W4", "plain-W2", "plain-W4"])
def test_solve_on_ranks_is_the_one_process_solve(tmp_path, world, p, kw, route, mesh):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = solve(n_devices=p, **{k: dict(v) if isinstance(v, dict) else v for k, v in kw.items()})
    finally:
        torch.set_num_threads(prev)
    got = run_ranks("torch_ranks:solve", world, tmp_path, n_devices=p, **kw)
    assert (one["route"], one["mesh"], one["ranks"]) == (route, mesh, 1)
    for r in got:
        assert (r["route"], r["mesh"], r["ranks"]) == (route, mesh, world)
        assert (r["reason"], r["iters"], r["outer"]) == (one["reason"], one["iters"], one["outer"])
        assert abs(r["linf"] - one["linf"]) <= 1e-6 * one["linf"]
        assert r["launches"] == 0        # CPU tensors: the twins
    assert len({(r["linf"], r["resnorm"]) for r in got}) == 1   # every rank reports the reduced values


KSPS = ["gmres", "fgmres", "bcgs", "minres", "pipecg", "chebyshev"]


def test_every_ksp_type_on_two_ranks_is_the_one_process_solve(tmp_path):
    """Each -ksp_type's global reductions (its dots, GMRES's CGS2 products,
    Chebyshev's global-index start vector) over 2 ranks, uniform f64 on
    the (z, y) route: the one-process solve's reason and count, Linf to
    1e-6 of itself."""
    # Chebyshev to 1e-4: with its estimated bounds it takes 19 iterations
    # there and 993 to 1e-8, each a round of plane exchanges between ranks
    cases = [dict(n_devices=4, precision="f64", rtol=1e-4 if k == "chebyshev" else 1e-8, ksp=k, n=(8, 8, 16))
             for k in KSPS]
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = solve_each([dict(c) for c in cases])
    finally:
        torch.set_num_threads(prev)
    got = run_ranks("torch_ranks:solve_each", 2, tmp_path, timeout=60, cases=cases)
    for k, w, g0, g1 in zip(KSPS, one, *got):
        assert w["reason"] > 0, k
        for g in (g0, g1):
            assert (g["reason"], g["iters"]) == (w["reason"], w["iters"]), k
            assert abs(g["linf"] - w["linf"]) <= 1e-6 * w["linf"], k

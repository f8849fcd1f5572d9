"""The split solve's routes in one process (W = 1) against the JAX
package's ``n_devices > 1`` runs on its virtual mesh: the lifted aij matrix
(the fused z route, as JAX's lifted route takes its fused route), the
default options at p = 2 (fused z), the W-cycle at p = 4, and p = 8 (nz / 8 = 2 planes, under
FACE: the (z, y) route on (4, 2)), a threshold schedule that filters level
0 (the (z, y) route with the filtered P smoother sharded: JAX's one-device
answer, not its fused route's), the refusals the JAX driver makes, in its
words, and ``-devices`` through both CLIs.  Tolerances as in
``test_torch_dist_solve.py``.
"""

import numpy as np
import pytest
import torch

from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.bench.driver import solve_poisson as j_solve_poisson
from tpusparse_torch.amg.hierarchy import AMGParams, threshold_schedule
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.config.options import load_options
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil_device
from test_torch_cli import _grid, _run
from test_torch_dist_solve import check_against_jax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("p, kw, route", [
    (4, dict(mat_type="aij"), "fused z"),
    (2, {}, "fused z"),
    (8, {}, "(z, y) plain"),
    (4, dict(mg_cycle="w"), "fused z"),
], ids=["aij-lifted-p4", "default-p2", "default-p8", "w-cycle-p4"])
def test_routes_match_jax(p, kw, route):
    got = check_against_jax(16, p, kw, {}, None, route)
    if "mat_type" in kw:
        assert "star DETECTED" in got.solver_view and got.setup_breakdown["star_lift"] >= 0


def test_filtered_level0_takes_the_plain_route_with_a_sharded_fop():
    """The (1, 1, 3) box's threshold schedule filters level 0: the (z, y)
    route smooths P with the filtered legs, sharded, and gives the JAX
    package's answer on its virtual mesh and on one device alike.  JAX's
    fused z route would smooth P with the full legs there (ROADMAP §3), a
    deliberate difference the port does not copy."""
    box = Grid3D(16, 16, 16, lx=1.0, ly=1.0, lz=3.0)
    sched = threshold_schedule(poisson_stencil_device(box, dtype=torch.float32, device="cpu")[0], 0.05)
    assert sched[0] == (1, 3, 3)
    kw = dict(extent=(1.0, 1.0, 3.0))
    got = check_against_jax(16, 4, kw, dict(threshold=0.05), None, "(z, y) plain")
    assert "(filtered P smoother)" in got.solver_view
    one = j_solve_poisson(16, rtol=1e-6, amg_params=JAMGParams(threshold=0.05), **kw)
    assert (got.reason, got.outer_iters) == (one.reason, one.outer_iters) and abs(got.iters - one.iters) <= 1
    assert abs(got.linf_error - one.linf_error) < 1e-6 + 1e-3 * one.linf_error


# the JAX driver's refusals with n_devices > 1, and their words
REFUSED = [
    (dict(pc="sor"), "pc_type='sor' is single-device"),
    (dict(pc="bjacobi"), "pc_type='bjacobi' is single-device"),
    (dict(mat_type="aij", structure_detect=False), "requires structure_detect"),
    (dict(mat_type="aij", pc="jacobi"), "did not prove star-structured"),
    (dict(mat_type="aij", aggregation="greedy", assembly="host"), "did not prove star-structured"),
]


@pytest.mark.parametrize("kw, match", REFUSED, ids=lambda v: str(v) if isinstance(v, dict) else "")
def test_refusals_are_the_jax_driver_s(kw, match):
    with pytest.raises(NotImplementedError, match=match) as got:
        solve_poisson(8, n_devices=2, device="cpu", **kw)
    with pytest.raises(NotImplementedError) as want:
        j_solve_poisson(8, n_devices=2, warmup=False, **kw)
    assert str(got.value).startswith(str(want.value))   # and the ROADMAP item, where one ports it


def test_mesh_refusals():
    """A grid the (z, y) mesh does not divide raises JAX's message; ranks
    must divide pz (one process: W = 1 always does); cg_fusion is
    single-device."""
    with pytest.raises(ValueError, match=r"grid \(nz=18, ny=9\) not divisible by mesh \(z=2, y=2\)"):
        solve_poisson(8, 9, 18, n_devices=4, device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        solve_poisson(12, n_devices=4, device="cpu", cg_fusion=True)


def test_devices_options_through_both_clis():
    """``-devices 4 -layout plain -pc_type jacobi`` at 16^3 through both
    CLIs (the JAX CLI runs its GSPMD route on 4 virtual devices): the same
    outcome, inner within 1, and the options the JAX driver refuses refused
    by the port's options database, in its words."""
    from tpusparse.__main__ import main as j_main
    from tpusparse_torch.__main__ import main

    argv = [*_grid(16), "-devices", "4", "-layout", "plain", "-pc_type", "jacobi", "-ksp_rtol", "1e-6",
            "-ksp_converged_reason"]
    _, want = _run(j_main, argv)
    text, got = _run(main, [*argv, "-device", "cpu"])
    assert (got["reason"], got["outer_iters"]) == (want["reason"], want["outer_iters"])
    assert abs(got["iters"] - want["iters"]) <= 1
    assert got["linf_error"] == pytest.approx(want["linf_error"], abs=1e-6 + 1e-3 * want["linf_error"])
    assert got["mesh"] == [2, 2] and got["sharded_route"] == "(z, y) plain"
    with pytest.raises(NotImplementedError, match="single-device"):
        load_options(["-devices", "2", "-pc_type", "sor"])

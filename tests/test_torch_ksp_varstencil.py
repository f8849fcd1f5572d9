"""``KSP`` on a 27-point fine operator (``VarStencil27``) under GAMG: HPCG's
operator (``grid/hpcg.py``) and a diffusion operator (``grid/diffusion.py``)
through ``set_operators`` and ``setup``, on the CPU.

The route is the plain cycle over ``gamg_setup``'s probed hierarchy
(``solve_diffusion`` runs through it), so a ``KSP`` solve equals
``gamg_setup`` with ``cg_refined`` (mixed precision) or ``cg`` (uniform)
run by hand.  The
residuals are read by the benchmark's plain float64 reference of HPCG's
operator (``benchmark/reference/hpcg27.py``).  At 48^3 the default 25
power steps underestimate rho(D^-1 A) and the solve stalls; the
configuration's ``rho_iters`` covers the top of the spectrum.
"""

import functools
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from tpusparse_torch import KSP, Grid3D
from tpusparse_torch.amg.hierarchy import AMGParams, gamg_setup, vcycle
from tpusparse_torch.bench.driver import solve_diffusion
from tpusparse_torch.grid.diffusion import default_kappa, diffusion_stencil
from tpusparse_torch.grid.hpcg import hpcg_stencil
from tpusparse_torch.solve.cg import cg
from tpusparse_torch.solve.refine import cg_refined

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark/configs/hpcg432_stencil27.json").read_text())
TOL = dict(rtol=1e-8, atol=1e-12)
DTYPES = {"mixed": torch.float64, "f64": torch.float64, "f32": torch.float32}


def _reference():
    """The benchmark's plain reference class, loaded from its file."""
    path = ROOT / "benchmark/reference/hpcg27.py"
    spec = importlib.util.spec_from_file_location("hpcg27_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.HPCG27


HPCG27 = _reference()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _params(n: int) -> AMGParams:
    """48^3 takes the configuration's GAMG options, 24^3 the defaults."""
    return AMGParams(**CONFIG["gamg"]) if n == 48 else AMGParams()


def _operators(grid, precision):
    """(outer operator, f32 twin or None) as the benchmark's family builds
    them."""
    op = hpcg_stencil(grid, DTYPES[precision], "cpu")
    return op, (hpcg_stencil(grid, torch.float32, "cpu") if precision == "mixed" else None)


@pytest.mark.parametrize("precision", ["mixed", "f32", "f64"])
@pytest.mark.parametrize("n", [24, 48])
def test_hpcg_solves_through_ksp_as_by_hand(n, precision):
    """HPCG's b = A 1 from x0 = 0: converged, within rtol by the plain
    reference (f32: within its own precision), and equal to the hierarchy
    and the solver run by hand."""
    grid = Grid3D(n, n, n)
    op, op_lo = _operators(grid, precision)
    b = op.mv(torch.ones(grid.shape, dtype=op.dtype))
    ksp = KSP(precision=precision, amg_params=_params(n), **TOL).set_operators(op, op_lo, device="cpu")
    res = ksp.solve(b)
    assert res.reason in (2, 3)  # rtol or atol: no stall
    assert ksp._op_lo is (op_lo if precision == "mixed" else op)
    rnorm, bnorm = HPCG27(grid.shape).residual(res.x, b)
    assert rnorm <= (TOL["rtol"] if precision != "f32" else 1e-5) * bnorm

    hier = gamg_setup(op_lo if precision == "mixed" else op, _params(n))
    m = functools.partial(vcycle, hier)
    if precision == "mixed":
        want = cg_refined(op.mv, op_lo.mv, b, m_lo_mv=m, max_outer=12, inner_maxiter=200, divtol=1e5, **TOL)
    else:
        want = cg(op.mv, b, maxiter=10000, divtol=1e5, m_mv=m, **TOL)
    assert (res.iters, res.reason) == (want.iters, want.reason)
    assert float(torch.linalg.vector_norm(res.x - want.x)) <= 1e-12 * float(torch.linalg.vector_norm(want.x))


def test_a_diffusion_operator_solves_through_ksp_as_solve_diffusion():
    """The route belongs to the operator class: ``bench/driver.py::
    solve_diffusion``, which runs the diffusion family's VarStencil27
    (contrast 100, 18^3, negative definite) through ``KSP``, takes the
    iterations, sweeps, reason, residual and error of ``gamg_setup`` and
    ``cg_refined`` composed by hand."""
    grid = Grid3D(18, 18, 18)
    kappa = default_kappa(grid, contrast=100.0)
    op = diffusion_stencil(grid, kappa, dtype=np.float64, device="cpu")
    op_lo = diffusion_stencil(grid, kappa, dtype=np.float32, device="cpu")
    zc, yc, xc = np.meshgrid(grid.cell_centers("z"), grid.cell_centers("y"), grid.cell_centers("x"), indexing="ij")
    exact = torch.from_numpy(np.cos(2 * np.pi * xc) * np.cos(2 * np.pi * yc) * np.cos(2 * np.pi * zc) - 1.0)
    b = op.mv(exact)
    hier = gamg_setup(op_lo, AMGParams())
    want = cg_refined(op.mv, op_lo.mv, b, m_lo_mv=functools.partial(vcycle, hier), **TOL)
    rep = solve_diffusion(18, device="cpu", contrast=100.0, warmup=False, **TOL)
    assert want.reason > 0 and float(want.resnorm) <= TOL["rtol"] * float(torch.linalg.vector_norm(b))
    assert (rep.iters, rep.outer_iters, rep.reason, rep.resnorm) == (want.iters, want.outer_iters, want.reason,
                                                                     float(want.resnorm))
    assert rep.linf_error == (want.x - exact).abs().max().item()


@pytest.mark.parametrize("reuse", [True, False])
def test_reuse_preconditioner_across_set_operators(reuse):
    """On the same grid, a second pair of operators (2 A) keeps the
    hierarchy under ``reuse_preconditioner`` and rebuilds it without; both
    solve the new system."""
    grid = Grid3D(12, 12, 12)
    op, op_lo = _operators(grid, "mixed")
    ksp = KSP(reuse_preconditioner=reuse, **TOL).set_operators(op, op_lo, device="cpu").setup()
    hier = ksp._pc_state
    op2 = type(op)(coef=2.0 * op.coef)
    op2_lo = type(op_lo)(coef=2.0 * op_lo.coef)
    b = op.mv(torch.ones(grid.shape, dtype=torch.float64))
    res = ksp.set_operators(op2, op2_lo, device="cpu").solve(b)
    assert (ksp._pc_state is hier) is reuse
    assert ksp._op is op2 and ksp._op_lo is op2_lo
    assert res.reason in (2, 3)
    rnorm, bnorm = HPCG27(grid.shape).residual(2.0 * res.x, b)
    assert rnorm <= TOL["rtol"] * bnorm


def test_layout_padded_raises_and_plain_is_auto():
    """The fused kernels are the star's: ``layout="padded"`` is refused, and
    "plain" runs what "auto" runs."""
    grid = Grid3D(12, 12, 12)
    op, op_lo = _operators(grid, "mixed")
    with pytest.raises(ValueError, match="VarStencil27"):
        KSP(layout="padded", **TOL).set_operators(op, op_lo, device="cpu").setup()
    b = op.mv(torch.ones(grid.shape, dtype=torch.float64))
    auto, plain = (KSP(layout=layout, **TOL).set_operators(op, op_lo, device="cpu").solve(b)
                   for layout in ("auto", "plain"))
    assert torch.equal(auto.x, plain.x) and auto.iters == plain.iters


def test_without_a_twin_the_inner_operator_is_the_f32_cast():
    """``set_operators(op)`` alone under mixed precision: the inner operator
    is the float32 cast of the float64 one, and the solve equals the one
    given the twin built in float32 (HPCG's coefficients are exact in
    both)."""
    grid = Grid3D(12, 12, 12)
    op, op_lo = _operators(grid, "mixed")
    ksp = KSP(**TOL).set_operators(op, device="cpu")
    assert ksp._op_lo.dtype == torch.float32 and torch.equal(ksp._op_lo.coef, op_lo.coef)
    b = op.mv(torch.ones(grid.shape, dtype=torch.float64))
    twin = KSP(**TOL).set_operators(op, op_lo, device="cpu").solve(b)
    assert torch.equal(ksp.solve(b).x, twin.x)


def _random_start_rho(grid, steps: int = 2000) -> float:
    """rho(D^-1 A) of HPCG's operator by ``steps`` power steps from a
    seeded random start, on the plain reference's float64 apply (D = 26)."""
    ref = HPCG27(grid.shape)
    v = torch.randn(grid.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(2718))
    v /= torch.linalg.vector_norm(v)
    for _ in range(steps):
        w = ref.apply(v, 0, grid.nz) / 26.0
        v = w / torch.linalg.vector_norm(w)
    return float(torch.sum(v * ref.apply(v, 0, grid.nz) / 26.0))


@pytest.mark.parametrize("rho_iters,covers", [(CONFIG["gamg"]["rho_iters"], True), (25, False)])
def test_rho_iters_covers_the_top_of_the_spectrum_at_48(rho_iters, covers):
    """The level-0 estimate (rho_safety included) times ``cheby_hi``, the
    top of the Chebyshev smoother's range, against 2,000 power steps from
    a random start, which read close to 36/26 (the mode alternating along
    one axis): the configuration's steps cover it, the default 25 do not."""
    grid = Grid3D(48, 48, 48)
    params = AMGParams(**{**CONFIG["gamg"], "rho_iters": rho_iters})
    hier = gamg_setup(hpcg_stencil(grid, torch.float32, "cpu"), params)
    rho = _random_start_rho(grid)
    assert 1.3 < rho < 36 / 26
    assert (hier.levels[0].rho * params.cheby_hi >= rho) is covers

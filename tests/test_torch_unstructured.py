"""The general-matrix GAMG routes of ``tpusparse_torch/amg/unstructured.py``
against the JAX package's on the same numpy inputs, on the CPU: the
strength graph, the greedy aggregates (C++ engine and Python twin), the
engine's SpGEMM, the transfers, the host-route hierarchies level by level,
one V-cycle on a copy of JAX's hierarchy, the router, and solves through
``gamg_setup_unstructured``, ``solve_poisson``, ``KSP`` and ``-f``.

Solves under mixed precision are held to JAX's reason and outer count, the
inner count within 1 (f32 summation order) and Linf within 1e-6; uniform
f64 solves to JAX's counts.  f64 hierarchies agree to rtol 1e-12 in their
bands (the engine's Galerkin products sum in JAX's native engine's order)
and 1e-5 in rho; f32 rho carries the power iteration's f32 rounding (1e-4
on the 1-D chains), so f32 levels are compared by size and pattern."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.amg.hierarchy import vcycle as j_vcycle
from tpusparse.amg.unstructured import FactoredTransfer as JFactoredTransfer
from tpusparse.amg.unstructured import _greedy_aggregate_py as j_greedy_py
from tpusparse.amg.unstructured import gamg_setup_unstructured as j_setup
from tpusparse.amg.unstructured import greedy_aggregate as j_greedy
from tpusparse.amg.unstructured import strength_graph as j_strength_graph
from tpusparse.amg.unstructured import tentative_prolongator as j_tentative
from tpusparse.bench.driver import solve_from_file as j_solve_from_file
from tpusparse.bench.driver import solve_poisson as j_solve_poisson
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import assemble_poisson as j_assemble_poisson
from tpusparse.ksp import KSP as JKSP
from tpusparse.solve.refine import cg_refined as j_cg_refined
from tpusparse.sparse.csr import HostCSR as JHostCSR
from tpusparse_torch import native
from tpusparse_torch.amg.hierarchy import AMGParams, hierarchy_summary, vcycle
from tpusparse_torch.amg.unstructured import (
    GREEDY_ROW_LIMIT,
    ELLTransfer,
    FactoredTransfer,
    _greedy_aggregate_py,
    choose_route,
    gamg_setup_unstructured,
    greedy_aggregate,
    member_table,
    strength_graph,
    tentative_prolongator,
)
from tpusparse_torch.bench.driver import solve_from_file, solve_poisson
from tpusparse_torch.interop import host_csr_from_numpy
from tpusparse_torch.ksp import KSP
from tpusparse_torch.solve.refine import cg_refined
from tpusparse_torch.sparse.dia import DIA, HybridDIA
from tpusparse_torch.sparse.ell import ELL
from tpusparse_torch.sparse.io import save_petsc_mat
from torch_parity import port_copy

TOL = dict(rtol=1e-8, atol=1e-12)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(a):
    j = JHostCSR.from_scipy(sp.csr_matrix(a))
    return j, host_csr_from_numpy(j.indptr, j.indices, j.data, j.shape)


def _lap1d(n):
    return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n), format="csr")


def _band61(n=2000):
    """The SPD matrix of 61 diagonals (offsets -30..30): diagonal 10,
    off-diagonals -1/(1+|o|).  JAX's KSP solves it in 8 iterations with
    GAMG (the greedy route) and 14 with Jacobi at rtol 1e-8."""
    offs = list(range(-30, 31))
    return sp.diags(
        [np.full(n - abs(o), 10.0 if o == 0 else -1.0 / (1 + abs(o))) for o in offs], offs,
        shape=(n, n), format="csr",
    )


def _poisson(n):
    return j_assemble_poisson(JGrid3D(n, n, n))[0].to_scipy()


def _scattered(n=600, seed=0, width=4):
    """Symmetric and diagonally dominant, with random couplings: hundreds
    of distinct diagonals, so the levels are HybridDIA."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), width)
    cols = np.clip(rows + rng.integers(-300, 301, n * width), 0, n - 1)
    off = sp.csr_matrix((np.full(n * width, -0.2), (rows, cols)), shape=(n, n))
    off = off + off.T
    off.setdiag(0)
    off.eliminate_zeros()
    return (off + sp.diags(-np.asarray(off.sum(axis=1)).ravel() + 0.5)).tocsr()


# ---------------------------------------------------------------- graph passes

def test_strength_graph_matches_jax():
    a = np.array([[4.0, -0.1, -2.0], [-0.1, 4.0, 0.0], [-2.0, 0.0, 4.0]])
    ja, ta = _pair(a)
    for theta in (0.0, 0.2):
        np.testing.assert_array_equal(strength_graph(ta, theta), j_strength_graph(ja, theta))
    assert strength_graph(ta, 0.0).sum() == 4 and strength_graph(ta, 0.2).sum() == 2
    ja, ta = _pair(_scattered())
    np.testing.assert_array_equal(strength_graph(ta, 0.05), j_strength_graph(ja, 0.05))


@pytest.mark.parametrize("case", ["lap1d", "poisson8", "band61", "scattered", "threshold"])
def test_greedy_aggregates_engine_and_twin_equal_jax(case):
    a = {"lap1d": _lap1d(50), "poisson8": _poisson(8), "band61": _band61(600),
         "scattered": _scattered(), "threshold": _scattered(seed=1)}[case]
    theta = 0.08 if case == "threshold" else 0.0
    ja, ta = _pair(a)
    want = j_greedy(ja, theta)
    np.testing.assert_array_equal(greedy_aggregate(ta, theta), want)
    np.testing.assert_array_equal(_greedy_aggregate_py(ta, strength_graph(ta, theta)), want)
    np.testing.assert_array_equal(j_greedy_py(ja, j_strength_graph(ja, theta)), want)
    assert want.min() == 0 and np.all(np.bincount(want) > 0)


def test_tentative_prolongator_and_engine_products():
    agg = np.array([0, 0, 1, 1, 1, 2])
    assert abs(tentative_prolongator(agg) - j_tentative(agg)).max() == 0.0
    a = _scattered()
    _, ta = _pair(a)
    p = tentative_prolongator(greedy_aggregate(ta))
    ac = native.ptap(_pair(p)[1], ta).to_scipy()
    ref = (p.T @ a @ p).tocsr()
    assert abs(ac - ref).max() < 1e-13 * abs(ref).max()
    t = native.transpose(ta).to_scipy()
    assert abs(t - a.T).max() == 0.0
    c = native.spgemm(ta, ta).to_scipy()
    assert abs(c - a @ a).max() < 1e-13 * abs(a @ a).max()


def test_member_table_sums_in_a_fixed_order():
    agg = np.array([2, 0, 1, 0, 2, 2, 1])
    table = member_table(agg, 3)
    np.testing.assert_array_equal(table, [[1, 3, 7], [2, 6, 7], [0, 4, 5]])


# ---------------------------------------------------------------- transfers

@pytest.mark.parametrize("nsmooths", [0, 1, 2])
def test_factored_transfer_matches_jax_and_the_explicit_p(nsmooths):
    """prolong and restrict, f32, at 1e-6 of the result's max against JAX's
    FactoredTransfer, and against P = (I - omega D^-1 A)^k T in f64; a
    stack of columns is each column's transfer."""
    a = _band61(600)
    ja, ta = _pair(a)
    agg = greedy_aggregate(ta)
    n_c = int(agg.max()) + 1
    sizes = np.bincount(agg).astype(np.float64)
    w = (1.0 / np.sqrt(sizes[agg])).astype(np.float32)
    omega = np.float32(0.6)
    dinv = (1.0 / a.diagonal()).astype(np.float32)
    top = DIA.from_csr(ta, dtype=np.float32, device="cpu")
    from tpusparse.sparse.dia import DIA as JDIA

    jop = JDIA.from_csr(ja, dtype=np.float32)
    jt = JFactoredTransfer(agg=jnp.asarray(agg, jnp.int32), w=jnp.asarray(w), omega=jnp.asarray(omega),
                           n_coarse=n_c, nsmooths=nsmooths)
    tt = FactoredTransfer(agg=torch.tensor(agg), w=torch.tensor(w), omega=float(omega),
                          members=torch.tensor(member_table(agg, n_c)), n_coarse=n_c, nsmooths=nsmooths)
    p = tentative_prolongator(agg)
    for _ in range(nsmooths):
        p = p - float(omega) * sp.diags(1.0 / a.diagonal()) @ (a @ p)
    rng = np.random.default_rng(nsmooths)
    v = rng.standard_normal(600).astype(np.float32)
    e = rng.standard_normal(n_c).astype(np.float32)
    got_r = tt.restrict(top, torch.tensor(dinv), torch.tensor(v)).numpy()
    got_p = tt.prolong(top, torch.tensor(dinv), torch.tensor(e)).numpy()
    want_r = np.asarray(jt.restrict(jop, jnp.asarray(dinv), jnp.asarray(v)))
    want_p = np.asarray(jt.prolong(jop, jnp.asarray(dinv), jnp.asarray(e)))
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=1e-6 * np.abs(want_r).max())
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-6 * np.abs(want_p).max())
    np.testing.assert_allclose(got_r, p.T @ v, rtol=0, atol=1e-5 * np.abs(want_r).max())
    np.testing.assert_allclose(got_p, p @ e, rtol=0, atol=1e-5 * np.abs(want_p).max())
    stack = torch.tensor(np.stack([v, 2 * v]))
    assert torch.equal(tt.restrict(top, torch.tensor(dinv), stack)[1],
                       tt.restrict(top, torch.tensor(dinv), stack[1]))


# ---------------------------------------------------------------- hierarchies

def _levels_equal(jh, th, f64: bool):
    assert len(th.levels) == len(jh.levels)
    for jl, tl in zip(jh.levels, th.levels):
        assert type(tl.op).__name__ == type(jl.op).__name__
        assert tl.op.shape == tuple(jl.op.shape)
        assert type(tl.transfer).__name__ == type(jl.transfer).__name__
        jd = jl.op.dia if hasattr(jl.op, "rem") else jl.op
        td = tl.op.dia if isinstance(tl.op, HybridDIA) else tl.op
        if hasattr(jd, "offsets"):
            assert td.offsets == jd.offsets
        if f64:
            assert tl.rho == pytest.approx(float(jl.rho), rel=1e-5)
            if hasattr(jd, "bands"):
                np.testing.assert_allclose(td.bands.numpy(), np.asarray(jd.bands), rtol=1e-12,
                                           atol=1e-12 * np.abs(np.asarray(jd.bands)).max())
        else:
            assert tl.rho == pytest.approx(float(jl.rho), rel=1e-3)


@pytest.mark.parametrize(
    "case, params, kw",
    [
        ("lap1d", dict(coarse_eq_limit=25), {}),
        ("poisson12", {}, dict(aggregation="greedy")),
        ("poisson12", dict(nsmooths=0, aggressive_coarsening=0), dict(aggregation="greedy")),
        ("poisson12", dict(nsmooths=2), dict(aggregation="greedy")),
        ("band61", {}, {}),
        ("band61", dict(bjacobi_bs=8), {}),
        ("band61", {}, dict(device_format="ell", transfer_format="ell")),
        ("scattered", dict(coarse_solve="lu"), {}),
        ("poisson8", dict(bjacobi_bs=8), {}),
    ],
    ids=["lap1d", "greedy", "tentative", "nsmooths2", "band61", "bjacobi", "ell", "hybrid-lu", "geo-bjacobi"],
)
@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_host_hierarchy_matches_jax_level_by_level(case, params, kw, f64):
    a = {"lap1d": _lap1d(400), "poisson12": _poisson(12), "band61": _band61(),
         "scattered": _scattered(), "poisson8": _poisson(8)}[case]
    ja, ta = _pair(a)
    dt = None if f64 else np.float32
    jh = j_setup(ja, JAMGParams(**params), dtype=dt, **kw)
    tm = {}
    th = gamg_setup_unstructured(ta, AMGParams(**params), dtype=dt, device="cpu", timings=tm, **kw)
    _levels_equal(jh, th, f64)
    assert set(tm) == {"aggregate", "galerkin", "rho", "device_put"}
    if case == "scattered":
        assert isinstance(th.levels[0].op, HybridDIA) and th.levels[-1].coarse_inv is not None
    if kw.get("device_format") == "ell":
        assert isinstance(th.levels[0].op, ELL) and isinstance(th.levels[0].transfer, ELLTransfer)
    text = hierarchy_summary(th)
    assert f"operator {type(th.levels[0].op).__name__}" in text


@pytest.mark.parametrize("case", ["greedy", "hybrid", "ell", "bjacobi"])
def test_one_vcycle_on_a_copy_of_jax_hierarchy(case):
    """The port's V-cycle on JAX's hierarchy (f32), within 2e-5 of max|z|."""
    a = _scattered() if case == "hybrid" else _band61(1200)
    ja, _ = _pair(a)
    kw = dict(device_format="ell", transfer_format="ell") if case == "ell" else {}
    params = JAMGParams(bjacobi_bs=6) if case == "bjacobi" else JAMGParams()
    jh = j_setup(ja, params, dtype=np.float32, **kw)
    th = port_copy(jh)
    r = np.random.default_rng(0).standard_normal(a.shape[0]).astype(np.float32)
    want = np.asarray(j_vcycle(jh, jnp.asarray(r)))
    got = vcycle(th, torch.tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())
    got2 = vcycle(th, torch.tensor(np.stack([r, -r])))
    np.testing.assert_allclose(got2[1].numpy(), -want, rtol=0, atol=2e-5 * np.abs(want).max())


# ---------------------------------------------------------------- the router

@pytest.mark.parametrize(
    "kw, want",
    [
        (dict(aggregation="auto", geo_shape=(4, 4, 4)), "geometric"),
        (dict(aggregation="geometric", geo_shape=(4, 4, 4)), "geometric"),
        (dict(aggregation="auto", geo_shape=(4, 4, 4), bjacobi_bs=4), "host"),
        (dict(aggregation="auto", geo_shape=(4, 4, 4), transfer_format="ell"), "host"),
        (dict(aggregation="auto", geo_shape=(4, 4, 4), device_format="ell"), "host"),
        (dict(aggregation="auto", geo_shape=None), "host"),
        (dict(aggregation="greedy", geo_shape=None), "host"),
        (dict(aggregation="banded", geo_shape=None, n_diagonals=61), "banded"),
        (dict(aggregation="auto", geo_shape=None, n_rows=GREEDY_ROW_LIMIT), "host"),
        (dict(aggregation="auto", geo_shape=None, n_rows=GREEDY_ROW_LIMIT + 1, n_diagonals=61), "banded"),
        (dict(aggregation="auto", geo_shape=None, n_rows=GREEDY_ROW_LIMIT + 1, n_diagonals=193), "host"),
        (dict(aggregation="auto", geo_shape=None, n_rows=GREEDY_ROW_LIMIT + 1, n_diagonals=61, bjacobi_bs=4),
         "host"),
        (dict(aggregation="greedy", geo_shape=None, n_rows=GREEDY_ROW_LIMIT + 1), "host"),
        (dict(aggregation="auto", geo_shape=None, has_host=False, dia_fine=True), "banded"),
        (dict(aggregation="auto", geo_shape=(4, 4, 4), has_host=False, dia_fine=True), "geometric"),
    ],
)
def test_router_choices(kw, want):
    base = dict(n_rows=1000, has_host=True, has_fine_op=True, dia_fine=False)
    assert choose_route(**{**base, **kw}) == want


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(aggregation="geometric", geo_shape=None), "geometric"),
        (dict(aggregation="banded", geo_shape=None, bjacobi_bs=4), "block-Jacobi"),
        (dict(aggregation="banded", geo_shape=None, n_diagonals=200), "max_offsets"),
        (dict(aggregation="greedy", geo_shape=None, has_host=False, dia_fine=True), "no host CSR"),
        (dict(aggregation="auto", geo_shape=(4, 4, 4), bjacobi_bs=4, has_host=False, dia_fine=True),
         "no host CSR"),
        (dict(aggregation="nearest", geo_shape=None), "unknown aggregation"),
    ],
)
def test_router_refusals(kw, match):
    base = dict(n_rows=1000, has_host=True, has_fine_op=True, dia_fine=False)
    with pytest.raises(ValueError, match=match):
        choose_route(**{**base, **kw})


# ---------------------------------------------------------------- solves

def _same(got, want, inner=1, linf=1e-6):
    assert (got.outer_iters, got.reason) == (int(want.outer_iters), int(want.reason))
    assert abs(got.iters - int(want.iters)) <= inner, (got.iters, int(want.iters))
    if hasattr(got, "linf_error"):
        assert got.linf_error == pytest.approx(want.linf_error, abs=linf)


@pytest.mark.parametrize(
    "kw, params",
    [
        (dict(aggregation="greedy"), {}),
        (dict(aggregation="banded", structure_detect=False), {}),
        (dict(structure_detect=False), dict(bjacobi_bs=12)),
        (dict(aggregation="greedy"), dict(nsmooths=0)),
        (dict(aggregation="greedy"), dict(aggressive_coarsening=0)),
        (dict(aggregation="greedy", precision="f64"), dict(nsmooths=2)),
        (dict(aggregation="greedy", rtol=1e-9), dict(nsmooths=2)),
        (dict(aggregation="banded", structure_detect=False), dict(nsmooths=0)),
        (dict(aggregation="greedy", assembly="host", pc="gamg"), dict(coarse_solve="lu")),
    ],
    ids=["greedy", "banded", "bjacobi", "nsmooths0", "aggressive0", "nsmooths2-f64", "nsmooths2",
         "banded-tentative", "greedy-lu"],
)
def test_solve_poisson_aij_routes_match_jax(kw, params):
    """The 12^3 Poisson system on the aij routes item 9.2 brought.  (At
    rtol 1e-8 under mixed precision nsmooths 2 sits on a knife edge: JAX 26
    inner iterations, the port 32, the outer count equal; in f64 the counts
    are equal, so that case runs there and at rtol 1e-9.)"""
    kw = {**TOL, **kw}
    want = j_solve_poisson(12, mat_type="aij", amg_params=JAMGParams(**params), **kw)
    got = solve_poisson(12, mat_type="aij", amg_params=AMGParams(**params), device="cpu", view=True, **kw)
    _same(got, want, inner=0 if kw.get("precision") == "f64" else 1)
    assert "mat_type: aij (DIA/HybridDIA containers)" in got.solver_view
    assert "star_lift" not in (got.setup_breakdown or {})
    assert {"hierarchy_build", "rho", "galerkin"} <= set(got.setup_breakdown)


def test_solve_poisson_refuses_device_assembly_for_host_setups():
    for kw in (dict(aggregation="greedy"), dict(amg_params=AMGParams(bjacobi_bs=4))):
        with pytest.raises(ValueError, match="host CSR"):
            solve_poisson(6, mat_type="aij", assembly="device", device="cpu", **kw)
    with pytest.raises(ValueError, match="block-Jacobi"):
        solve_poisson(6, mat_type="aij", structure_detect=False, aggregation="banded",
                      amg_params=AMGParams(bjacobi_bs=4), assembly="host", device="cpu")
    with pytest.raises(ValueError, match="unknown aggregation"):
        solve_poisson(6, mat_type="aij", aggregation="nearest", device="cpu")


@pytest.mark.parametrize(
    "params, kw",
    [({}, {}), ({}, dict(device_format="ell")), ({}, dict(transfer_format="ell")),
     ({}, dict(device_format="dia", transfer_format="factored")), (dict(bjacobi_bs=10), {})],
    ids=["auto", "ell-levels", "ell-transfer", "dia-factored", "bjacobi"],
)
def test_setup_formats_solve_as_jax(params, kw):
    """The 1-D Laplacian (400) through gamg_setup_unstructured's container
    and transfer formats, solved by each package's cg_refined."""
    a = _lap1d(400) + sp.eye(400) * 1e-3
    ja, ta = _pair(a)
    x = np.random.default_rng(7).standard_normal(400)
    b = a @ x
    jh = j_setup(ja, JAMGParams(coarse_eq_limit=25, **params), dtype=np.float32, **kw)
    th = gamg_setup_unstructured(ta, AMGParams(coarse_eq_limit=25, **params), dtype=np.float32,
                                 device="cpu", **kw)
    a64 = torch.tensor(a.toarray())
    want = j_cg_refined(lambda v: jnp.asarray(a.toarray()) @ v, jh.levels[0].op.mv, jnp.asarray(b),
                        m_lo_mv=lambda r: j_vcycle(jh, r), **TOL)
    got = cg_refined(lambda v: a64 @ v, th.levels[0].op.mv, torch.tensor(b),
                     m_lo_mv=lambda r: vcycle(th, r), **TOL)
    _same(got, want)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-6 * np.abs(x).max())


@pytest.mark.parametrize("pc", ["gamg", "jacobi"])
def test_ksp_solves_the_61_diagonal_matrix_as_jax(pc):
    """GAMG (the greedy route, 8 iterations in JAX) and Jacobi (14, repair
    of the band cap: 61 bands reach K5's twin) on the host matrix, and
    mat_solve of two columns."""
    a = _band61()
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    want = JKSP(pc_type=pc, rtol=1e-8).set_operators(a).solve(jnp.asarray(b))
    ksp = KSP(pc_type=pc, rtol=1e-8).set_operators(a, device="cpu")
    got = ksp.solve(torch.tensor(b))
    _same(got, want, inner=0)
    assert (got.iters, got.outer_iters) == ({"gamg": 8, "jacobi": 14}[pc], 2)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-9)
    block = ksp.mat_solve(torch.tensor(np.stack([b, -2 * b])))
    assert block.iters.tolist() == [got.iters] * 2 and block.reason.tolist() == [2, 2]
    if pc == "gamg":
        assert isinstance(ksp._pc_state.levels[0].transfer, FactoredTransfer)


def test_ksp_greedy_with_block_jacobi_levels_and_banded_without_host():
    """-pc_bjacobi_bs with GAMG on a host matrix (the greedy route's level
    sub-PC), and a DIA operator with no host matrix (the banded route) on
    the wrap chain at n = 3000, against JAX's KSP."""
    a = _band61(1500)
    b = np.random.default_rng(1).standard_normal(1500)
    want = JKSP(rtol=1e-8, amg_params=JAMGParams(bjacobi_bs=6)).set_operators(a).solve(jnp.asarray(b))
    ksp = KSP(rtol=1e-8, amg_params=AMGParams(bjacobi_bs=6)).set_operators(a, device="cpu")
    _same(ksp.solve(torch.tensor(b)), want)
    assert ksp._pc_state.levels[0].bjac is not None

    from tpusparse.sparse.dia import DFDIA as JDFDIA
    from tpusparse.sparse.dia import DIA as JDIA
    from tpusparse_torch.sparse.csr import HostCSR
    from tpusparse_torch.sparse.dia import host_dia_operators

    n = 3000
    w = sp.diags([2.0, -1.0, -1.0, -1.0, -1.0], [0, 1, -1, n - 1, -(n - 1)], shape=(n, n)).tolil()
    w[0, :] = 0.0
    w[:, 0] = 0.0
    w[0, 0] = 2.0
    w = w.tocsr()
    x = np.random.default_rng(2).standard_normal(n)
    bw = w @ x
    jb = JDIA.from_csr(JHostCSR.from_scipy(w))
    jlo = JDIA(bands=jb.bands.astype(jnp.float32), offsets=jb.offsets, shape=jb.shape)
    jhi = JDFDIA.from_host_bands(np.asarray(jb.bands), jb.offsets, jb.shape, hi_dev=jlo.bands)
    want = JKSP(rtol=1e-8).set_operators(jhi, jlo).solve(jnp.asarray(bw))
    hi, lo = host_dia_operators(HostCSR.from_scipy(w), "mixed", device="cpu")
    ksp = KSP(rtol=1e-8).set_operators(hi, lo)
    got = ksp.solve(torch.tensor(bw))
    _same(got, want)
    assert type(ksp._pc_state.levels[0].transfer).__name__ == "SegTransfer"


def test_the_file_route_runs_the_greedy_setup(tmp_path):
    """-f on the 61-diagonal matrix: solve_from_file and the CLI against
    JAX's."""
    from tpusparse_torch.__main__ import main

    path = str(tmp_path / "band61.petsc")
    a = _band61(1500)
    save_petsc_mat(path, a)
    want = j_solve_from_file(path, **TOL)
    got = solve_from_file(path, device="cpu", view=True, **TOL)
    _same(got, want)
    assert "operator DIA" in got.solver_view
    assert main(["-f", path, "-ksp_rtol", "1e-8", "-pc_bjacobi_bs", "10", "-device", "cpu"]) == 0


def test_block_jacobi_levels_in_pcr_form_match_the_dense_blocks(monkeypatch):
    """Past BlockJacobi's dense cap x-line blocks (bs = nx) take the PCR
    form, whose rho(M^-1 A) the host route takes through its apply on the
    device (the JAX package's host estimate reads dense blocks): the same
    hierarchy and counts as the dense blocks, here with the cap lowered so
    that 12^3 crosses it."""
    from tpusparse_torch.solve.bjacobi import BlockJacobi, PCRLineJacobi

    kw = dict(mat_type="aij", structure_detect=False, amg_params=AMGParams(bjacobi_bs=12), device="cpu", **TOL)
    dense = solve_poisson(12, **kw)
    monkeypatch.setattr(BlockJacobi, "DENSE_ENTRY_CAP", 1000)
    a = _pair(_poisson(12))[1]
    hier = gamg_setup_unstructured(a, AMGParams(bjacobi_bs=12), dtype=np.float32, device="cpu")
    assert isinstance(hier.levels[0].bjac, PCRLineJacobi)
    pcr = solve_poisson(12, **kw)
    assert (pcr.iters, pcr.outer_iters, pcr.reason) == (dense.iters, dense.outer_iters, dense.reason)
    assert pcr.linf_error == pytest.approx(dense.linf_error, abs=1e-6)

"""The block-row executor of ``tpusparse_torch/dist/general.py`` against the
JAX package's ``tpusparse/dist/general.py`` on the CPU, JAX on its 8-device
virtual mesh (``tests/conftest.py``), the port in one process holding all p
blocks (W = 1) and, in one spawned case, on 2 gloo ranks.

``DistDIA.mv`` against JAX's for p in {1, 2, 4, 8} (f64 to rtol 1e-12, f32
to 1e-6), on the 8^3 Poisson matrix and on the multi-hop matrix of
``test_dist_dia_bands_span_multiple_shards`` (bands at +-150 on 512 rows),
and bit for bit the port's ``DIA.mv``; the refusals in JAX's words;
``DistHybridDIA``; the sharded CG + GAMG solve at 16^3 against JAX's
sharded solve (the same inner count, x to rtol 1e-8 in f64) and bit for bit
the port's unsharded solve; sharded GMRES on the nonsymmetric matrix of
``test_sharded_gmres_nonsymmetric``; K5h's twin on every rank's rows of
every split; and the plan functions without a process group: the window
exchange, the member tables and the geometric partial planes (34^3 over 4
ranks cuts a plane)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse.amg import AMGParams as JAMGParams
from tpusparse.amg import vcycle as j_vcycle
from tpusparse.amg.unstructured import gamg_setup_unstructured as j_setup
from tpusparse.dist.general import DistDIA as JDistDIA
from tpusparse.dist.general import DistHybridDIA as JDistHybridDIA
from tpusparse.dist.general import _shard_ell_rows as j_shard_ell_rows
from tpusparse.dist.general import make_row_mesh as j_make_row_mesh
from tpusparse.dist.general import shard_unstructured_hierarchy as j_shard_hierarchy
from tpusparse.dist.general import shard_vector as j_shard_vector
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import assemble_poisson as j_assemble_poisson
from tpusparse.solve import cg as j_cg
from tpusparse.solve.gmres import gmres as j_gmres
from tpusparse.sparse.csr import HostCSR as JHostCSR
from tpusparse.sparse.dia import DIA as JDIA
from tpusparse.sparse.dia import HybridDIA as JHybridDIA
from tpusparse_torch.amg.geo import GeoTransfer
from tpusparse_torch.amg.hierarchy import AMGParams, vcycle
from tpusparse_torch.amg.unstructured import FactoredTransfer, gamg_setup_unstructured, member_table
from tpusparse_torch.dist.general import (
    DistDIA,
    DistHybridDIA,
    RowFactoredTransfer,
    RowGeoTransfer,
    RowMesh,
    _shard_ell_rows,
    geo_rows,
    local_member_table,
    make_row_mesh,
    shard_unstructured_hierarchy,
    shard_vector,
    window_plan,
)
from tpusparse_torch.interop import host_csr_from_numpy
from tpusparse_torch.kernels.diaband import dia_mv_torch, dia_mv_window, dia_mv_window_torch
from tpusparse_torch.solve.cg import cg
from tpusparse_torch.solve.gmres import gmres
from tpusparse_torch.sparse.dia import DIA, HybridDIA
from torch_ranks import GENERAL_CASES, _band_matrix, _hybrid_matrix, general, run_ranks

P = [1, 2, 4, 8]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(m):
    j = JHostCSR.from_scipy(sp.csr_matrix(m))
    return j, host_csr_from_numpy(j.indptr, j.indices, j.data, j.shape)


def _poisson(n):
    return j_assemble_poisson(JGrid3D(n, n, n))


MATRICES = {"poisson8": lambda: _poisson(8)[0].to_scipy(), "band150": _band_matrix}


@pytest.mark.parametrize("dtype, rtol", [(np.float64, 1e-12), (np.float32, 1e-6)], ids=["f64", "f32"])
@pytest.mark.parametrize("matrix", list(MATRICES))
@pytest.mark.parametrize("p", P)
def test_dist_dia_matches_jax(p, matrix, dtype, rtol):
    m = MATRICES[matrix]().astype(dtype)
    ja, ta = _pair(m)
    jd, td = JDIA.from_csr(ja), DIA.from_csr(ta, device="cpu")
    x = np.random.default_rng(0).standard_normal(m.shape[0]).astype(dtype)
    jmesh, mesh = j_make_row_mesh(p), make_row_mesh(p, device="cpu")
    want = np.asarray(jax.jit(lambda a, v: a.mv(v))(JDistDIA.shard(jd, jmesh), j_shard_vector(jnp.asarray(x), jmesh)))
    dd = DistDIA.shard(td, mesh)
    assert dd.halo == JDistDIA.shard(jd, jmesh).halo
    got = dd.mv(shard_vector(torch.from_numpy(x), mesh)).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("matrix", list(MATRICES))
@pytest.mark.parametrize("p", P)
def test_dist_dia_is_the_plain_dia_bit_for_bit(p, matrix, dtype):
    """One process holds every block: the windows are empty and the apply
    is one K5h (here its twin), bit for bit ``DIA.mv``."""
    d = DIA.from_csr(_pair(MATRICES[matrix]())[1], device="cpu")
    d = DIA(bands=d.bands.to(dtype), offsets=d.offsets, shape=d.shape)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(d.n_rows)).to(dtype)
    dd = DistDIA.shard(d, make_row_mesh(p, device="cpu"))
    np.testing.assert_array_equal(dd.mv(x).numpy(), d.mv(x).numpy())
    np.testing.assert_array_equal(dd.diagonal().numpy(), d.diagonal().numpy())


def test_refusals_in_jax_words():
    d = DIA.from_csr(_pair(_poisson(8)[0].to_scipy())[1], device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        DistDIA.shard(d, make_row_mesh(3, device="cpu"))
    with pytest.raises(ValueError, match="square"):
        DistDIA.shard(DIA(bands=d.bands, offsets=d.offsets, shape=(512, 513)), make_row_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="not a banded operator"):
        DistDIA.shard(DIA(bands=d.bands[:1], offsets=(512,), shape=(512, 512)), make_row_mesh(2, device="cpu"))
    a = _pair(_poisson(8)[0].to_scipy())[1]
    mesh = make_row_mesh(2, device="cpu")
    ell = gamg_setup_unstructured(a, AMGParams(coarse_eq_limit=64), device_format="ell", device="cpu")
    with pytest.raises(ValueError, match="needs DIA level-0 operators"):
        shard_unstructured_hierarchy(ell, mesh)
    tr = gamg_setup_unstructured(a, AMGParams(coarse_eq_limit=64), transfer_format="ell", device="cpu")
    with pytest.raises(ValueError, match="transfer_format='factored' or the geometric transfer"):
        shard_unstructured_hierarchy(tr, mesh)
    with pytest.raises(ValueError, match="at least one block"):
        make_row_mesh(0, device="cpu")


@pytest.mark.parametrize("p", [2, 8])
def test_dist_hybrid_dia_matches_jax(p):
    """``test_dist_hybrid_dia_matches_host``'s matrix: the bands through
    the window exchange, the ELL remainder against the gathered x."""
    s = _hybrid_matrix()
    ja, ta = _pair(s)
    jh, th = JHybridDIA.from_csr(ja, max_bands=8), HybridDIA.from_csr(ta, max_bands=8, device="cpu")
    assert jh.rem is not None and th.rem is not None
    x = np.random.default_rng(6).standard_normal(s.shape[0])
    jmesh, mesh = j_make_row_mesh(p), make_row_mesh(p, device="cpu")
    rows = jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec("rows"))
    jdh = JDistHybridDIA(dia=JDistDIA.shard(jh.dia, jmesh), rem=j_shard_ell_rows(jh.rem, rows))
    want = np.asarray(jax.jit(lambda a, v: a.mv(v))(jdh, j_shard_vector(jnp.asarray(x), jmesh)))
    dh = DistHybridDIA(dia=DistDIA.shard(th.dia, mesh), rem=_shard_ell_rows(th.rem, mesh))
    got = dh.mv(shard_vector(torch.from_numpy(x), mesh)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, s @ x, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(got, th.mv(torch.from_numpy(x)).numpy())


@pytest.fixture(scope="module")
def poisson16():
    a, b, exact = _poisson(16)
    ja, ta = _pair(a.to_scipy())
    return ja, ta, b, exact


@pytest.mark.parametrize("min_shard_rows", [4096, 1])
@pytest.mark.parametrize("transfer_format", ["factored", "auto"])
def test_sharded_hierarchy_solve_matches_jax(poisson16, transfer_format, min_shard_rows):
    """CG + GAMG over the sharded hierarchy (JAX's
    ``test_sharded_unstructured_cg_gamg_iteration_parity`` and, with
    ``min_shard_rows=1``, ``test_all_levels_sharded_hierarchy_parity``):
    JAX's sharded inner count, x to rtol 1e-8, and bit for bit the port's
    unsharded solve."""
    ja, ta, b, exact = poisson16
    params = dict(coarse_eq_limit=64)
    jh = j_setup(ja, JAMGParams(**params), device_format="auto", transfer_format=transfer_format)
    jmesh = j_make_row_mesh(8)
    jhs = j_shard_hierarchy(jh, jmesh, min_shard_rows=min_shard_rows)
    want = jax.jit(lambda h, v: j_cg(h.levels[0].op.mv, v, rtol=1e-8, maxiter=300, m_mv=lambda r: j_vcycle(h, r)))(
        jhs, j_shard_vector(jnp.asarray(b), jmesh))

    th = gamg_setup_unstructured(ta, AMGParams(**params), device_format="auto", transfer_format=transfer_format,
                                 device="cpu")
    mesh = make_row_mesh(8, device="cpu")
    ths = shard_unstructured_hierarchy(th, mesh, min_shard_rows=min_shard_rows)
    kinds = [type(lev.op).__name__ for lev in ths.levels]
    assert kinds == [type(lev.op).__name__ for lev in jhs.levels]
    if min_shard_rows == 1:
        assert sum(k.startswith("Dist") for k in kinds) >= 2, kinds
    bt = torch.from_numpy(np.asarray(b))
    with mesh.reductions(bt.numel()):
        got = cg(ths.levels[0].op.mv, shard_vector(bt, mesh), rtol=1e-8, maxiter=300, m_mv=lambda r: vcycle(ths, r))
    one = cg(th.levels[0].op.mv, bt, rtol=1e-8, maxiter=300, m_mv=lambda r: vcycle(th, r))
    assert got.reason == int(want.reason) > 0 and got.iters == int(want.iters)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-8, atol=1e-10)
    assert np.abs(got.x.numpy() - exact).max() < 5e-2
    assert (one.iters, one.reason) == (got.iters, got.reason)
    np.testing.assert_array_equal(got.x.numpy(), one.x.numpy())


def _nonsymmetric():
    n1 = 8
    lap1 = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n1, n1))
    up1 = sp.diags([-1.0, 1.0], [-1, 0], shape=(n1, n1)) * 0.4
    eye = sp.identity(n1)
    a1 = lap1 + up1
    return (sp.kron(sp.kron(a1, eye), eye) + sp.kron(sp.kron(eye, a1), eye)
            + sp.kron(sp.kron(eye, eye), a1)).tocsr()


def test_sharded_gmres_nonsymmetric():
    """GMRES over the sharded nonsymmetric DistDIA: JAX's sharded count,
    the true solution to JAX's 1e-6."""
    s = _nonsymmetric()
    ja, ta = _pair(s)
    x_true = np.random.default_rng(2).standard_normal(s.shape[0])
    b = s @ x_true
    jmesh = j_make_row_mesh(8)
    want = jax.jit(lambda op, v: j_gmres(op.mv, v, rtol=1e-10, maxiter=1000, restart=30))(
        JDistDIA.shard(JDIA.from_csr(ja), jmesh), j_shard_vector(jnp.asarray(b), jmesh))
    mesh = make_row_mesh(8, device="cpu")
    dd = DistDIA.shard(DIA.from_csr(ta, device="cpu"), mesh)
    with mesh.reductions(s.shape[0]):
        got = gmres(dd.mv, shard_vector(torch.from_numpy(b), mesh), rtol=1e-10, maxiter=1000, restart=30)
    assert got.converged() and got.iters == int(want.iters)
    np.testing.assert_allclose(got.x.numpy(), x_true, rtol=1e-6, atol=1e-7)


SPLITS = [1, 2, 3, 4, 5, 8]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("offsets", [(0,), (-1, 0, 1), (-150, -1, 0, 1, 150), (-37, -9, 2, 41, 119)],
                         ids=["diag", "tri", "band150", "skew"])
def test_window_twin_is_k5_twin_on_every_rank(offsets, dtype):
    """``dia_mv_window`` (its twin on CPU tensors) on each rank's rows of
    every split, the windows cut by ``window_plan``, is ``dia_mv_torch`` of
    the whole vector, bit for bit."""
    n = 360
    rng = np.random.default_rng(3)
    bands = torch.from_numpy(rng.standard_normal((len(offsets), n))).to(dtype)
    x = torch.from_numpy(rng.standard_normal(n)).to(dtype)
    want = dia_mv_torch(bands, x, offsets)
    halo = max(8, -(-max(abs(o) for o in offsets) // 8) * 8)
    apply = dia_mv_window if dtype == torch.float32 else dia_mv_window_torch
    for world in SPLITS:
        nl = n // world
        for rank in range(world):
            plan = window_plan(n, world, rank, halo)
            r0 = rank * nl
            xlo, xhi = x[r0 - plan.hl:r0].contiguous(), x[r0 + nl:r0 + nl + plan.hh].contiguous()
            got = apply(bands[:, r0:r0 + nl].contiguous(), x[r0:r0 + nl].contiguous(), offsets, xlo, xhi, r0, n)
            assert torch.equal(got, want[r0:r0 + nl]), (world, rank)


def test_window_refuses_short_windows():
    bands, x = torch.ones(3, 10), torch.ones(10)
    with pytest.raises(ValueError, match="reach"):
        dia_mv_window(bands, x, (-4, 0, 4), torch.ones(3), torch.ones(4), 8, 28)
    with pytest.raises(ValueError, match="not inside"):
        dia_mv_window(bands, x, (-4, 0, 4), torch.ones(9), torch.ones(4), 8, 28)
    with pytest.raises(TypeError, match="float32"):
        dia_mv_window(bands.double(), x.double(), (-4, 0, 4), torch.ones(4), torch.ones(4), 8, 28)


@pytest.mark.parametrize("halo", [8, 64, 152, 400])
@pytest.mark.parametrize("world", [2, 3, 4, 8])
def test_window_plan_delivers_each_window(world, halo):
    """Without a process group: every rank's received pieces, put together,
    are its windows of the global vector, and what each rank sends a peer
    is what that peer receives from it, piece for piece."""
    n = 480
    x = np.arange(n)
    plans = [window_plan(n, world, r, halo) for r in range(world)]
    nl = n // world
    for r, plan in enumerate(plans):
        r0 = r * nl
        assert plan.hl == min(halo, r0) and plan.hh == min(halo, n - r0 - nl)
        for side, want in (("lo", x[r0 - plan.hl:r0]), ("hi", x[r0 + nl:r0 + nl + plan.hh])):
            pieces = []
            for q, s, lo, hi in plan.recvs:
                if s != side:
                    continue
                sent = [(a, b) for peer, a, b in plans[q].sends if peer == r]
                assert len(sent) == 1 and sent[0][1] - sent[0][0] == hi - lo
                pieces.append(x[q * nl + sent[0][0]:q * nl + sent[0][1]])
                assert q != r and lo // nl == q == (hi - 1) // nl
            got = np.concatenate(pieces) if pieces else x[:0]
            np.testing.assert_array_equal(got, want)
        assert len({peer for peer, _, _ in plan.sends}) == len(plan.sends)


def _stub(n):
    """A fine operator whose apply is zero: the transfers' T and T^T alone."""
    class Zero:
        def mv(self, v):
            return torch.zeros_like(v)
    return Zero()


@pytest.mark.parametrize("world", [2, 3, 4])
def test_member_tables_sum_to_the_restriction(world):
    """The per-rank member tables of a greedy hierarchy's first transfer:
    the ranks' partial coarse sums add up to ``FactoredTransfer.restrict``
    (T^T), and the ranks' prolongations are its rows, bit for bit."""
    a = _pair(sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(600, 600), format="csr"))[1]
    h = gamg_setup_unstructured(a, AMGParams(coarse_eq_limit=25), transfer_format="factored", device="cpu")
    tr = h.levels[0].transfer
    assert isinstance(tr, FactoredTransfer)
    tr0 = FactoredTransfer(agg=tr.agg, w=tr.w, omega=0.0, members=tr.members, n_coarse=tr.n_coarse,
                           nsmooths=tr.nsmooths)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(600))
    e = torch.from_numpy(rng.standard_normal(tr.n_coarse))
    dinv = torch.ones(600, dtype=torch.float64)
    want_r, want_p = tr0.restrict(_stub(600), dinv, x), tr0.prolong(_stub(600), dinv, e)
    total, rows = torch.zeros_like(want_r), []
    for rank in range(world):
        mesh = RowMesh(p=world, device=torch.device("cpu"), world=world, rank=rank)
        rt = RowFactoredTransfer.build(tr0, mesh, coarse_rows=False)
        table, touched = local_member_table(tr.members, rank * 600 // world, 600 // world)
        assert torch.equal(rt.members, table) and torch.equal(rt.touched, touched)
        total += rt.restrict(_stub(600), mesh.local(dinv), mesh.local(x))
        rows.append(rt.prolong(_stub(600), mesh.local(dinv), e))
    np.testing.assert_allclose(total.numpy(), want_r.numpy(), rtol=1e-14, atol=1e-14)
    np.testing.assert_array_equal(torch.cat(rows).numpy(), want_p.numpy())
    # one rank's table is the global one (the sentinel n stays n)
    table, touched = local_member_table(tr.members, 0, 600)
    assert torch.equal(table, tr.members) and torch.equal(touched, torch.arange(tr.n_coarse))
    np.testing.assert_array_equal(member_table(tr.agg.numpy(), tr.n_coarse), tr.members.numpy())


@pytest.mark.parametrize("shape, world", [((34, 34, 34), 4), ((12, 12, 12), 8), ((6, 6, 6), 4), ((9, 7, 5), 3)])
def test_geo_rows_cut_planes(shape, world):
    """The geometric transfer on a rank's rows that cut a plane (34^3 over
    4 ranks: 8.5 planes a rank): the ranks' partial T^T sums add up to
    ``GeoTransfer.restrict``, their T rows to its prolongation, bit for
    bit."""
    n = int(np.prod(shape))
    bs = (3, 3, 3)
    tr = GeoTransfer.build(0.0, shape, bs, torch.float64, device="cpu")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(n))
    e = torch.from_numpy(rng.standard_normal(int(np.prod(tr.coarse_shape))))
    dinv = torch.ones(n, dtype=torch.float64)
    want_r, want_p = tr.restrict(_stub(n), dinv, x), tr.prolong(_stub(n), dinv, e)
    total, rows, cut = torch.zeros_like(want_r), [], False
    q = shape[1] * shape[2]
    for rank in range(world):
        g = geo_rows(shape, bs, world, rank)
        nl = n // world
        assert g.offset == rank * nl - g.z0 * q and g.z0 * q <= rank * nl and (rank + 1) * nl <= g.z1 * q
        assert g.c0 == g.z0 // 3 and g.c1 == (g.z1 - 1) // 3 + 1
        cut |= g.offset != 0 or nl % q != 0
        mesh = RowMesh(p=world, device=torch.device("cpu"), world=world, rank=rank)
        rt = RowGeoTransfer.build(tr, mesh, coarse_rows=False)
        total += rt.restrict(_stub(n), mesh.local(dinv), mesh.local(x))
        rows.append(rt.prolong(_stub(n), mesh.local(dinv), e))
    assert cut == (shape != (9, 7, 5))
    np.testing.assert_allclose(total.numpy(), want_r.numpy(), rtol=1e-13, atol=1e-13)
    np.testing.assert_array_equal(torch.cat(rows).numpy(), want_p.numpy())


def test_general_on_two_ranks_is_the_one_process_run(tmp_path):
    """On W = 2 gloo ranks against the same in one process, every case of
    ``GENERAL_CASES``: the 16^3 sharded solve (geometric transfers, every
    divisible level sharded), the (9, 8, 8) one, whose rank rows cut a
    plane (4.5 planes a rank), the 14^3 one with a level kept whole between
    two sharded ones, and the 12^3 one with block-Jacobi levels (blocks
    across the ranks' rows) and the dense coarse inverse on sharded levels;
    then the multi-hop apply (bands at +-150 over 256 rows a rank) and the
    hybrid apply.  The same counts, x to rtol 1e-8, the applies bit for bit
    (the hybrid's remainder to 1e-14)."""
    one = general()
    got = run_ranks("torch_ranks:general", 2, tmp_path, timeout=60)
    assert [s["levels"] for s in one["solves"]] == [
        ["DistDIA/RowGeoTransfer"] * 2 + ["DistDIA/NoneType"],
        ["DistDIA/RowGeoTransfer", "DIA/NoneType"],
        ["DistDIA/RowGeoTransfer", "DIA/CoarseRowsTransfer", "DistDIA/NoneType"],
        ["DistDIA/RowGeoTransfer/bjac", "DistDIA/NoneType/bjac/lu"],
    ]
    assert one["halo"] == 152
    for i, want in enumerate(one["solves"]):
        for g in got:
            s = g["solves"][i]
            assert (s["iters"], s["reason"], s["levels"]) == (want["iters"], want["reason"], want["levels"])
        assert want["reason"] > 0
        x = np.concatenate([g["solves"][i]["x"] for g in got])
        np.testing.assert_allclose(x, want["x"], rtol=1e-8, atol=1e-10 * np.abs(want["x"]).max())
        n = len(want["x"])
        assert [g["solves"][i]["rows"] for g in got] == [[0, n // 2], [n // 2, n]]
    np.testing.assert_array_equal(np.concatenate([g["y"] for g in got]), one["y"])
    np.testing.assert_allclose(np.concatenate([g["yh"] for g in got]), one["yh"], rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("case", range(len(GENERAL_CASES)), ids=["all", "cut", "whole-between", "bjac-lu"])
def test_sharded_levels_of_every_kind_match_jax(case):
    """Each of ``GENERAL_CASES`` in one process over 4 blocks against JAX's
    sharded solve of its own hierarchy on 4 of its 8 virtual devices:
    JAX's count and x to rtol 1e-8, and bit for bit the port's unsharded
    solve."""
    (nz, ny, nx), params = GENERAL_CASES[case]
    a, b, _ = j_assemble_poisson(JGrid3D(nx, ny, nz))
    ja, ta = _pair(a.to_scipy())
    jh = j_setup(ja, JAMGParams(**params))
    jmesh = j_make_row_mesh(4)
    jhs = j_shard_hierarchy(jh, jmesh, min_shard_rows=1)
    want = jax.jit(lambda h, v: j_cg(h.levels[0].op.mv, v, rtol=1e-8, maxiter=300, m_mv=lambda r: j_vcycle(h, r)))(
        jhs, j_shard_vector(jnp.asarray(b), jmesh))
    th = gamg_setup_unstructured(ta, AMGParams(**params), device="cpu")
    mesh = make_row_mesh(4, device="cpu")
    ths = shard_unstructured_hierarchy(th, mesh, min_shard_rows=1)
    assert [type(lev.op).__name__ for lev in ths.levels] == [type(lev.op).__name__ for lev in jhs.levels]
    bt = torch.from_numpy(np.asarray(b))
    with mesh.reductions(bt.numel()):
        got = cg(ths.levels[0].op.mv, shard_vector(bt, mesh), rtol=1e-8, maxiter=300, m_mv=lambda r: vcycle(ths, r))
    one = cg(th.levels[0].op.mv, bt, rtol=1e-8, maxiter=300, m_mv=lambda r: vcycle(th, r))
    assert got.reason == int(want.reason) > 0 and got.iters == int(want.iters)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-8, atol=1e-10)
    assert (one.iters, one.reason) == (got.iters, got.reason)
    np.testing.assert_array_equal(got.x.numpy(), one.x.numpy())


def test_bench_general_runs_in_one_process(capsys):
    """``python -m tpusparse_torch.bench.general``: CG + GAMG over the row
    mesh, rank 0's two lines."""
    from tpusparse_torch.bench import general as bench_general

    assert bench_general.main(["12", "--blocks", "2", "--min-shard-rows", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("12^3 on a row mesh of 2 blocks over 1 rank(s) (cpu): levels ['DistDIA 1728',")
    assert "iterations, reason 2, Linf" in out[1]

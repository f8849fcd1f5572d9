"""The structure-blind aij route in uniform precision, the standalone
block Jacobi from the host CSR, the assembly rules and ``KSP`` on host
matrices, against the JAX package on the CPU: JAX's outer count and
reason, inner within 1 (f32 summation order), Linf within 1e-6 (uniform
f32: 2e-5, tests/test_torch_plain.py's rule); what items 9.2 and 10
and queue 12 refused before they were ported runs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse import KSP as JKSP
from tpusparse.__main__ import main as j_main
from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.bench.driver import solve_poisson as j_solve_poisson
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import assemble_poisson as j_assemble_poisson
from tpusparse.grid.poisson import poisson_dia_device as j_poisson_dia_device
from tpusparse.solve.bjacobi import BlockJacobi as JBlockJacobi
from tpusparse_torch import KSP
from tpusparse_torch.__main__ import main
from tpusparse_torch.amg.hierarchy import AMGParams
from tpusparse_torch.amg.unstructured import gamg_setup_unstructured
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import assemble_poisson, poisson_dia_device
from tpusparse_torch.solve.bjacobi import BlockJacobi
from tpusparse_torch.sparse.dia import DIA

N = 16
BLIND = dict(atol=1e-12, mat_type="aij", structure_detect=False, warmup=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same(got, want, linf=1e-6, inner=1):
    assert (got.outer_iters, got.reason) == (int(want.outer_iters), int(want.reason))
    assert abs(got.iters - int(want.iters)) <= inner
    assert got.linf_error == pytest.approx(want.linf_error, abs=linf)


@pytest.mark.parametrize("precision, rtol", [("f64", 1e-8), ("f32", 1e-6)])
@pytest.mark.parametrize("pc", ["gamg", "jacobi", "none"])
def test_uniform_structure_blind_matches_jax(precision, rtol, pc):
    """One DIA in the solve's dtype (host assembly), a geometric hierarchy
    in that dtype for GAMG."""
    kw = dict(BLIND, rtol=rtol, precision=precision, pc=pc, view=True)
    want = j_solve_poisson(N, **kw)
    got = solve_poisson(N, device="cpu", **kw)
    _same(got, want, linf=2e-5 if precision == "f32" else 1e-6)
    assert got.reason > 0 and "mat_type: aij" in got.solver_view


def test_uniform_f64_hierarchy_is_f64_and_matches_jax_levels():
    """The f64 geometric levels: every level's operator and transfer in
    f64, its rho to 1e-12 of JAX's f64 rho (not f32 rounding)."""
    a, _, _ = assemble_poisson(Grid3D(N, N, N))
    op = DIA.from_csr(a, device="cpu")
    hier = gamg_setup_unstructured(None, AMGParams(), fine_op=op)
    ja, _, _ = j_assemble_poisson(JGrid3D(N, N, N))
    from tpusparse.amg.unstructured import gamg_setup_unstructured as j_setup

    jhier = j_setup(ja, JAMGParams())
    assert hier.n_levels == jhier.n_levels
    for lev, jlev in zip(hier.levels, jhier.levels):
        assert lev.op.dtype == lev.dinv.dtype == torch.float64
        assert lev.rho == pytest.approx(float(jlev.rho), rel=1e-12)
        want = np.asarray(jlev.op.bands)
        np.testing.assert_allclose(lev.op.bands.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
        if lev.transfer is not None:
            assert lev.transfer.w.dtype == torch.float64
            np.testing.assert_allclose(lev.transfer.w.numpy(), np.asarray(jlev.transfer.w), rtol=1e-15)
    with pytest.raises(ValueError, match="dtype"):
        gamg_setup_unstructured(a, AMGParams(), dtype=np.float32, fine_op=op)
    built = gamg_setup_unstructured(a, AMGParams(), dtype=np.float32, device="cpu")
    assert built.levels[0].op.dtype == torch.float32


@pytest.mark.parametrize("bs", [4, N])
@pytest.mark.parametrize("precision, rtol", [("mixed", 1e-8), ("f64", 1e-8)])
def test_standalone_block_jacobi_matches_jax(bs, precision, rtol):
    """pc="bjacobi" from the host CSR (assembly="host"): bs = 4 and the
    x-lines, bs = nx, in dense blocks."""
    kw = dict(BLIND, rtol=rtol, precision=precision, pc="bjacobi", assembly="host")
    want = j_solve_poisson(N, amg_params=JAMGParams(bjacobi_bs=bs), **kw)
    got = solve_poisson(N, device="cpu", amg_params=AMGParams(bjacobi_bs=bs), **kw)
    _same(got, want, inner=0 if precision == "f64" else 1)


@pytest.mark.parametrize("precision", ["mixed", "f32"])
def test_standalone_block_jacobi_pcr_form_matches_jax(precision, monkeypatch):
    """Past the dense cap the x-line blocks take the PCR form in both
    packages (the cap lowered so that 16^3 crosses it)."""
    monkeypatch.setattr(BlockJacobi, "DENSE_ENTRY_CAP", 1024)
    monkeypatch.setattr(JBlockJacobi, "DENSE_ENTRY_CAP", 1024)
    kw = dict(BLIND, rtol=1e-8 if precision == "mixed" else 1e-6, precision=precision, pc="bjacobi",
              assembly="host")
    want = j_solve_poisson(N, amg_params=JAMGParams(bjacobi_bs=N), **kw)
    got = solve_poisson(N, device="cpu", amg_params=AMGParams(bjacobi_bs=N), **kw)
    _same(got, want, linf=2e-5 if precision == "f32" else 1e-6)


def test_assembly_rules_match_jax():
    """assembly: "host" under mixed precision solves as the device
    assembly does; "device" refuses uniform precision and bjacobi_bs;
    pc="bjacobi" needs the host CSR (JAX's ValueError without it)."""
    kw = dict(BLIND, rtol=1e-8)
    dev = solve_poisson(12, device="cpu", **kw)
    host = solve_poisson(12, device="cpu", assembly="host", **kw)
    assert (host.iters, host.outer_iters, host.reason) == (dev.iters, dev.outer_iters, dev.reason)
    assert host.linf_error == pytest.approx(dev.linf_error, rel=1e-9)
    for bad in (dict(precision="f64", assembly="device"),
                dict(assembly="device", amg_params=AMGParams(bjacobi_bs=4)),
                dict(assembly="tiled"), dict(pc="bjacobi")):
        with pytest.raises(ValueError):
            solve_poisson(8, device="cpu", **{**kw, **bad})
    with pytest.raises(ValueError, match="host CSR"):
        j_solve_poisson(8, pc="bjacobi", **kw)


def test_uniform_aij_through_the_cli_matches_jax(capsys):
    """-mat_type aij -mat_structure_detect 0 -precision f64 through both
    CLIs."""
    import json

    args = ["-da_grid_x", "12", "-da_grid_y", "12", "-da_grid_z", "12", "-mat_type", "aij",
            "-mat_structure_detect", "0", "-precision", "f64", "-ksp_rtol", "1e-8", "-ksp_atol", "1e-12"]
    sides = []
    for fn, extra in ((main, ["-device", "cpu"]), (j_main, [])):
        assert fn([*args, *extra]) == 0
        out = capsys.readouterr().out
        sides.append(json.loads(next(s for s in out.splitlines() if s.startswith("JSON: "))[6:]))
    got, want = sides
    assert (got["iters"], got["reason"]) == (want["iters"], want["reason"])
    assert got["linf_error"] == pytest.approx(want["linf_error"], abs=1e-6)


@pytest.mark.parametrize("precision, pc", [("mixed", "gamg"), ("f64", "gamg"), ("f32", "gamg"),
                                           ("mixed", "bjacobi"), ("f64", "jacobi")])
def test_ksp_on_a_host_csr_matches_jax(precision, pc):
    """KSP.set_operators on a HostCSR (the DIA family on the device, the
    host matrix kept for bjacobi, bs 4 here) against JAX's KSP."""
    rtol = 1e-6 if precision == "f32" else 1e-8
    a, b, exact = assemble_poisson(Grid3D(12, 12, 12))
    ja, jb, _ = j_assemble_poisson(JGrid3D(12, 12, 12))
    bs = 4 if pc == "bjacobi" else 0
    want = JKSP(rtol=rtol, precision=precision, pc_type=pc, amg_params=JAMGParams(bjacobi_bs=bs)).set_operators(ja)
    want = want.solve(jnp.asarray(jb, jnp.float32 if precision == "f32" else jnp.float64))
    ksp = KSP(rtol=rtol, precision=precision, pc_type=pc, amg_params=AMGParams(bjacobi_bs=bs))
    ksp.set_operators(a, device="cpu")
    got = ksp.solve(torch.tensor(b, dtype=torch.float32 if precision == "f32" else torch.float64))
    assert (got.outer_iters, got.reason) == (int(want.outer_iters), int(want.reason))
    assert abs(got.iters - int(want.iters)) <= (0 if precision == "f64" else 1)
    wx = np.asarray(want.x, np.float64)
    tol = 2e-5 if precision == "f32" else 1e-6
    assert np.abs(got.x.double().numpy() - wx).max() <= tol * np.abs(wx).max()
    assert got.x.dtype == (torch.float32 if precision == "f32" else torch.float64)


@pytest.mark.parametrize("precision", ["mixed", "f64"])
def test_ksp_mat_solve_on_a_dia_operator_matches_jax(precision):
    """mat_solve of three columns on the DIA family (the f32 levels on the
    batched K5's twin under mixed precision): per column, JAX's reason,
    iterations within 1, x within 1e-6; each column the single solve."""
    jhi, jlo, jb, _ = j_poisson_dia_device(JGrid3D(12, 12, 12))
    op_hi, op_lo, b, _ = poisson_dia_device(Grid3D(12, 12, 12), device="cpu")
    if precision == "mixed":
        jk, ksp = JKSP(rtol=1e-8).set_operators(jhi, jlo), KSP(rtol=1e-8).set_operators(op_hi, op_lo)
    else:
        jk = JKSP(rtol=1e-8, precision="f64").set_operators(jhi)
        ksp = KSP(rtol=1e-8, precision="f64").set_operators(op_hi)
    want = jk.mat_solve(jnp.stack([jb, 3.0 * jb, jb + 0.1 * jnp.sin(7.0 * jb)]))
    cols = torch.stack([b, 3.0 * b, b + 0.1 * torch.sin(7.0 * b)])
    got = ksp.mat_solve(cols)
    assert got.reason.tolist() == np.asarray(want.reason).tolist() == [2, 2, 2]
    assert got.outer_iters.tolist() == np.asarray(want.outer_iters).tolist()
    assert np.abs(got.iters.numpy() - np.asarray(want.iters)).max() <= 1
    wx = np.asarray(want.x)
    assert np.abs(got.x.numpy() - wx).max() <= 1e-6 * np.abs(wx).max()
    for c in range(3):
        single = ksp.solve(cols[c])
        assert abs(int(got.iters[c]) - single.iters) <= 1
        assert (got.x[c] - single.x).abs().max().item() <= 1e-6 * single.x.abs().max().item()


def test_remaining_refusals_name_items_9_2_and_10():
    """What item 9.2 brought now runs as in JAX: GAMG's block-Jacobi level
    smoother on aij and a non-grid pattern (the greedy route).  The 3-D
    DFDIA view, refused as queue 12 until ``sparse/griddia.py`` was ported,
    applies as the flat form.  A host matrix past 192 diagonals and
    mat_reorder="rcm", refused as item 10 before it was ported, solve as in
    JAX."""
    import scipy.sparse as sp

    from tpusparse_torch.sparse.dia import DFDIA
    from tpusparse_torch.sparse.griddia import host_grid_view

    kw = dict(rtol=1e-8, **{**BLIND, "warmup": False}, assembly="host")
    got = solve_poisson(8, device="cpu", amg_params=AMGParams(bjacobi_bs=4), **kw)
    want = j_solve_poisson(8, amg_params=JAMGParams(bjacobi_bs=4), **kw)
    assert (got.iters, got.outer_iters, got.reason) == (want.iters, want.outer_iters, want.reason)
    assert got.reason == 2 and got.linf_error == pytest.approx(want.linf_error, abs=1e-6)
    tri = sp.diags([-1.0, 2.5, -1.0], [-1, 0, 1], shape=(50, 50), format="csr")
    b = np.ones(50)
    got = KSP(rtol=1e-8).set_operators(tri, device="cpu").solve(torch.tensor(b))
    want = JKSP(rtol=1e-8).set_operators(tri).solve(jnp.asarray(b))
    assert (got.iters, got.outer_iters, got.reason) == (int(want.iters), int(want.outer_iters), int(want.reason))
    op_hi = poisson_dia_device(Grid3D(4, 4, 4), device="cpu")[0]
    d3s = host_grid_view(op_hi.hi.numpy(), op_hi.offsets, (4, 4, 4))
    grid = DFDIA(op_hi.hi, op_hi.lo, op_hi.offsets, op_hi.shape, grid=((4, 4, 4), d3s))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(64))
    np.testing.assert_allclose(grid.mv(x).numpy(), op_hi.mv(x).numpy(), rtol=1e-14, atol=1e-12)
    rng = np.random.default_rng(3)
    m = sp.random(300, 300, density=0.05, random_state=rng, format="csr")
    wide = (m + m.T + 30.0 * sp.eye(300)).tocsr()
    b = np.ones(300)
    for reorder in ("auto", "rcm"):
        got = KSP(rtol=1e-8, mat_reorder=reorder).set_operators(wide, device="cpu").solve(torch.tensor(b))
        want = JKSP(rtol=1e-8, mat_reorder=reorder).set_operators(wide).solve(jnp.asarray(b))
        assert (got.iters, got.outer_iters, got.reason) == (int(want.iters), int(want.outer_iters), int(want.reason))
        assert np.abs(got.x.numpy() - np.asarray(want.x)).max() <= 1e-6

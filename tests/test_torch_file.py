"""The file route (PETSc's ex10): ``solve_from_file`` and the CLI's
``-mat_view`` → ``-f`` → ``-ksp_view_solution`` round trip against the JAX
package's on the same files, on the CPU.  Mixed-precision solves to JAX's
outer count and reason, inner within 1 (f32 summation order), Linf within
1e-6 (tests/test_torch_aij.py's tolerance); uniform f64 to JAX's counts."""

import json

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp
import torch

from tpusparse.__main__ import main as j_main
from tpusparse.bench.driver import solve_from_file as j_solve_from_file
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import assemble_poisson as j_assemble_poisson
from tpusparse.sparse.io import save_petsc_mat as j_save_petsc_mat
from tpusparse.sparse.io import save_petsc_vec as j_save_petsc_vec
from tpusparse_torch.__main__ import main
from tpusparse_torch.bench.driver import solve_from_file
from tpusparse_torch.sparse.io import load_petsc_vec, read_petsc_objects, save_petsc_mat, save_petsc_vec

TOL = dict(rtol=1e-8, atol=1e-12)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_file(tmp_path, n):
    """The n^3 Poisson system written by the JAX package: matrix, rhs,
    exact solution."""
    a, b, exact = j_assemble_poisson(JGrid3D(n, n, n))
    path = str(tmp_path / f"p{n}.petsc")
    j_save_petsc_mat(path, a)
    j_save_petsc_vec(path, b, append=True)
    j_save_petsc_vec(path, exact, append=True)
    return path


def _same(got, want, inner=1, linf=1e-6):
    assert (got.outer_iters, got.reason) == (int(want.outer_iters), int(want.reason))
    assert abs(got.iters - int(want.iters)) <= inner
    assert got.linf_error == pytest.approx(want.linf_error, abs=linf)


@pytest.mark.parametrize("n", [16, 24])
def test_solve_from_file_matches_jax(tmp_path, n):
    """GAMG under mixed precision on a file the JAX package wrote: the
    report's provenance, t_init's parts, and JAX's outcome."""
    path = _jax_file(tmp_path, n)
    want = j_solve_from_file(path, **TOL)
    got = solve_from_file(path, device="cpu", **TOL)
    _same(got, want)
    assert got.reason == 2 and got.linf_error < 0.05
    assert (got.nx, got.ny, got.nz, got.source, got.source_is_file) == (n**3, n**3, 1, path, True)
    assert set(got.init_breakdown) == {"read", "diagonals", "host_bands", "upload"}
    assert got.reference_block().splitlines()[0] == f"Matrix: {path} [{n**3} x {n**3}]"
    side = json.loads(got.json_sidecar())
    assert side["mat_type"] == "aij" and side["device"] == "cpu" and side["source_is_file"]


@pytest.mark.parametrize(
    "kw",
    [dict(precision="f64"), dict(precision="f32", rtol=1e-6), dict(pc="jacobi", precision="f64"),
     dict(pc="bjacobi"), dict(pc="none", precision="f64"), dict(ksp="gmres", precision="f64")],
    ids=["f64", "f32", "jacobi", "bjacobi", "none", "gmres"],
)
def test_solve_from_file_options_match_jax(tmp_path, kw):
    """Uniform precision, the standalone PCs (bjacobi: point Jacobi from
    the host diagonal, the CLI's bs 0) and another Krylov method on the
    16^3 file; uniform f32's Linf within 2e-5 (tests/test_torch_plain.py's
    rule)."""
    path = _jax_file(tmp_path, 16)
    kw = {**TOL, **kw}
    want = j_solve_from_file(path, **kw)
    got = solve_from_file(path, device="cpu", **kw)
    linf = 2e-5 if kw.get("precision") == "f32" else 1e-6
    uniform = kw.get("precision") in ("f64", "f32")
    _same(got, want, inner=0 if uniform and kw.get("pc") != "none" else 1, linf=linf)


def _poisson2d(n):
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    return (sp.kron(sp.eye(n), t) + sp.kron(t, sp.eye(n))).tocsr()


def test_file_without_rhs_or_exact_and_matrix_market(tmp_path):
    """ex10's fallbacks: no rhs → b = ones, no exact vector → Linf -1 and
    "n/a"; a MatrixMarket file; a 2-D pattern takes the geometric route."""
    a = _poisson2d(12) + sp.eye(144) * 0.1
    path = str(tmp_path / "a.petsc")
    save_petsc_mat(path, a)
    mtx = str(tmp_path / "a.mtx")
    sio.mmwrite(mtx, a)
    for f in (path, mtx):
        want = j_solve_from_file(f, **TOL)
        got = solve_from_file(f, device="cpu", **TOL)
        _same(got, want)
        assert got.linf_error == -1.0 and "n/a (no exact solution in file)" in got.reference_block()


def test_file_errors_match_jax(tmp_path):
    """A non-square matrix, a rhs of the wrong length and a file with no
    matrix raise JAX's ValueError."""
    cases = {}
    rect = str(tmp_path / "rect.petsc")
    save_petsc_mat(rect, sp.random(5, 4, density=0.5, random_state=0, format="csr"))
    cases["rect"] = rect
    short = str(tmp_path / "short.petsc")
    save_petsc_mat(short, sp.eye(4, format="csr"))
    save_petsc_vec(short, np.ones(3), append=True)
    cases["short"] = short
    vec = str(tmp_path / "vec.petsc")
    save_petsc_vec(vec, np.ones(3))
    cases["vec"] = vec
    for label, f in cases.items():
        with pytest.raises(ValueError) as want:
            j_solve_from_file(f)
        with pytest.raises(ValueError) as got:
            solve_from_file(f, device="cpu")
        assert str(got.value) == str(want.value), label


def _cli(fn, argv, capsys):
    assert fn(argv) == 0
    out = capsys.readouterr().out
    side = json.loads(next(line for line in out.splitlines() if line.startswith("JSON: "))[6:])
    return out, side


def test_cli_round_trip_matches_jax(tmp_path, capsys):
    """-mat_view binary:<file> writes the bytes the JAX CLI writes; -f
    solves the file as the JAX CLI does; -ksp_view_solution writes the
    solve's x (its Linf against the file's exact vector is the report's)."""
    grid = ["-da_grid_x", "14", "-da_grid_y", "14", "-da_grid_z", "14", "-ksp_rtol", "1e-8", "-ksp_atol", "1e-12"]
    mine, theirs = str(tmp_path / "t.petsc"), str(tmp_path / "j.petsc")
    out, stencil = _cli(main, [*grid, "-mat_view", f"binary:{mine}", "-device", "cpu"], capsys)
    assert "written to" in out and stencil["mat_type"] == "stencil"
    _cli(j_main, [*grid, "-mat_view", f"binary:{theirs}"], capsys)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    sol, jsol = str(tmp_path / "x.petsc"), str(tmp_path / "jx.petsc")
    args = ["-f", mine, "-ksp_rtol", "1e-8", "-ksp_atol", "1e-12", "-ksp_converged_reason", "-ksp_view"]
    out, got = _cli(main, [*args, "-ksp_view_solution", f"binary:{sol}", "-device", "cpu"], capsys)
    assert "Linear solve converged due to CONVERGED_RTOL" in out and f"Matrix: {mine}" in out
    assert "loaded from" in out and "operator DIA" in out
    _, want = _cli(j_main, [*args, "-ksp_view_solution", f"binary:{jsol}"], capsys)
    assert (got["outer_iters"], got["reason"]) == (want["outer_iters"], want["reason"])
    assert abs(got["iters"] - want["iters"]) <= 1
    assert got["linf_error"] == pytest.approx(want["linf_error"], abs=1e-6)
    assert got["linf_error"] == pytest.approx(stencil["linf_error"], abs=1e-6)
    x, exact = load_petsc_vec(sol), read_petsc_objects(mine)[2]
    assert np.abs(x - exact).max() == got["linf_error"]
    np.testing.assert_allclose(x, load_petsc_vec(jsol), rtol=0, atol=1e-6 * np.abs(x).max())


def test_cli_f_with_the_standalone_block_jacobi(tmp_path, capsys):
    """python -m tpusparse_torch -f file -pc_type bjacobi -precision f64:
    the CLI passes no bjacobi_bs (point Jacobi from the host diagonal), as
    the JAX CLI; the reason line and the file's name in the block."""
    a = _poisson2d(10)
    x_ref = np.random.default_rng(5).standard_normal(100)
    path = str(tmp_path / "s.petsc")
    save_petsc_mat(path, a)
    save_petsc_vec(path, a @ x_ref, append=True)
    args = ["-f", path, "-ksp_rtol", "1e-11", "-pc_type", "bjacobi", "-precision", "f64", "-ksp_converged_reason"]
    out, got = _cli(main, [*args, "-device", "cpu"], capsys)
    _, want = _cli(j_main, args, capsys)
    assert (got["iters"], got["reason"]) == (want["iters"], want["reason"])
    assert f"Matrix: {path}" in out and got["linf_error"] == -1.0


def test_refusals_name_items_9_2_and_10(tmp_path, capsys):
    """GAMG on a pattern that is no 3-D grid (the greedy route) and with
    -pc_bjacobi_bs, which item 9.2 brought, solve as in JAX; the file
    route still refuses a matrix past the DIA family's 192 diagonals (RCM
    and the banded ELL, item 10)."""
    tri = str(tmp_path / "tri.petsc")
    save_petsc_mat(tri, sp.diags([-1.0, 2.5, -1.0], [-1, 0, 1], shape=(64, 64), format="csr"))
    _same(solve_from_file(tri, device="cpu", **TOL), j_solve_from_file(tri, **TOL))
    args = ["-f", tri, "-pc_bjacobi_bs", "4", "-ksp_rtol", "1e-8"]
    _, got = _cli(main, [*args, "-device", "cpu"], capsys)
    _, want = _cli(j_main, args, capsys)
    assert (got["outer_iters"], got["reason"]) == (want["outer_iters"], want["reason"])
    assert abs(got["iters"] - want["iters"]) <= 1
    rng = np.random.default_rng(3)
    m = sp.random(400, 400, density=0.05, random_state=rng, format="csr")
    scattered = str(tmp_path / "scattered.petsc")
    save_petsc_mat(scattered, (m + m.T + 40.0 * sp.eye(400)).tocsr())
    with pytest.raises(NotImplementedError, match="item 10"):
        solve_from_file(scattered, device="cpu", pc="jacobi")
    assert j_solve_from_file(scattered, pc="jacobi", precision="f64").reason > 0

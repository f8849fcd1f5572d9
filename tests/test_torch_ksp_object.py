"""The KSP object (PETSc KSPCreate / SetOperators / SetUp / Solve parity,
src/main_ksp.cpp:92-117): the port's ``tpusparse_torch.KSP`` against the
JAX package's ``KSP`` on the same systems.  The port's plain route is held
to JAX's ``KSP()`` (the plain layout on the CPU), its padded route to
JAX's ``KSP(layout="padded")``; mixed-precision solves to the same outer
count and reason, inner within 1 (f32 summation order), x to 1e-6."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpusparse
import tpusparse_torch
from tpusparse import KSP as JKSP
from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.bench.driver import DivergedError as JDivergedError
from tpusparse.config import load_options as j_load_options
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import assemble_poisson as j_assemble_poisson
from tpusparse.grid.poisson import poisson_dia_device as j_poisson_dia_device
from tpusparse.grid.poisson import poisson_stencil_device as j_poisson_stencil_device
from tpusparse_torch import KSP, Grid3D, KSPResult, StarStencil3D
from tpusparse_torch.amg.hierarchy import AMGParams
from tpusparse_torch.config.options import load_options
from tpusparse_torch.grid.poisson import assemble_poisson, poisson_dia_device, poisson_stencil_device
from tpusparse_torch.ksp import DivergedError
from tpusparse_torch.sparse.csr import HostCSR
from tpusparse_torch.sparse.dia import DIA

N = 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _systems(n=N):
    """The f64 pinned Poisson system in both packages: (jop, jb, jexact),
    (op, b, exact)."""
    return j_poisson_stencil_device(JGrid3D(n, n, n)), poisson_stencil_device(Grid3D(n, n, n), device="cpu")


def _scaled(op, s):
    return dataclasses.replace(op, diag=s * op.diag, cx=s * op.cx, cy=s * op.cy, cz=s * op.cz)


def _j_scaled(jop, s):
    return jax.tree.map(lambda v: s * v if hasattr(v, "dtype") and v.dtype.kind == "f" else v, jop)


def _same_mixed(got, want):
    """A mixed-precision port result held to the JAX one."""
    assert (got.outer_iters, got.reason) == (int(want.outer_iters), int(want.reason))
    assert abs(got.iters - int(want.iters)) <= 1
    wx = np.asarray(want.x)
    assert np.abs(got.x.numpy() - wx).max() <= 1e-6 * np.abs(wx).max()


@pytest.fixture(scope="module")
def solves():
    """One solve a layout at 12^3 in both packages, with the KSP objects."""
    (jop, jb, _), (op, b, exact) = _systems()
    out = {}
    for layout, jlayout in (("plain", "auto"), ("padded", "padded")):
        jk = JKSP(rtol=1e-8, layout=jlayout).set_operators(jop)
        ksp = KSP(rtol=1e-8, layout=layout).set_operators(op)
        out[layout] = (jk, jk.solve(jb), ksp, ksp.solve(b))
    return out, (jop, jb), (op, b, exact)


@pytest.mark.parametrize("layout", ["plain", "padded"])
def test_structured_solve_matches_jax(solves, layout):
    """CG + GAMG through the object API: JAX's outcome, the manufactured
    solution, and the Get* accessors mirroring the result."""
    out, _, (_, _, exact) = solves
    _, want, ksp, got = out[layout]
    assert isinstance(got, KSPResult) and got.converged and got.reason == 2
    _same_mixed(got, want)
    assert (got.x - exact).abs().max().item() < 2e-1  # O(h^2) at 12^3
    assert (ksp.iterations, ksp.residual_norm, ksp.converged_reason) == (got.iters, got.resnorm, got.reason)
    assert (ksp._encode is not None) == (layout == "padded")


@pytest.mark.parametrize("layout", ["plain", "padded"])
def test_reuse_across_rhs(solves, layout):
    """A second right-hand side reuses the preconditioner; 2b gives 2x bit
    for bit (the normalized inner right-hand sides are the same bits), as
    JAX's object gives 2x to 1e-6."""
    out, (_, jb), (_, b, _) = solves
    jk, jfirst, ksp, first = out[layout]
    hier = ksp._pc_state
    second = ksp.solve(2.0 * b)
    assert ksp._pc_state is hier  # KSPSetReusePreconditioner(TRUE)
    assert torch.equal(second.x, 2.0 * first.x)
    jx = np.asarray(jk.solve(2.0 * jb).x)
    assert np.abs(jx - 2.0 * np.asarray(jfirst.x)).max() <= 1e-6 * np.abs(jx).max()


def test_reuse_preconditioner_across_operators():
    """PETSc semantics: with reuse on, set_operators keeps the old PC; with
    reuse off, the next solve rebuilds it; both solves JAX's."""
    (jop, jb, _), (op, b, _) = _systems()
    ksp = KSP(rtol=1e-8, layout="plain").set_operators(op).setup()
    hier = ksp._pc_state
    ksp.set_operators(op)
    assert ksp._pc_state is hier
    jk = JKSP(rtol=1e-8).set_operators(jop).setup()
    jk.set_operators(jop)
    _same_mixed(ksp.solve(b), jk.solve(jb))

    fresh = KSP(rtol=1e-8, layout="plain", reuse_preconditioner=False).set_operators(op).setup()
    first = fresh._pc_state
    fresh.set_operators(op)
    assert fresh._pc_state is None  # dropped; the next solve rebuilds
    got = fresh.solve(b)
    assert got.converged and fresh._pc_state is not first
    jfresh = JKSP(rtol=1e-8, reuse_preconditioner=False).set_operators(jop)
    _same_mixed(got, jfresh.solve(jb))


def test_reused_pc_preconditions_a_new_operator():
    """With reuse on, a scaled operator is solved under the OLD operator's
    hierarchy (plain layout): the same solution, JAX's counts."""
    (jop, jb, _), (op, b, _) = _systems()
    ksp = KSP(rtol=1e-8, layout="plain").set_operators(op)
    ksp.solve(b)
    got = ksp.set_operators(_scaled(op, 1.5)).solve(1.5 * b)
    jk = JKSP(rtol=1e-8).set_operators(jop)
    jk.solve(jb)
    _same_mixed(got, jk.set_operators(_j_scaled(jop, 1.5)).solve(1.5 * jb))


def test_initial_guess_nonzero(solves):
    """x0 (KSPSetInitialGuessNonzero): from the answer, ~0 work; from
    anywhere, the same answer; JAX's counts both ways."""
    out, (_, jb), (_, b, _) = solves
    jk, jfirst, ksp, first = out["padded"]
    warm = ksp.solve(b, x0=first.x)
    assert warm.converged and warm.outer_iters <= 1 and warm.iters <= 2
    assert (warm.x - first.x).abs().max().item() < 1e-8
    jwarm = jk.solve(jb, x0=jfirst.x)
    assert (warm.iters, warm.outer_iters, warm.reason) == (
        int(jwarm.iters), int(jwarm.outer_iters), int(jwarm.reason))
    cold = ksp.solve(b, x0=torch.ones_like(b))
    assert (cold.x - first.x).abs().max().item() < 1e-6
    _same_mixed(cold, jk.solve(jb, x0=jnp.ones_like(jb)))


def test_flat_vectors_roundtrip(solves):
    """Structured operators apply on the field view; a flat right-hand
    side gives a flat solution, the field solve's."""
    out, _, (_, b, _) = solves
    _, _, ksp, first = out["padded"]
    x = ksp.solve(b.reshape(-1)).x
    assert x.shape == (N**3,)
    assert torch.equal(x.reshape(b.shape), first.x)
    x0 = ksp.solve(b.reshape(-1), x0=first.x.reshape(-1)).x
    assert x0.shape == (N**3,)


def test_host_matrices_are_refused_and_jax_solves_them():
    """A HostCSR or scipy matrix goes to the device as the DIA family and
    solves as the JAX package's host route does (JAX's outer count and
    reason, inner within 1, x to 1e-6).  A host matrix past the DIA
    family's 192 diagonals, and ``mat_reorder="rcm"``, raised naming item
    10 before it was ported: now the first is reordered by RCM onto the
    padded ELL and solves as JAX's does (its counts, x to 1e-8), and the
    second reorders any matrix."""
    a, b_np, _ = j_assemble_poisson(JGrid3D(N, N, N), dtype=np.float64)
    want = JKSP(rtol=1e-8).set_operators(a).solve(jnp.asarray(b_np))
    host, b, _ = assemble_poisson(Grid3D(N, N, N))
    assert isinstance(host, HostCSR)
    for a_host in (host, sp.csr_matrix((host.data, host.indices, host.indptr), shape=host.shape)):
        _same_mixed(KSP(rtol=1e-8).set_operators(a_host, device="cpu").solve(torch.tensor(b)), want)
    rng = np.random.default_rng(3)
    scattered = sp.random(400, 400, density=0.05, random_state=rng, format="csr")
    scattered = (scattered + scattered.T + 40.0 * sp.eye(400)).tocsr()
    rhs = np.ones(400)
    jres = JKSP(rtol=1e-8, pc_type="jacobi", precision="f64").set_operators(scattered).solve(jnp.asarray(rhs))
    assert jres.converged
    ksp = KSP(rtol=1e-8, pc_type="jacobi", precision="f64").set_operators(scattered, device="cpu")
    got = ksp.solve(torch.tensor(rhs))
    assert ksp._perm is not None and (got.iters, got.reason) == (int(jres.iters), int(jres.reason))
    assert np.abs(got.x.numpy() - np.asarray(jres.x)).max() <= 1e-8
    rcm = KSP(rtol=1e-8, mat_reorder="rcm").set_operators(host, device="cpu")
    assert rcm._perm is not None
    _same_mixed(rcm.solve(torch.tensor(b)), JKSP(rtol=1e-8, mat_reorder="rcm").set_operators(a).solve(jnp.asarray(b_np)))


def test_dia_family_general_route_matches_jax():
    """A DFDIA outer with its f32 DIA (the aij route's containers) runs the
    geometric GAMG of gamg_setup_unstructured: JAX's outer count and
    reason, inner within 1, on the same system; the f32 DIA defaults to
    the DFDIA's hi bands.  An f64 DIA outer under mixed precision (its f32
    cast the inner operator) and under f64, and the DFDIA under f64, solve
    as in JAX."""
    jhi, jlo, jb, _ = j_poisson_dia_device(JGrid3D(N, N, N))
    want = JKSP(rtol=1e-8).set_operators(jhi, jlo).solve(jb)
    op_hi, op_lo, b, exact = poisson_dia_device(Grid3D(N, N, N), device="cpu")
    got = KSP(rtol=1e-8).set_operators(op_hi, op_lo).solve(b)
    _same_mixed(got, want)
    assert torch.equal(KSP(rtol=1e-8).set_operators(op_hi).solve(b).x, got.x)
    j64 = tpusparse.sparse.DIA(bands=jlo.bands.astype(jnp.float64), offsets=jlo.offsets, shape=jlo.shape)
    dia64 = DIA(op_lo.bands.double(), op_lo.offsets, op_lo.shape)
    _same_mixed(KSP(rtol=1e-8).set_operators(dia64).solve(b), JKSP(rtol=1e-8).set_operators(j64).solve(jb))
    for jop, op in ((j64, dia64), (jhi, op_hi)):
        want = JKSP(rtol=1e-8, precision="f64").set_operators(jop).solve(jb)
        got = KSP(rtol=1e-8, precision="f64").set_operators(op).solve(b)
        assert (got.iters, got.reason) == (int(want.iters), int(want.reason))
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-10)


def test_from_options():
    """KSPSetFromOptions: Options built from CLI words configure the object
    as in JAX, and the f64 Jacobi solve takes JAX's count."""
    argv = ["-ksp_type", "cg", "-ksp_rtol", "1e-7", "-pc_type", "jacobi", "-precision", "f64",
            "-pc_mg_cycle_type", "w", "-layout", "plain"]
    ksp, jk = KSP.from_options(load_options(argv)), JKSP.from_options(j_load_options(argv))
    for name in ("ksp_type", "pc_type", "rtol", "atol", "divtol", "maxiter", "precision", "mg_cycle", "layout"):
        assert getattr(ksp, name) == getattr(jk, name), name
    assert ksp.amg_params.degree == jk.amg_params.degree
    (jop, jb, _), (op, b, _) = _systems()
    got, want = ksp.set_operators(op).solve(b), jk.set_operators(jop).solve(jb)
    assert (got.iters, got.reason) == (int(want.iters), int(want.reason)) and got.reason > 0
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-10)


@pytest.mark.parametrize("kw", [
    dict(precision="f64", pc_type="none"),
    dict(precision="f64", pc_type="sor"),
    dict(precision="f32", rtol=1e-5),
    dict(ksp_type="gmres"),
    dict(mg_cycle="w", layout="padded"),
])
def test_other_configurations_match_jax(kw):
    """Uniform precision with the standalone PCs, GMRES and the W-cycle
    through the object: JAX's counts (uniform f64 exactly)."""
    (jop, jb, _), (op, b, _) = _systems()
    kw = {"rtol": 1e-8, **kw}
    f32 = kw.get("precision") == "f32"
    if f32:
        jop, op = jax.tree.map(lambda v: v.astype(jnp.float32) if hasattr(v, "dtype") and v.dtype.kind == "f"
                               else v, jop), _scaled(op, 1.0)
        op = dataclasses.replace(op, diag=op.diag.float(), cx=float(np.float32(op.cx)),
                                 cy=float(np.float32(op.cy)), cz=float(np.float32(op.cz)))
        jb, b = jb.astype(jnp.float32), b.float()
    want = JKSP(**kw).set_operators(jop).solve(jb)
    got = KSP(**kw).set_operators(op).solve(b)
    assert got.reason == int(want.reason) and got.reason > 0
    if kw.get("precision", "mixed") == "mixed":
        _same_mixed(got, want)
    else:
        assert abs(got.iters - int(want.iters)) <= (1 if f32 else 0)
        wx = np.asarray(want.x)
        assert np.abs(got.x.numpy() - wx).max() <= (1e-4 if f32 else 1e-9) * np.abs(wx).max()


def test_error_if_not_converged():
    """-ksp_error_if_not_converged: a negative reason raises, in both."""
    (jop, jb, _), (op, b, _) = _systems()
    kw = dict(rtol=1e-12, maxiter=3, precision="f64", pc_type="none", error_if_not_converged=True)
    with pytest.raises(JDivergedError):
        JKSP(**kw).set_operators(jop).solve(jb)
    with pytest.raises(DivergedError, match="-3"):
        KSP(**kw).set_operators(op).solve(b)
    with pytest.raises(DivergedError, match="reasons"):
        KSP(**kw).set_operators(op).mat_solve(torch.stack([b, b]))


def test_requires_operator_and_solve():
    ksp = KSP()
    with pytest.raises(RuntimeError, match="set_operators"):
        ksp.setup()
    with pytest.raises(RuntimeError, match="no solve"):
        _ = ksp.iterations
    for kw in (dict(precision="tf"), dict(pc_type="ilu"), dict(mg_cycle="f"), dict(layout="tiled"),
               dict(mat_reorder="amd")):
        with pytest.raises(ValueError):
            KSP(**kw)
    with pytest.raises(ValueError, match="unknown ksp"):
        KSP(ksp_type="lsqr")
    with pytest.raises(ValueError, match="bjacobi"):
        KSP(pc_type="bjacobi").set_operators(_systems()[1][0]).setup()


def test_reuse_swap_on_padded_layout():
    """KSPSetReusePreconditioner + an operator swap on the PADDED layout:
    the swapped twin is padded again, the solve of the scaled pair gives
    the same solution, with JAX's counts (at 18^3 and rtol 1e-8: with
    rtol 1e-7 at 12^3-18^3, or on a swapped operator at 12^3, the second
    sweep's inner count follows the first sweep's rounding in both
    packages, 14 or 18 at 16^3 and 18^3; ROADMAP section 3)."""
    (jop, jb, _), (op, b, _) = _systems(18)
    ksp = KSP(rtol=1e-8, layout="padded").set_operators(op)
    r1 = ksp.solve(b)
    hier = ksp._pc_state
    r2 = ksp.set_operators(_scaled(op, 1.5)).solve(1.5 * b)
    assert ksp._pc_state is hier and r1.converged and r2.converged
    np.testing.assert_allclose(r2.x.numpy(), r1.x.numpy(), rtol=3e-4, atol=1e-6)
    jk = JKSP(rtol=1e-8, layout="padded").set_operators(jop)
    _same_mixed(r1, jk.solve(jb))
    _same_mixed(r2, jk.set_operators(_j_scaled(jop, 1.5)).solve(1.5 * jb))
    # a twin on another grid cannot be padded for the kept hierarchy: dropped
    other = poisson_stencil_device(Grid3D(8, 8, 8), device="cpu")[0]
    assert ksp.set_operators(other)._pc_state is None


def test_no_reuse_swap_invalidates_mat_solve_twin():
    """reuse_preconditioner=False + an operator swap drops mat_solve's
    plain twin hierarchy with the PC, so the new operator is not
    preconditioned by the old one's; counts as JAX's."""
    (jop, jb, _), (op, b, _) = _systems()
    ksp = KSP(rtol=1e-8, precision="f64", reuse_preconditioner=False).set_operators(op)
    res1 = ksp.mat_solve(torch.stack([b.reshape(-1)]))
    assert res1.reason.tolist() == [2] and res1.x.shape == (1, N**3)
    ksp.set_operators(_scaled(op, 3.0))
    assert ksp._pc_state_plain is None and ksp._pc_state is None
    res2 = ksp.mat_solve(torch.stack([(3.0 * b).reshape(-1)]))
    np.testing.assert_allclose(res2.x[0].numpy(), res1.x[0].numpy(), rtol=1e-6, atol=1e-8)
    jk = JKSP(rtol=1e-8, precision="f64", reuse_preconditioner=False).set_operators(jop)
    jk.mat_solve(jnp.stack([jb.reshape(-1)]))
    want = jk.set_operators(_j_scaled(jop, 3.0)).mat_solve(jnp.stack([(3.0 * jb).reshape(-1)]))
    assert res2.iters.tolist() == np.asarray(want.iters).tolist()
    assert res2.reason.tolist() == np.asarray(want.reason).tolist()


def test_mat_solve_twin_on_the_padded_layout():
    """On the padded layout mat_solve builds the plain twin hierarchy once
    and keeps it across calls."""
    (_, _, _), (op, b, _) = _systems()
    ksp = KSP(rtol=1e-8).set_operators(op)
    ksp.mat_solve(torch.stack([b]))
    twin = ksp._pc_state_plain
    assert twin is not None and twin is not ksp._pc_state
    ksp.mat_solve(torch.stack([b, -b]))
    assert ksp._pc_state_plain is twin


def test_padded_layout_with_plain_only_params_errors():
    """layout='padded' with options the fused kernels cannot honour raises
    the driver's error, as in JAX."""
    (jop, jb, _), (op, b, _) = _systems()
    with pytest.raises(ValueError, match="point-Jacobi"):
        JKSP(rtol=1e-7, layout="padded", amg_params=JAMGParams(coarse_solve="lu")).set_operators(jop).solve(jb)
    with pytest.raises(ValueError, match="point-Jacobi"):
        KSP(rtol=1e-7, layout="padded", amg_params=AMGParams(coarse_solve="lu")).set_operators(op).solve(b)
    # layout="auto" takes the plain cycle for them
    got = KSP(rtol=1e-8, amg_params=AMGParams(coarse_solve="lu")).set_operators(op)
    assert got.solve(b).converged and got._encode is None


@pytest.mark.parametrize("layout", ["plain", "padded"])
def test_compute_eigenvalues_matches_jax(solves, layout):
    """KSPComputeEigenvalues: the Ritz values of M A from a CG run on the
    PC's home operator, JAX's."""
    out, _, _ = solves
    jk, _, ksp, _ = out[layout]
    want = jk.compute_eigenvalues(maxiter=20)
    got = ksp.compute_eigenvalues(maxiter=20)
    assert got.shape == want.shape and np.all(np.diff(got) >= 0)
    # the extremes converge first and agree closely; the interior Ritz
    # values of 20 f32 steps carry the cycles' rounding (5e-4 on the padded
    # layout, whose fused fine level sums in another order than JAX's)
    np.testing.assert_allclose(got[[0, -1]], want[[0, -1]], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_exports_match_the_jax_package():
    """The package exports JAX's top-level names, the sparse package
    JAX's but PallasDIA and StarStencilDF (not to port), and the
    solvers JAX's solve/__init__.py exports but the two that are not to
    port; importing builds no kernel."""
    assert set(tpusparse_torch.__all__) == set(tpusparse.__all__)
    assert tpusparse_torch.StarStencil3D is StarStencil3D
    assert tpusparse_torch.HostCSR is HostCSR
    import tpusparse.sparse as j_sparse
    import tpusparse_torch.sparse as t_sparse
    assert set(t_sparse.__all__) == set(j_sparse.__all__) - {"PallasDIA", "StarStencilDF"}
    assert all(hasattr(t_sparse, name) for name in t_sparse.__all__)
    import tpusparse.solve as j_solve
    import tpusparse_torch.solve as t_solve
    assert set(t_solve.__all__) == set(j_solve.__all__) - {"cg_hostloop", "cg_refined_tf"}
    assert all(hasattr(t_solve, name) for name in t_solve.__all__)
    from tpusparse_torch.kernels import _build
    assert _build._lib is None


def test_ksp_imports_nothing_from_the_cli_driver():
    """Imports point one way: ``bench/`` builds on ``ksp.py``, never the
    reverse.  A fresh interpreter that imports ``tpusparse_torch.ksp``
    holds no ``tpusparse_torch.bench`` module, and no import in ``ksp.py``,
    at module level or inside a function, names one."""
    root = pathlib.Path(__file__).resolve().parents[1]
    code = "import sys, tpusparse_torch.ksp; print([m for m in sys.modules if m.startswith('tpusparse_torch.bench')])"
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
    tree = ast.parse((root / "tpusparse_torch/ksp.py").read_text())
    named = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    named += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert named and not [m for m in named if "bench" in m.split(".")]

"""RCM reordering for any sparsity pattern on the port against the JAX
package on the CPU: ``sparse/reorder.py``, the port's own C++
``rcm_order`` (``native.py``), ``KSP``'s permuted solve with
``mat_reorder`` "auto" / "rcm" / "none", the padded ELL past 192
diagonals (where JAX takes its ``BandedELL``), ``mat_solve`` on a
reordered ``KSP``, ``-mat_reorder`` through ``-f`` and
``bench/reorderbench.py``.

The permutation must equal JAX's ``tpusparse.native.rcm`` element for
element: greedy aggregation follows the order, so with another order no
GAMG count could be compared.
"""

import contextlib
import io
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse import native as j_native
from tpusparse.__main__ import main as j_main
from tpusparse.bench import reorderbench as j_reorderbench
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import assemble_poisson as j_assemble_poisson
from tpusparse.ksp import KSP as JKSP
from tpusparse.sparse import reorder as j_reorder
from tpusparse.sparse.csr import HostCSR as JHostCSR
from tpusparse_torch.__main__ import main
from tpusparse_torch.bench import reorderbench
from tpusparse_torch.ksp import KSP
from tpusparse_torch.sparse import reorder
from tpusparse_torch.sparse.csr import HostCSR
from tpusparse_torch.sparse.ell import ELL
from tpusparse_torch.sparse.io import save_petsc_mat, save_petsc_vec


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port(a) -> HostCSR:
    return HostCSR(indptr=a.indptr, indices=a.indices, data=a.data, shape=tuple(a.shape))


def _scrambled(n: int, seed: int = 0):
    """The pinned n^3 Poisson system (JAX's assembly) randomly permuted:
    (natural JAX matrix, scrambled JAX matrix, b, scrambled b, p)."""
    a, b, _ = j_assemble_poisson(JGrid3D(n, n, n))
    p = np.random.default_rng(seed).permutation(a.n_rows)
    return a, j_reorder.permute_csr(a, p), b, b[p], p


def _unsymmetric() -> JHostCSR:
    m = sp.random(300, 300, density=0.02, random_state=np.random.default_rng(1), format="csr")
    return JHostCSR.from_scipy((m + sp.eye(300)).tocsr())


def _components() -> JHostCSR:
    """Five random blocks and an identity block, scrambled: six and more
    connected components."""
    blocks = [sp.random(50, 50, density=0.05, random_state=np.random.default_rng(k)) for k in range(5)]
    m = sp.block_diag([*blocks, sp.eye(20)]).tocsr()
    m = (m + m.T).tocsr()
    q = np.random.default_rng(5).permutation(m.shape[0])
    return j_reorder.permute_csr(JHostCSR.from_scipy(m), q)


def test_bandwidth_and_diagonals_match_jax():
    _, s, _, _, _ = _scrambled(10)
    for m in (s, _unsymmetric(), JHostCSR.from_scipy(sp.eye(5, format="csr")), JHostCSR.from_scipy(sp.csr_matrix((4, 4)))):
        assert reorder.bandwidth(_port(m)) == j_reorder.bandwidth(m)
        assert reorder.distinct_diagonals(_port(m)) == j_reorder.distinct_diagonals(m)


@pytest.mark.parametrize("case", ["scrambled_poisson_12", "unsymmetric", "components"])
def test_rcm_permutation_is_jax_element_for_element(case):
    assert j_native.lib() is not None  # JAX's native engine, not its scipy fallback
    m = {"scrambled_poisson_12": lambda: _scrambled(12)[1], "unsymmetric": _unsymmetric,
         "components": _components}[case]()
    if case == "unsymmetric":
        assert not reorder._pattern_symmetric(_port(m))
    got, want = reorder.rcm_permutation(_port(m)), j_reorder.rcm_permutation(m)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(m.n_rows))
    if case == "scrambled_poisson_12":
        assert reorder.bandwidth(reorder.permute_csr(_port(m), got)) < reorder.bandwidth(_port(m)) // 10


def test_inverse_and_permute_match_jax():
    _, s, _, _, _ = _scrambled(8)
    perm = np.random.default_rng(3).permutation(s.n_rows)
    inv = reorder.inverse_permutation(perm)
    assert np.array_equal(inv, j_reorder.inverse_permutation(perm)) and np.array_equal(perm[inv], np.arange(perm.size))
    got, want = reorder.permute_csr(_port(s), perm), j_reorder.permute_csr(s, perm)
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    sym = reorder._symmetrize_pattern(_port(_unsymmetric()))
    jsym = j_reorder._symmetrize_pattern(_unsymmetric())
    assert reorder._pattern_symmetric(sym) and np.array_equal(sym.indices, jsym.indices)


def test_auto_reorder_gamg_matches_jax():
    """A scrambled 14^3 system in mixed precision with GAMG: RCM, the ELL
    pair past 192 diagonals and a HybridDIA level 0, JAX's permutation,
    its counts, and x within 1e-6 of JAX's."""
    _, s, _, bp, _ = _scrambled(14)
    jk = JKSP(rtol=1e-8).set_operators(s)
    want = jk.solve(jnp.asarray(bp))
    k = KSP(rtol=1e-8).set_operators(_port(s), device="cpu")
    got = k.solve(torch.tensor(bp))
    assert np.array_equal(k._perm.numpy(), np.asarray(jk._perm))
    assert isinstance(k._op, ELL) and (k._op.dtype, type(k._op_lo).__name__) == (torch.float64, "HybridDIA")
    assert type(jk._op).__name__ == "BandedELL"
    assert (got.iters, got.outer_iters, got.reason) == (int(want.iters), int(want.outer_iters), int(want.reason))
    assert got.reason == 2
    assert np.abs(got.x.numpy() - np.asarray(want.x)).max() <= 1e-6


def test_rcm_jacobi_takes_the_natural_count():
    """Jacobi in f64 at 10^3 with mat_reorder="rcm" on the scrambled
    matrix: within 2 inner of the natural order's (a similarity transform
    and a diagonal preconditioner), x the natural x permuted."""
    a, s, b, bp, p = _scrambled(10)
    kw = dict(rtol=1e-8, pc_type="jacobi", precision="f64")
    natural = KSP(**kw).set_operators(_port(a), device="cpu").solve(torch.tensor(b))
    k = KSP(mat_reorder="rcm", **kw).set_operators(_port(s), device="cpu")
    got = k.solve(torch.tensor(bp))
    assert k._perm is not None and got.reason == natural.reason == 2
    assert abs(got.iters - natural.iters) <= 2
    assert (got.x - natural.x[torch.as_tensor(p)]).abs().max().item() <= 1e-8


def test_no_reorder_lands_on_ell_with_jax_count():
    """mat_reorder="none" keeps the scrambled order: the ELL pair (JAX's
    BandedELL) and JAX's counts."""
    _, s, _, bp, _ = _scrambled(12)
    jk = JKSP(rtol=1e-8, mat_reorder="none").set_operators(s)
    want = jk.solve(jnp.asarray(bp))
    k = KSP(rtol=1e-8, mat_reorder="none").set_operators(_port(s), device="cpu")
    assert k._perm is None and isinstance(k._op, ELL) and isinstance(k._op_lo, ELL)
    got = k.solve(torch.tensor(bp))
    assert (got.iters, got.outer_iters, got.reason) == (int(want.iters), int(want.outer_iters), int(want.reason))
    assert np.abs(got.x.numpy() - np.asarray(want.x)).max() <= 1e-6


def test_mat_solve_on_a_reordered_ksp_permutes_each_column():
    """The port permutes each column as solve does (each column equals its
    solve to 1e-6); JAX's mat_solve does not apply its permutation, and its
    columns are far from its own solves (ROADMAP §3)."""
    _, s, _, bp, _ = _scrambled(12)
    block = np.stack([bp, 5 * bp, bp + 0.1 * np.sin(7 * bp)])
    k = KSP(rtol=1e-8).set_operators(_port(s), device="cpu")
    got = k.mat_solve(torch.tensor(block))
    assert got.reason.tolist() == [2, 2, 2]
    for c in range(3):
        x = k.solve(torch.tensor(block[c])).x
        assert (got.x[c] - x).abs().max().item() <= 1e-6 * max(1.0, x.abs().max().item())
    jk = JKSP(rtol=1e-8).set_operators(s)
    jm = jk.mat_solve(jnp.asarray(block))
    jx = np.asarray(jk.solve(jnp.asarray(block[0])).x)
    print(f"JAX mat_solve column 0 against its solve: {np.abs(np.asarray(jm.x[0]) - jx).max():.3e} (max|x|"
          f" {np.abs(jx).max():.3e})")
    assert np.abs(np.asarray(jm.x[0]) - jx).max() > 1e-2 * np.abs(jx).max()


def _cli(fn, argv, capsys):
    assert fn(argv) == 0
    out = capsys.readouterr().out
    return out, json.loads(next(line for line in out.splitlines() if line.startswith("JSON: "))[6:])


@pytest.mark.parametrize("reorder_opt", ["auto", "rcm"])
def test_mat_reorder_through_f_matches_jax(tmp_path, capsys, reorder_opt):
    """-f on a scrambled 12^3 file written by save_petsc_mat (matrix, rhs):
    the port's -mat_reorder reaches KSP; JAX's CLI leaves KSP at "auto",
    which reorders this file too, so the counts agree."""
    _, s, _, bp, _ = _scrambled(12)
    path = str(tmp_path / "scrambled.petsc")
    save_petsc_mat(path, _port(s))
    save_petsc_vec(path, bp, append=True)
    args = ["-f", path, "-ksp_rtol", "1e-8", "-ksp_atol", "1e-12", "-ksp_converged_reason"]
    out, got = _cli(main, [*args, "-mat_reorder", reorder_opt, "-device", "cpu"], capsys)
    _, want = _cli(j_main, [*args, "-mat_reorder", reorder_opt], capsys)
    assert (got["iters"], got["outer_iters"], got["reason"]) == (want["iters"], want["outer_iters"], want["reason"])
    assert got["reason"] == 2 and "rcm" in got["init_breakdown"]


def test_reorderbench_matches_jax(capsys, monkeypatch):
    """The record at 12^3 with GAMG: JAX's fields and values for the
    permuted system, the containers and its count.  The natural order
    takes the geometric route, whose hierarchy JAX compiles: the rho start
    vector rounded once moves its count by one (27 against the port's 28;
    ROADMAP §3), so that count is held to within 2."""
    got = reorderbench.main(["12", "--device", "cpu"])
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["reorderbench", "12"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        j_reorderbench.main()
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"natural-order inner: port {got['natural_iters']}, JAX {want['natural_iters']}")
    assert set(want) <= set(got)
    for key in ("n", "rows", "pc", "seed", "bandwidth_scrambled", "diagonals_scrambled", "bandwidth_rcm",
                "diagonals_rcm", "reordered", "container_level0", "iters", "reason"):
        assert got[key] == want[key], key
    assert abs(got["natural_iters"] - want["natural_iters"]) <= 2
    assert (got["container"], want["container"]) == ("ELL", "BandedELL")
    assert got["x_agreement_linf"] < 1e-6

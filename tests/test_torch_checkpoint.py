"""Checkpoint / resume: the port's ``solve/checkpoint.py`` against the JAX
package's.  Both write the same npz (``leaf_<i>`` arrays and the
``__meta__`` JSON bytes), so a file written by one package resumes in the
other with the count and answer of a solve that never stopped."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import poisson_stencil as j_poisson_stencil
from tpusparse.solve import cg as j_cg
from tpusparse.solve.checkpoint import CheckpointConfig as JCheckpointConfig
from tpusparse.solve.checkpoint import cg_checkpointed as j_cg_checkpointed
from tpusparse.solve.checkpoint import load_pytree as j_load_pytree
from tpusparse.solve.checkpoint import save_pytree as j_save_pytree
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil
from tpusparse_torch.solve import CheckpointConfig, cg, cg_checkpointed
from tpusparse_torch.solve.checkpoint import load_pytree, save_pytree

N = 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def systems():
    """The host-assembled f64 system at 12^3 in both packages (the JAX
    tests' ``poisson_stencil``)."""
    jop, jb, _ = j_poisson_stencil(JGrid3D(N, N, N))
    op, b, _ = poisson_stencil(Grid3D(N, N, N), device="cpu")
    return (jop, jnp.asarray(jb)), (op, b)


def _tree(lib):
    return {
        "a": lib.arange(10, dtype=lib.float64),
        "b": (lib.ones((3, 4), dtype=lib.float32), 7 if lib is torch else jnp.int32(7)),
    }


def test_pytree_roundtrip(tmp_path):
    """A tree of tensors and numbers round-trips with its metadata; the
    file is the JAX package's, read by it, and a JAX file reads here."""
    tree = _tree(torch)
    path = save_pytree(tmp_path / "state.npz", tree, {"iters": 42})
    restored, meta = load_pytree(path, tree)
    assert meta == {"iters": 42}
    assert torch.equal(restored["a"], tree["a"]) and torch.equal(restored["b"][0], tree["b"][0])
    assert restored["b"][1] == 7 and isinstance(restored["b"][1], int)
    assert not list(tmp_path.glob("*.tmp"))  # written atomically
    with np.load(path) as z:
        assert sorted(z.files) == ["__meta__", "leaf_0", "leaf_1", "leaf_2"]
    jrestored, jmeta = j_load_pytree(path, _tree(jnp))
    assert jmeta == {"iters": 42}
    np.testing.assert_array_equal(np.asarray(jrestored["a"]), np.arange(10))
    assert int(jrestored["b"][1]) == 7
    jpath = j_save_pytree(tmp_path / "jax.npz", _tree(jnp), {"iters": 5})
    back, meta = load_pytree(jpath, tree)
    assert meta == {"iters": 5} and back["b"][0].dtype == torch.float32
    assert torch.equal(back["a"], tree["a"])


def test_checkpointed_matches_direct_and_jax(systems, tmp_path):
    """Chunks of 25 iterations with a snapshot after each: the iterations,
    reason and answer of one uninterrupted cg, and of JAX's checkpointed
    solve."""
    (jop, jb), (op, b) = systems
    direct = cg(op.mv, b, rtol=1e-10, maxiter=2000)
    res, total = cg_checkpointed(op.mv, b, CheckpointConfig(path=tmp_path / "cg.npz", every=25),
                                 rtol=1e-10, maxiter=2000)
    assert res.converged() and (total, res.iters, res.reason) == (direct.iters, direct.iters, direct.reason)
    assert torch.equal(res.x, direct.x)  # the resumed state is the iteration's own
    jres, jtotal = j_cg_checkpointed(jop.mv, jb, JCheckpointConfig(path=tmp_path / "j.npz", every=25),
                                     rtol=1e-10, maxiter=2000)
    assert total == jtotal and res.reason == int(jres.reason)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-7, atol=1e-9)


def test_resume_from_partial(systems, tmp_path):
    """A solve cut by its budget leaves a snapshot; a fresh call resumes it
    and ends where the uninterrupted solve ends."""
    (_, _), (op, b) = systems
    cfg = CheckpointConfig(path=tmp_path / "cg.npz", every=20)
    res1, it1 = cg_checkpointed(op.mv, b, cfg, rtol=1e-12, maxiter=40)
    assert not res1.converged() and it1 == 40 and cfg.path.exists()
    res2, it2 = cg_checkpointed(op.mv, b, cfg, rtol=1e-12, maxiter=2000)
    direct = cg(op.mv, b, rtol=1e-12, maxiter=2000)
    assert res2.converged() and it2 > it1 and (it2, res2.reason) == (direct.iters, direct.reason)
    np.testing.assert_allclose(res2.x.numpy(), direct.x.numpy(), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_checkpoint_resumes_in_the_other_package(systems, tmp_path, first):
    """Cut by maxiter in one package, resumed in the other: the count and
    reason of the resuming package's own uninterrupted solve, which are
    JAX's."""
    (jop, jb), (op, b) = systems
    path = tmp_path / "cg.npz"
    kw = dict(rtol=1e-12)
    if first == "jax":
        j_cg_checkpointed(jop.mv, jb, JCheckpointConfig(path=path, every=20), maxiter=40, **kw)
        res, total = cg_checkpointed(op.mv, b, CheckpointConfig(path=path, every=20), maxiter=2000, **kw)
    else:
        cg_checkpointed(op.mv, b, CheckpointConfig(path=path, every=20), maxiter=40, **kw)
        res, total = j_cg_checkpointed(jop.mv, jb, JCheckpointConfig(path=path, every=20), maxiter=2000, **kw)
    jdirect = j_cg(jop.mv, jb, maxiter=2000, **kw)
    assert res.converged() and total == int(jdirect.iters) and int(res.reason) == int(jdirect.reason)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(jdirect.x), rtol=1e-6, atol=1e-8)


def test_a_checkpoint_of_another_problem_is_refused(systems, tmp_path):
    """The fingerprint (tolerances, shape, dtype, ||b||^2 to 1e-10) guards
    a resume; resume=False restarts from zero; keep_history keeps copies."""
    (_, _), (op, b) = systems
    cfg = CheckpointConfig(path=tmp_path / "cg.npz", every=10, keep_history=True)
    cg_checkpointed(op.mv, b, cfg, rtol=1e-12, maxiter=20)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cg.npz", "cg.npz.it10", "cg.npz.it20"]
    for kw in (dict(rtol=1e-10), dict(rtol=1e-12, b=2.0 * b)):
        with pytest.raises(ValueError, match="different problem"):
            cg_checkpointed(op.mv, kw.pop("b", b), cfg, maxiter=30, **kw)
    res, total = cg_checkpointed(op.mv, 2.0 * b, cfg, rtol=1e-12, maxiter=2000, resume=False)
    assert res.converged() and total == cg(op.mv, 2.0 * b, rtol=1e-12, maxiter=2000).iters

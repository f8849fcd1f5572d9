"""Solver-state checkpoint / resume — port of ``tpusparse/solve/checkpoint.py``.

The reference has none (its solves finish in seconds to minutes).  For a
long solve the cheap insurance is snapshotting the Krylov state: for CG
the tuple ``(x, r, z, p, <r, z>, ||r||, it)`` that ``cg(..., return_state=
True)`` returns and ``cg(..., state0=)`` resumes exactly, so a resumed solve
continues the uninterrupted iteration.

The file format is the JAX package's, so a checkpoint written by one
package resumes in the other: an npz of the state's leaves as ``leaf_<i>``
(a tree's leaves in JAX's order: tuples and lists in order, dicts by sorted
key) plus ``__meta__``, a JSON object as uint8 bytes, written atomically
(tmp file + ``os.replace``).  No pickle.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Callable

import numpy as np
import torch

from tpusparse_torch.solve.cg import ConvergedReason, cg


def _leaves(tree) -> list:
    """The leaves of a tree of tuples, lists and dicts, in JAX's order."""
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    return [tree]


def _rebuild(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, leaves) for v in template)
    if isinstance(template, dict):
        built = {key: _rebuild(template[key], leaves) for key in sorted(template)}
        return {key: built[key] for key in template}
    return next(leaves)


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_pytree(path: str | os.PathLike, tree, meta: dict | None = None) -> pathlib.Path:
    """Atomically write a tree's leaves (tensors or numbers) and JSON-able
    metadata to npz."""
    path = pathlib.Path(path)
    arrays = {f"leaf_{i}": _host(v) for i, v in enumerate(_leaves(tree))}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    tmp = path.with_suffix(path.suffix + ".tmp")
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic on POSIX
    return path


def load_pytree(path: str | os.PathLike, template):
    """Load leaves saved by ``save_pytree`` into ``template``'s structure:
    a tensor leaf of the template comes back as a tensor of its dtype on
    its device, a number as a number of its type.  Returns (tree, meta)."""
    with np.load(pathlib.Path(path)) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode() or "{}")
        flat = _leaves(template)
        saved = [z[f"leaf_{i}"] for i in range(len(flat))]

    def restore(v, t):
        if isinstance(t, torch.Tensor):
            return torch.as_tensor(v).to(dtype=t.dtype, device=t.device)
        return type(t)(v.item()) if isinstance(t, (int, float)) else v

    return _rebuild(template, iter([restore(v, t) for v, t in zip(saved, flat)])), meta


@dataclasses.dataclass
class CheckpointConfig:
    path: str | os.PathLike
    every: int = 50             # iterations between snapshots
    keep_history: bool = False  # also write path.it<N> copies


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a tensor dtype ("float64"): the JAX package's
    ``str(b.dtype)``, so that both packages fingerprint alike."""
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def cg_checkpointed(
    a_mv: Callable,
    b: torch.Tensor,
    cfg: CheckpointConfig,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 10000,
    m_mv: Callable | None = None,
    resume: bool = True,
):
    """CG with periodic solver-state snapshots and automatic resume.

    Runs ``cg`` in chunks of ``cfg.every`` iterations; after each chunk the
    Krylov state is snapshotted to ``cfg.path`` with the global iteration
    count.  If ``resume`` and the file exists, the solve continues from the
    saved state instead of zero; ``maxiter`` bounds the global count.
    Convergence stays global (||r|| <= max(rtol*||b||, atol) on the
    iteration's residual, as ``cg``).  Returns ``(result, iterations)``,
    ``result.iters`` the global count.
    """
    path = pathlib.Path(cfg.path)
    # the state template: cg's (x, r, z, p, rz, rnorm, it)
    zeros = torch.zeros_like(b)
    scalar = torch.zeros((), dtype=b.dtype, device=b.device)
    template = (zeros, zeros, zeros, zeros, scalar, scalar, 0)
    # problem fingerprint: resuming a checkpoint written for different
    # tolerances or a different rhs would continue from an incompatible
    # Krylov state
    ident = {
        "rtol": float(rtol), "atol": float(atol),
        "shape": list(b.shape), "dtype": _dtype_name(b.dtype),
        "b_norm2": torch.dot(b.reshape(-1), b.reshape(-1)).item(),
    }
    state = None
    done = 0  # global iterations; the state's own counter is chunk-relative
    if resume and path.exists():
        state, meta = load_pytree(path, template)

        def mismatch(key):
            if meta.get(key) is None:
                return False  # a checkpoint without a fingerprint: nothing to check
            if key == "b_norm2":  # last-ulp rounding of another backend is fine
                return abs(meta[key] - ident[key]) > 1e-10 * max(abs(ident[key]), 1)
            return meta[key] != ident[key]

        if any(mismatch(key) for key in ident):
            saved = {key: meta.get(key) for key in ident}
            raise ValueError(
                f"checkpoint {path} was written for a different problem or"
                f" tolerances (saved {saved}, current {ident}); delete it or"
                f" pass resume=False to restart"
            )
        done = int(meta.get("iters", 0))
        state = state[:6] + (0,)

    while True:
        res, state = cg(
            a_mv, b, rtol=rtol, atol=atol, maxiter=min(cfg.every, maxiter - done), m_mv=m_mv,
            state0=state, return_state=True,
        )
        done += res.iters
        state = state[:6] + (0,)
        save_pytree(path, state, {"iters": done, **ident})
        if cfg.keep_history:
            save_pytree(path.with_suffix(path.suffix + f".it{done}"), state, {"iters": done})
        if res.reason > 0 or res.reason == ConvergedReason.DIVERGED_NANORINF:
            break
        if done >= maxiter:
            break  # the global budget is spent (DIVERGED_ITS)
        # otherwise the chunk's budget ran out: go on from the state
    res = dataclasses.replace(res, iters=done)
    return res, done

"""Run a function on W gloo ranks, each a fresh Python process on the CPU
(``OMP_NUM_THREADS=1``), joined through a ``file://`` store (no port to
race for).  Each rank calls
``tpusparse_torch.dist.multihost.initialize``, the function, then
``finalize``; its JSON result comes back through a file.  A rank that
fails or outlives ``timeout`` fails the run, and every rank left is
killed: a rank that raises never leaves its peers blocked past it.

The functions the rank tests run live here too, so that a rank imports
torch and the port only.
"""

from __future__ import annotations

import datetime
import importlib
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

TESTS = Path(__file__).resolve().parent


def _entry(fn: str, rank: int, world: int, tmp: str, kwargs: dict) -> None:
    import torch

    torch.set_num_threads(1)
    from tpusparse_torch.dist import multihost

    out = Path(tmp) / f"rank{rank}.json"
    try:
        multihost.initialize(init_method=f"file://{tmp}/store", world_size=world, rank=rank, device="cpu",
                             timeout=datetime.timedelta(seconds=60))
        mod, name = fn.rsplit(":", 1)
        result = getattr(importlib.import_module(mod), name)(**kwargs)
        out.write_text(json.dumps(result))
    except BaseException:
        out.with_suffix(".err").write_text(traceback.format_exc())
        raise
    finally:
        multihost.finalize()


def run_ranks(fn: str, world: int, tmp_path, timeout: float = 60.0, **kwargs) -> list:
    """``fn`` ("module:function") on ``world`` gloo ranks: each rank's
    result, in rank order."""
    tmp = Path(tmp_path) / f"ranks{world}_{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(TESTS.parent), str(TESTS), os.environ.get("PYTHONPATH", "")])}
    env.pop("WORLD_SIZE", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", "import sys, json, torch_ranks; torch_ranks._entry(*json.loads(sys.argv[1]))",
             json.dumps([fn, r, world, str(tmp), kwargs])],
            env=env, cwd=str(tmp), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        for r in range(world)
    ]
    deadline = time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {r} of {world} still running after {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(5)
    failed = {r: p.returncode for r, p in enumerate(procs) if p.returncode != 0}
    if failed:
        errs = "\n".join((tmp / f"rank{r}.err").read_text() for r in failed if (tmp / f"rank{r}.err").exists())
        raise AssertionError(f"ranks {failed} (rank: exit code) failed:\n{errs}")
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]


# --- what the ranks run ----------------------------------------------------------

def solve(n=(12, 12, 24), **kw) -> dict:
    """``solve_poisson`` on this rank: the report's numbers, its route, and
    the kernel launches (none on the CPU)."""
    from tpusparse_torch import kernels
    from tpusparse_torch.amg.hierarchy import AMGParams
    from tpusparse_torch.bench.driver import solve_poisson

    if "amg_params" in kw:
        kw["amg_params"] = AMGParams(**kw["amg_params"])
    kernels.reset_launches()
    rep = solve_poisson(*n, device="cpu", **kw)
    return dict(
        iters=rep.iters, outer=rep.outer_iters, reason=rep.reason, linf=rep.linf_error, resnorm=rep.resnorm,
        route=rep.sharded_route, mesh=rep.mesh, ranks=rep.ranks, launches=sum(kernels.LAUNCHES.values()),
    )


def describe() -> dict:
    from tpusparse_torch.dist import multihost

    return multihost.describe()


def halo(shape, mesh_shape, pinned=True, dtype="float32") -> dict:
    """This rank's slab of the halo apply of a seeded field, and the whole
    field's star apply, as lists."""
    import numpy as np
    import torch

    from tpusparse_torch.dist.halo import HaloStar
    from tpusparse_torch.dist.mesh import make_mesh
    from tpusparse_torch.grid.grid3d import Grid3D
    from tpusparse_torch.grid.poisson import poisson_stencil_device

    dt = getattr(torch, dtype)
    nz, ny, nx = shape
    op = poisson_stencil_device(Grid3D(nx, ny, nz), dtype=dt, device="cpu")[0]
    if not pinned:
        op.pinned = False
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(shape)).to(dt)
    mesh = make_mesh(mesh_shape[0] * mesh_shape[1], tuple(mesh_shape), "cpu")
    hs = HaloStar.build(op, mesh)
    y = hs.mv(mesh.local(x))
    return dict(rows=[mesh.rows(nz).start, mesh.rows(nz).stop], y=y.double().flatten().tolist(),
                want=op.mv(x)[mesh.rows(nz)].double().flatten().tolist())


def fail_on_rank1() -> dict:
    """Rank 1 raises; rank 0 waits in an all-reduce that never completes."""
    import torch
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return {}


def cli(argv) -> dict:
    """The port's CLI on this rank (it uses the group the rank joined): its
    exit code and what it printed."""
    import contextlib
    import io

    from tpusparse_torch.__main__ import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return dict(rc=rc, out=out.getvalue())


def solve_each(cases) -> list:
    """``solve`` for each of ``cases`` (a list of option dicts) on this
    rank, in one process."""
    return [solve(**kw) for kw in cases]

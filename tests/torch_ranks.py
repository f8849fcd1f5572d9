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


def _band_matrix(n=512, reach=150, seed=5):
    """The multi-hop matrix of the JAX package's
    ``test_dist_dia_bands_span_multiple_shards``: bands at 0, +-1 and +-150."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    return sp.diags(
        [rng.standard_normal(n - reach), rng.standard_normal(n), rng.standard_normal(n - reach),
         rng.standard_normal(n - 1), rng.standard_normal(n - 1)],
        [-reach, 0, reach, 1, -1],
    ).tocsr()


# (grid, AMGParams fields) of ``general``'s solves: all levels sharded; a
# rank's rows cutting a plane (4.5 planes a rank on 2 ranks); a level kept
# whole between two sharded ones; block-Jacobi levels and the dense coarse
# inverse on sharded levels (blocks of 12 across the ranks' rows)
GENERAL_CASES = (
    ((16, 16, 16), dict(coarse_eq_limit=64)),
    ((9, 8, 8), dict(coarse_eq_limit=64)),
    ((14, 14, 14), dict(coarse_eq_limit=8)),
    ((12, 12, 12), dict(coarse_eq_limit=64, bjacobi_bs=12, coarse_solve="lu")),
)


def general(cases=GENERAL_CASES, p=4, transfer_format="auto", min_shard_rows=1, dtype="float64",
            rtol=1e-8) -> dict:
    """On this rank: the block-row sharded CG + GAMG on the Poisson matrix
    of each (grid, AMGParams fields) of ``cases``
    (``shard_unstructured_hierarchy`` over ``make_row_mesh(p)``), the
    multi-hop ``DistDIA`` apply of ``_band_matrix`` and the
    ``DistHybridDIA`` apply of ``_hybrid_matrix``: the rank's rows of each
    x and y, the counts, and what each level became."""
    import numpy as np
    import torch

    from tpusparse_torch.amg.hierarchy import AMGParams, vcycle
    from tpusparse_torch.amg.unstructured import gamg_setup_unstructured
    from tpusparse_torch.dist.general import (
        DistDIA,
        DistHybridDIA,
        _shard_ell_rows,
        make_row_mesh,
        shard_unstructured_hierarchy,
        shard_vector,
    )
    from tpusparse_torch.grid.grid3d import Grid3D
    from tpusparse_torch.grid.poisson import assemble_poisson
    from tpusparse_torch.solve.cg import cg
    from tpusparse_torch.sparse.dia import DIA, HybridDIA

    mesh = make_row_mesh(p, device="cpu")
    solves = []
    for (nz, ny, nx), params in cases:
        a, b, _ = assemble_poisson(Grid3D(nx, ny, nz))
        hier = gamg_setup_unstructured(a, AMGParams(**params), dtype=getattr(np, dtype),
                                       transfer_format=transfer_format, device="cpu")
        hs = shard_unstructured_hierarchy(hier, mesh, min_shard_rows=min_shard_rows)
        bb = torch.as_tensor(b).to(hier.levels[0].dinv.dtype)
        with mesh.reductions(bb.numel()):
            res = cg(hs.levels[0].op.mv, shard_vector(bb, mesh), rtol=rtol, maxiter=300,
                     m_mv=lambda r: vcycle(hs, r))
        rows = mesh.rows(bb.numel())
        solves.append(dict(rows=[rows.start, rows.stop], x=res.x.tolist(), iters=res.iters, reason=res.reason,
                           levels=[f"{type(lev.op).__name__}/{type(lev.transfer).__name__}"
                                   f"{'/bjac' if lev.bjac is not None else ''}"
                                   f"{'/lu' if lev.coarse_inv is not None else ''}" for lev in hs.levels]))
    band = _band_matrix()
    dd = DistDIA.shard(DIA.from_csr(band, device="cpu"), mesh)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(band.shape[0]))
    hyb = HybridDIA.from_csr(_hybrid_matrix(), max_bands=8, device="cpu")
    dh = DistHybridDIA(dia=DistDIA.shard(hyb.dia, mesh), rem=_shard_ell_rows(hyb.rem, mesh))
    xh = torch.from_numpy(np.random.default_rng(6).standard_normal(hyb.shape[0]))
    return dict(solves=solves, halo=dd.halo, y=dd.mv(shard_vector(x, mesh)).tolist(),
                yh=dh.mv(shard_vector(xh, mesh)).tolist())


def _hybrid_matrix(n=8 * 48):
    """The matrix of the JAX package's ``test_dist_hybrid_dia_matches_host``."""
    import scipy.sparse as sp

    s = sp.random(n, n, density=0.02, random_state=7, format="csr")
    return (s + s.T + 10 * sp.identity(n)).tocsr()

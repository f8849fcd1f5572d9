"""CG + GAMG on the n^3 Poisson aij matrix over the block-row executor
(``dist/general.py``): the hierarchy sharded over a row mesh, in one
process or on torchrun's ranks.  The JAX package drives the same from
``__graft_entry__._dryrun_unstructured``; neither package's CLI reaches
it."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tpusparse_torch.amg.hierarchy import AMGParams, vcycle
from tpusparse_torch.amg.unstructured import gamg_setup_unstructured
from tpusparse_torch.dist import multihost
from tpusparse_torch.dist.general import make_row_mesh, shard_unstructured_hierarchy
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import assemble_poisson
from tpusparse_torch.solve.cg import cg


def main(argv=None) -> int:
    """CG + GAMG on the n^3 Poisson aij matrix over the row mesh (the JAX
    package's ``__graft_entry__._dryrun_unstructured``), in one process or
    on the ranks of torchrun's group (rank 0 prints):

        python -m tpusparse_torch.bench.general 16 --blocks 4 --device cpu
        python -m torch.distributed.run --standalone --nproc-per-node 2 \\
            -m tpusparse_torch.bench.general 16 --blocks 4 --device cpu
    """
    ap = argparse.ArgumentParser(description=main.__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n", type=int, nargs="?", default=16, help="grid edge")
    ap.add_argument("--blocks", type=int, default=None, help="row blocks (default: one a rank)")
    ap.add_argument("--min-shard-rows", type=int, default=4096)
    ap.add_argument("--precision", choices=["f64", "f32"], default="f64", help="CG rtol 1e-8 (f64), 1e-6 (f32)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    joined = not torch.distributed.is_initialized()
    multihost.initialize(device=args.device)
    try:
        device = multihost.rank_device(args.device)
        a, b, exact = assemble_poisson(Grid3D(args.n, args.n, args.n))
        dtype = np.float64 if args.precision == "f64" else np.float32
        hier = gamg_setup_unstructured(a, AMGParams(), dtype=dtype, device=device)
        mesh = make_row_mesh(args.blocks, device=device)
        hs = shard_unstructured_hierarchy(hier, mesh, min_shard_rows=args.min_shard_rows)
        b = mesh.local(torch.as_tensor(b, device=device).to(hier.levels[0].dinv.dtype))
        rtol = 1e-8 if args.precision == "f64" else 1e-6
        mesh.barrier()
        t0 = time.perf_counter()
        with mesh.reductions(args.n ** 3):
            res = cg(hs.levels[0].op.mv, b, rtol=rtol, maxiter=500, m_mv=lambda r: vcycle(hs, r))
            err = torch.as_tensor(exact, device=device)[mesh.rows(args.n ** 3)] - res.x.double()
            linf = mesh.allreduce(err.abs().max(), "max").item()
        secs = time.perf_counter() - t0
        if mesh.rank == 0:
            print(f"{args.n}^3 on a row mesh of {mesh.p} blocks over {mesh.world} rank(s) ({device}):"
                  f" levels {[f'{type(lev.op).__name__} {lev.op.shape[0]}' for lev in hs.levels]}")
            print(f"{res.iters} iterations, reason {res.reason}, Linf {linf:.6e}, {secs:.4f} s")
        return 0 if res.reason > 0 else 1
    finally:
        if joined:
            multihost.finalize()


if __name__ == "__main__":
    raise SystemExit(main())

"""SpMV microbenchmark — per-card GB/s and nnz/s (BASELINE.json's metric,
"SpMV GB/s + nnz/s per chip").  Port of ``tpusparse/bench/spmv.py``.

Times every storage form of the 7-point Poisson operator that the port
holds, each row against the traffic models of ``utils/metrics.py``:

- ``stencil7_mv_{n}^3_{dt}``: ``StarStencil3D.mv``, kernel K1p
  (``star7_mv``) on f32 fields on the card, plain torch otherwise;
  ``stencil_mv_traffic``;
- ``stencil7_cuda_resident_{n}^3_f32`` (f32 on the card only):
  ``PaddedStar.mv``, kernel K1 (``star7_mv_padded``) on the padded-resident
  layout; ``stencil_mv_traffic`` (the true cells, not the pads);
- ``dia{K}_mv_{n}^3_{dt}`` where ``DIA.mv`` runs plain torch (f64, or any
  dtype on the CPU): K band reads, K shifted x streams and the y write,
  (2K + 1) n bytes of a value; ``diaband_cuda{K}_mv_{n}^3_f32`` in its
  place in f32 on the card, where ``DIA.mv`` launches kernel K5
  (``dia_mv``), which reads x once: (K + 2) n;
- ``ell8_mv_{n}^3_{dt}``: ``ELL.mv``, torch gathers, at every size;
  ``ell_mv_traffic`` (its 4-byte indices and every gather of x: the
  port's indices are int64, so the model is a floor of what moves).

On the CPU the rows, their flop, byte and nnz counts and their order are
the JAX package's on its CPU.  The host CSR (``assemble_poisson``, about
190M nonzeros at 300^3) is assembled once in f64; the f32 containers hold
its values cast to f32 (``main`` hands the one assembly to both dtypes).
Each row chains ``reps`` applies from b (``utils/metrics.py::
chain_seconds``); in f32 the chain overflows after a few applies, as in
the JAX package: the time does not depend on the values.

    python -m tpusparse_torch.bench.spmv [N] [reps] [--device cpu]

prints ``KernelStats.line()`` for every row, f32 then f64.  It needs a CUDA
device unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import assemble_poisson, poisson_stencil_device
from tpusparse_torch.sparse.dia import DIA
from tpusparse_torch.sparse.ell import ELL
from tpusparse_torch.sparse.padded import PaddedStar, pad_field
from tpusparse_torch.utils.metrics import (
    KernelStats,
    chain_seconds,
    ell_mv_traffic,
    spmv_flops,
    stencil_mv_traffic,
)


@dataclasses.dataclass
class Row:
    """One benchmark row: the container whose ``mv`` it times, its input
    and its counts.  ``kernel``: the ``kernels.LAUNCHES`` name of the
    hand-written kernel that ``op.mv(x)`` launches, or None (plain torch)."""

    name: str
    op: object
    x: torch.Tensor
    flops: int
    bytes: int
    nnz: int
    kernel: str | None = None


def _dt_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def rows(n: int = 300, dtype=torch.float64, device="cuda", system=None) -> list[Row]:
    """The rows at ``n``^3 in ``dtype`` on ``device``, in the JAX package's
    order.  ``system``: ``assemble_poisson(Grid3D(n, n, n))`` in f64, if
    the caller holds it."""
    grid = Grid3D(n, n, n)
    vb = torch.empty((), dtype=dtype).element_size()
    dt = _dt_name(dtype)
    f32_card = torch.device(device).type == "cuda" and dtype == torch.float32
    out = []

    # stencil form
    op, b, _ = poisson_stencil_device(grid, dtype=dtype, device=device)
    nnz7 = 7 * grid.n - 2 * (  # interior entries actually stored
        grid.ny * grid.nz + grid.nx * grid.nz + grid.nx * grid.ny
    )
    stencil = dict(flops=spmv_flops(nnz7, grid.n), bytes=stencil_mv_traffic(grid.n, vb), nnz=nnz7)
    out.append(Row(f"stencil7_mv_{n}^3_{dt}", op, b, kernel="star7_mv" if f32_card else None, **stencil))

    # the padded-resident form (the card in f32: K1, the reference's step-4
    # analog)
    if f32_card:
        out.append(Row(f"stencil7_cuda_resident_{n}^3_f32", PaddedStar.from_star(op), pad_field(b),
                       kernel="star7_mv_padded", **stencil))

    # the general-matrix forms over the host CSR
    a, bh, _ = system if system is not None else assemble_poisson(grid)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    x = torch.as_tensor(bh.astype(np_dt), device=device)
    dia = DIA.from_csr(a, dtype=np_dt, device=device)
    k = len(dia.offsets)
    general = dict(flops=spmv_flops(a.nnz, grid.n), nnz=a.nnz)
    if f32_card:
        # K5 reads each band and x once (its halo tail) and writes y
        out.append(Row(f"diaband_cuda{k}_mv_{n}^3_f32", dia, x, bytes=(k + 2) * grid.n * vb,
                       kernel="dia_mv", **general))
    else:
        # plain torch: K band reads + K shifted x streams + y write
        out.append(Row(f"dia{k}_mv_{n}^3_{dt}", dia, x, bytes=(2 * k + 1) * grid.n * vb, **general))

    ell = ELL.from_csr(a, width=8, dtype=np_dt, device=device)
    out.append(Row(f"ell8_mv_{n}^3_{dt}", ell, x, bytes=ell_mv_traffic(grid.n, 8, vb), **general))
    return out


def bench_op(name, fn, *args, flops, bytes_, nnz, reps=20) -> KernelStats:
    """Time ``reps`` chained applications ``v -> fn(op, v)`` from ``x``
    (``args`` = (op, x)): seconds an apply, from the median chain."""
    return KernelStats(name=name, seconds=chain_seconds(fn, args, reps), flops=flops, bytes=bytes_, nnz=nnz)


def bench_rows(rs: list[Row], reps: int = 20) -> list[KernelStats]:
    return [
        bench_op(r.name, lambda o, x: o.mv(x), r.op, r.x, flops=r.flops, bytes_=r.bytes, nnz=r.nnz, reps=reps)
        for r in rs
    ]


def run(n: int = 300, reps: int = 20, dtype=torch.float64, device="cuda", system=None) -> list[KernelStats]:
    """Every row at ``n``^3 in ``dtype`` on ``device``, timed."""
    return bench_rows(rows(n, dtype, device, system), reps)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n", nargs="?", type=int, default=300)
    ap.add_argument("reps", nargs="?", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spmv on cuda needs a CUDA device (--device cpu runs it on the host)")
    system = assemble_poisson(Grid3D(args.n, args.n, args.n))
    for dtype in (torch.float32, torch.float64):
        for s in run(args.n, args.reps, dtype, args.device, system):
            print(s.line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Timing, flop and byte accounting — port of ``tpusparse/utils/metrics.py``,
the reference's observability layer.

Parity targets: the 3-phase ``PetscTime`` breakdown (``src/main_ksp.cpp:
80-106``), ``PetscLogFlops`` kernel accounting (the SpMV flop model
``2*nz - nonzerorows`` logged at ``src/openacc-step4/MatMult_SeqAIJ.patch``,
context line 98), and the roofline numbers BASELINE.json demands (achieved
GB/s and nnz/s per chip).  Everything but ``chain_seconds`` is pure Python
and equals the JAX package's.

``chain_seconds`` is the port's timer of the bench entries (``bench/spmv.py``,
``bench/bwprobe.py``).  The JAX package chains ``reps`` applications inside
one jitted ``fori_loop``; eager PyTorch has nothing to elide, so the port
chains them in Python and times whole chains: with CUDA events on a CUDA
tensor, with the host clock on a CPU tensor.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch


class PhaseTimer:
    """Named wall-time phases; ``PetscTime`` bracket parity."""

    def __init__(self):
        self.phases: dict[str, float] = {}
        self._t0: float | None = None
        self._name: str | None = None

    def start(self, name: str) -> "PhaseTimer":
        self._name, self._t0 = name, time.perf_counter()
        return self

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.phases[self._name] = self.phases.get(self._name, 0.0) + dt
        self._name = self._t0 = None
        return dt

    def __enter__(self):
        if self._name is None:  # the JAX package's assert, kept under -O
            raise AssertionError("call start(name) first")
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def spmv_flops(nnz: int, nonzero_rows: int | None = None) -> int:
    """PETSc's MatMult flop model: 2*nnz - (rows with any nonzero)
    (one multiply per entry, adds = entries - rows)."""
    if nonzero_rows is None:
        nonzero_rows = 0
    return 2 * nnz - nonzero_rows


def ell_mv_traffic(n_rows: int, width: int, val_bytes: int, idx_bytes: int = 4):
    """Minimum HBM traffic of a padded-ELL SpMV, in bytes.

    vals + cols read once, x gathered (counted once per entry — the
    pessimistic bound; caching may reduce it), y written once.
    """
    return (
        n_rows * width * (val_bytes + idx_bytes)   # vals + cols
        + n_rows * width * val_bytes               # x gathers (upper bound)
        + n_rows * val_bytes                       # y write
    )


def stencil_mv_traffic(n_cells: int, val_bytes: int, n_coef_fields: int = 1):
    """Minimum HBM traffic of a stencil SpMV: x read, coefficient field(s)
    read, y written.  Shifted reads of x hit the same cache lines, so x
    counts once — this is why the stencil form beats ELL by ~7x on a
    7-point operator."""
    return n_cells * val_bytes * (2 + n_coef_fields)


@dataclasses.dataclass
class KernelStats:
    """Achieved rates for one timed kernel."""

    name: str
    seconds: float
    flops: int
    bytes: int
    nnz: int

    @property
    def gflops(self) -> float:
        return self.flops / self.seconds / 1e9

    @property
    def gb_s(self) -> float:
        return self.bytes / self.seconds / 1e9

    @property
    def nnz_per_s(self) -> float:
        return self.nnz / self.seconds

    def line(self) -> str:
        return (
            f"{self.name}: {self.seconds*1e3:.3f} ms  "
            f"{self.gb_s:.1f} GB/s  {self.gflops:.1f} GFLOP/s  "
            f"{self.nnz_per_s/1e9:.2f} Gnnz/s"
        )


def chain_seconds(fn, args, reps: int, chains: int = 5) -> float:
    """Seconds a step: ``v = fn(*args[:-1], v)`` chained ``reps`` times from
    ``v = args[-1]``, after one synced warm-up chain; the median over
    ``chains`` chains of the chain's time over ``reps``.  The device is
    ``args[-1]``'s: CUDA events there, the host clock on the CPU."""
    head, x = args[:-1], args[-1]
    cuda = x.device.type == "cuda"

    def chain():
        v = x
        for _ in range(reps):
            v = fn(*head, v)
        return v

    chain()
    if cuda:
        torch.cuda.synchronize(x.device)
    times = []
    for _ in range(chains):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            chain()
            times.append(time.perf_counter() - t0)
    return statistics.median(times) / reps

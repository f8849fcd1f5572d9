"""Utilities of the port: timing, flop and byte accounting (``metrics.py``)
and profiling (``profiling.py``)."""

from tpusparse_torch.utils.metrics import (
    KernelStats,
    PhaseTimer,
    ell_mv_traffic,
    spmv_flops,
    stencil_mv_traffic,
)

__all__ = [
    "PhaseTimer",
    "KernelStats",
    "spmv_flops",
    "ell_mv_traffic",
    "stencil_mv_traffic",
]

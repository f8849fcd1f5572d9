"""Structured smoothed-aggregation multigrid."""

from tpusparse_torch.amg.hierarchy import (
    AMGParams,
    Hierarchy,
    cast_hierarchy,
    gamg_setup,
    vcycle,
    wcycle,
)

__all__ = [
    "AMGParams",
    "Hierarchy",
    "cast_hierarchy",
    "gamg_setup",
    "vcycle",
    "wcycle",
]

"""Krylov solvers, mixed-precision defect correction, block solves and
checkpoints — the exports of ``tpusparse/solve/__init__.py`` but for the
two that are not to port (``cg_hostloop``, ``cg_refined_tf``)."""

from tpusparse_torch.solve.bcgs import bicgstab
from tpusparse_torch.solve.bjacobi import BlockJacobi
from tpusparse_torch.solve.cg import CGResult, ConvergedReason, cg
from tpusparse_torch.solve.chebyshev import chebyshev
from tpusparse_torch.solve.checkpoint import CheckpointConfig, cg_checkpointed
from tpusparse_torch.solve.fgmres import fgmres
from tpusparse_torch.solve.gmres import gmres
from tpusparse_torch.solve.minres import minres
from tpusparse_torch.solve.multi import MultiResult, cg_multi, refined_multi
from tpusparse_torch.solve.pipelined import cg_pipelined
from tpusparse_torch.solve.refine import RefinedResult, cg_refined
from tpusparse_torch.solve.simple import preonly, richardson
from tpusparse_torch.solve.spectrum import ritz_values

__all__ = [
    "cg",
    "cg_pipelined",
    "gmres",
    "fgmres",
    "minres",
    "ritz_values",
    "bicgstab",
    "chebyshev",
    "cg_refined",
    "cg_checkpointed",
    "cg_multi",
    "refined_multi",
    "MultiResult",
    "richardson",
    "preonly",
    "BlockJacobi",
    "CGResult",
    "ConvergedReason",
    "RefinedResult",
    "CheckpointConfig",
]

"""The z-sharded fine level on one device: ``mesh`` (the z mesh), ``seam``
(the shard-by-shard level-0 transfer) and ``fused_sharded`` (the fused
kernels once per z-shard) — port of the single-controller part of
``tpusparse/dist``.  Several devices and processes are ROADMAP queue 12."""

from tpusparse_torch.dist.fused_sharded import (
    FusedSharded,
    fused_sharded_supported,
    vcycle_fused_sharded,
)
from tpusparse_torch.dist.mesh import ZMesh, check_divisible, make_z_mesh
from tpusparse_torch.dist.seam import ShardedTransfer

__all__ = [
    "FusedSharded",
    "ShardedTransfer",
    "ZMesh",
    "check_divisible",
    "fused_sharded_supported",
    "make_z_mesh",
    "vcycle_fused_sharded",
]

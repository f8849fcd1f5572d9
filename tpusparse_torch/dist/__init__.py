"""The split solve: ``multihost`` (the ranks' bring-up over
``torch.distributed``), ``mesh`` (the (z, y) mesh of blocks over the ranks,
its exchanges and placement), ``halo`` (the star apply with its halo
exchange, kernel K1h), ``seam`` (the level-0 transfer block by block) and
``fused_sharded`` (the fused kernels on the rank's z-slabs) — port of
``tpusparse/dist`` but for the general block-row executor
(``dist/general.py``, ROADMAP queue 12)."""

from tpusparse_torch.dist.fused_sharded import (
    FusedSharded,
    fused_sharded_supported,
    vcycle_fused_sharded,
)
from tpusparse_torch.dist.halo import HaloStar, halo_mv
from tpusparse_torch.dist.mesh import (
    Mesh,
    check_divisible,
    make_mesh,
    make_z_mesh,
    shard_hierarchy,
    shard_system,
)
from tpusparse_torch.dist.seam import ShardedTransfer

__all__ = [
    "FusedSharded",
    "HaloStar",
    "Mesh",
    "ShardedTransfer",
    "check_divisible",
    "fused_sharded_supported",
    "halo_mv",
    "make_mesh",
    "make_z_mesh",
    "shard_hierarchy",
    "shard_system",
    "vcycle_fused_sharded",
]

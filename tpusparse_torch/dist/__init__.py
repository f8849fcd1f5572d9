"""The split solve: ``multihost`` (the ranks' bring-up over
``torch.distributed``), ``mesh`` (the (z, y) mesh of blocks over the ranks,
its exchanges and placement), ``halo`` (the star apply with its halo
exchange, kernel K1h), ``seam`` (the level-0 transfer block by block),
``fused_sharded`` (the fused kernels on the rank's z-slabs) and
``general`` (the block-row executor for general matrices: ``DistDIA`` on
kernel K5h, ``DistHybridDIA``, the sharded unstructured hierarchy) — port
of ``tpusparse/dist``."""

from tpusparse_torch.dist.fused_sharded import (
    FusedSharded,
    fused_sharded_supported,
    vcycle_fused_sharded,
)
from tpusparse_torch.dist.general import (
    DistDIA,
    DistHybridDIA,
    RowMesh,
    make_row_mesh,
    shard_unstructured_hierarchy,
    shard_vector,
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
    "DistDIA",
    "DistHybridDIA",
    "FusedSharded",
    "HaloStar",
    "Mesh",
    "RowMesh",
    "ShardedTransfer",
    "check_divisible",
    "fused_sharded_supported",
    "halo_mv",
    "make_mesh",
    "make_row_mesh",
    "make_z_mesh",
    "shard_hierarchy",
    "shard_system",
    "shard_unstructured_hierarchy",
    "shard_vector",
    "vcycle_fused_sharded",
]

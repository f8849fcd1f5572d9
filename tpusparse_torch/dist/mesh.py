"""The z mesh of the sharded fine level — the part of
``tpusparse/dist/mesh.py`` that one device needs.

The JAX package shards a solve over a ``('z', 'y')`` device mesh and runs
the fused fine level per z-shard (``tpusparse/dist/fused_sharded.py``).  Its
sharded route is single-controller: the JAX tests run it on 8 virtual CPU
devices in one process.  The port's counterpart is a 1-D z mesh of ``p``
shards that all live on ONE device: each shard is a z-slab of the grid, and
the halo exchange is a copy of planes between slabs.  A mesh over several
devices, and the (z, y) mesh of the JAX package's GSPMD routes, are ROADMAP
queue 12 (``torch.distributed``).

``shard_system`` and ``shard_hierarchy`` are not ported: on one device
they would place nothing.
"""

from __future__ import annotations

import dataclasses

import torch

from tpusparse_torch.kernels.stencil7 import FACE


@dataclasses.dataclass(frozen=True)
class ZMesh:
    """``p`` z-shards of a grid, all on ``device``."""

    p: int
    device: torch.device


def make_z_mesh(n_shards: int, device) -> ZMesh:
    """A 1-D z mesh of ``n_shards`` shards on one device.  A list of devices
    (a mesh over several cards) raises ``NotImplementedError``."""
    if isinstance(device, (list, tuple)):
        raise NotImplementedError(
            "a z mesh over several devices is not ported to tpusparse_torch yet"
            " (ROADMAP queue 12: torch.distributed)"
        )
    if n_shards < 1:
        raise ValueError(f"a z mesh needs at least one shard, got {n_shards}")
    return ZMesh(p=int(n_shards), device=torch.device(device))


def check_divisible(field_shape, mesh: ZMesh) -> None:
    """DMDA-style validation (``tpusparse/dist/mesh.py:79-87``, z only):
    nz must divide into the mesh's shards, and each shard must hold at
    least FACE planes, the depth of the halo its neighbours read."""
    nz = field_shape[0]
    if nz % mesh.p:
        raise ValueError(
            f"grid nz={nz} not divisible by {mesh.p} z-shards; choose a shard"
            f" count that divides nz"
        )
    if nz // mesh.p < FACE:
        raise ValueError(
            f"{mesh.p} z-shards of nz={nz} hold {nz // mesh.p} planes each, fewer"
            f" than the {FACE} halo planes a neighbour reads"
        )

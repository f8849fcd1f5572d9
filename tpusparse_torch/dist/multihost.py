"""Bring-up of the ranks of a split solve — port of
``tpusparse/dist/multihost.py`` on ``torch.distributed``.

The reference launches N MPI ranks with ``aprun -n N`` and brackets its
run in ``MPI_Init``/``MPI_Finalize`` (``src/main_ksp.cpp:70-71,138-139``);
the JAX package runs one process a host under ``jax.distributed``, which
joins them into one GSPMD program.  The port's counterpart is PETSc's own:
one process a rank under ``torch.distributed``, launched by torchrun,

    python -m torch.distributed.run --standalone --nproc-per-node W \\
        -m tpusparse_torch -devices p ...

which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; ``initialize`` reads them (or takes an
explicit ``init_method``, such as a ``file://`` store), and the split
solve (``dist/mesh.py``) runs on the default process group.

The backend follows where the ranks sit, never a caught failure: CPU
ranks take gloo; one card a rank takes NCCL; ranks that share a card take
gloo, since NCCL refuses two ranks on one GPU, and their CUDA planes and
partials then travel through host copies (``Mesh.exchange`` /
``Mesh.allreduce``).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=300)


def pick_backend(device, local_world: int) -> str:
    """gloo for CPU ranks and for ranks that share a card, NCCL for one
    card a rank."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def rank_device(device) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for a CUDA
    request, the CPU for a CPU one."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def initialize(init_method: str | None = None, world_size: int | None = None, rank: int | None = None,
               device="cuda", backend: str | None = None, timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the process group (idempotent): True when this process is in
    one afterwards.  Without an ``init_method`` and without torchrun's
    ``WORLD_SIZE`` it does nothing and returns False.  Every group is made
    with ``timeout``, so a rank whose peer died raises instead of hanging;
    no exception is swallowed."""
    if dist.is_initialized():
        return True
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return False
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    device = rank_device(device)
    backend = backend or pick_backend(device, local_world)
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size, rank=rank, timeout=timeout,
    )
    return True


def describe() -> dict:
    """Topology summary for rank-0 logging (``multihost.py:78-88``)."""
    on = dist.is_initialized()
    world = dist.get_world_size() if on else 1
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": world,
        "local_devices": count,
        "global_devices": count * hosts,
        "device_kind": torch.cuda.get_device_name(0) if count else "cpu",
        "backend": dist.get_backend() if on else None,
    }


def finalize() -> None:
    """Leave and destroy the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()

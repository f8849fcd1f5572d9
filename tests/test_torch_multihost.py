"""The ranks' bring-up (``dist/multihost.py``) and the halo exchange on
gloo ranks: ``initialize`` without an environment, the backend and device
picked from where the ranks sit, ``describe`` on 2 ranks, a failed rank
failing the run instead of hanging it, K1h's twin on the blocks of 2 and 4
ranks bit for bit the global star apply (one-plane blocks in z and in y
among them), and the CLI on 2 ranks (rank 0 alone prints).

Each rank is a fresh process on the CPU (``tests/torch_ranks.py``: a
``file://`` store under ``tmp_path``, OMP_NUM_THREADS=1); every run ends
within its time limit or fails.  The solves on ranks are in
``test_torch_ranks_solve.py``.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpusparse_torch.dist import multihost
from torch_ranks import run_ranks


def test_initialize_without_an_environment_is_a_no_op(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert not dist.is_initialized()
    multihost.finalize()
    info = multihost.describe()
    assert (info["process_index"], info["process_count"], info["backend"]) == (0, 1, None)


def test_backend_and_device_follow_placement(monkeypatch):
    """gloo on the CPU and where ranks share a card, NCCL with one card a
    rank; a rank's card is LOCAL_RANK modulo the cards."""
    assert multihost.pick_backend("cpu", 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert multihost.pick_backend("cuda", 4) == "nccl"
    assert multihost.pick_backend("cuda", 8) == "gloo"
    monkeypatch.setenv("LOCAL_RANK", "6")
    assert multihost.rank_device("cuda") == torch.device("cuda", 2)
    assert multihost.rank_device("cuda:1") == torch.device("cuda", 1)
    assert multihost.rank_device("cpu") == torch.device("cpu")


def test_describe_on_two_ranks(tmp_path):
    info = run_ranks("torch_ranks:describe", 2, tmp_path)
    assert [(i["process_index"], i["process_count"], i["backend"]) for i in info] == [(0, 2, "gloo"), (1, 2, "gloo")]


def test_a_failed_rank_fails_the_run_and_its_peer_is_killed(tmp_path):
    with pytest.raises(AssertionError, match="rank 1 fails on purpose|still running"):
        run_ranks("torch_ranks:fail_on_rank1", 2, tmp_path, timeout=20)


@pytest.mark.parametrize("world, mesh_shape", [(2, (2, 4)), (4, (8, 1)), (4, (4, 2))])
def test_halo_apply_on_ranks_is_the_global_star(tmp_path, world, mesh_shape):
    """Each rank's slab of the halo apply, its boundary planes exchanged
    with ranks r +- 1: bit for bit the global star apply's rows."""
    got = run_ranks("torch_ranks:halo", world, tmp_path, shape=(8, 4, 6), mesh_shape=mesh_shape)
    assert [r["rows"] for r in got] == [[8 // world * i, 8 // world * (i + 1)] for i in range(world)]
    for r in got:
        assert np.array_equal(np.array(r["y"]), np.array(r["want"]))


def test_cli_on_two_ranks_prints_on_rank_0_only(tmp_path):
    argv = ["-da_grid_x", "12", "-da_grid_y", "12", "-da_grid_z", "24", "-devices", "4", "-layout", "plain",
            "-ksp_rtol", "1e-6", "-device", "cpu"]
    got = run_ranks("torch_ranks:cli", 2, tmp_path, argv=argv)
    assert [r["rc"] for r in got] == [0, 0] and got[1]["out"] == ""
    assert '"ranks": 2' in got[0]["out"] and '"mesh": [2, 2]' in got[0]["out"]
    with pytest.raises(AssertionError, match="W | p"):
        run_ranks("torch_ranks:cli", 2, tmp_path, argv=[*argv[:6], "-devices", "3", "-device", "cpu"])


def test_chip_smoke_rank_records_come_back_in_files(tmp_path, monkeypatch):
    """``chip_smoke.py``'s torchrun phase: the ranks share one stdout pipe,
    where one rank's write can land inside another's line, so each rank's
    launches and strokes come back in a file of its own; stdout holds rank
    0's report alone (one JSON sidecar), and the records' directory is
    removed."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    argv = ["-da_grid_x", "12", "-da_grid_y", "12", "-da_grid_z", "24", "-devices", "4", "-ksp_converged_reason",
            "-device", "cpu"]
    side, ranks, _wall = smoke._rank_run(2, argv, scratch=str(tmp_path))
    assert (side["ranks"], side["z_shards"], side["reason"]) == (2, 4, 2)
    assert [r["rank"] for r in ranks] == [0, 1]
    assert ranks[0]["strokes"] == ranks[1]["strokes"] and ranks[0]["strokes"]["descent"] > 0
    assert list(tmp_path.iterdir()) == []

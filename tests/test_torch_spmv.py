"""``tpusparse_torch.bench.spmv`` and ``bench.bwprobe`` on the CPU against
the JAX package's ``tpusparse.bench.spmv`` and ``bench/bwprobe.py``: the
same rows in the same order with the same flop, byte and nnz counts, one
apply of each storage form equal to the JAX package's container on the same
numpy system, and the probe's rows and byte counts.  On the CPU every
container runs plain torch; ``test_torch_cuda.py`` holds the kernel rows
(K1, K1p, K5) against their twins on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.bench import spmv as j_spmv
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import assemble_poisson as j_assemble_poisson
from tpusparse.grid.poisson import poisson_stencil as j_poisson_stencil
from tpusparse.sparse.dia import DIA as JDIA
from tpusparse.sparse.ell import ELL as JELL
from tpusparse_torch import kernels
from tpusparse_torch.bench import bwprobe, spmv
from tpusparse_torch.kernels.stencil7 import padded_shape
from tpusparse_torch.sparse.csr import HostCSR

DTYPES = [(torch.float32, jnp.float32, np.float32, 1e-6), (torch.float64, jnp.float64, np.float64, 1e-12)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("dtype, jdtype, _np, _tol", DTYPES)
def test_rows_match_jax(dtype, jdtype, _np, _tol):
    """``run(16, reps=2)``: JAX's row names, flops, bytes and nnz, in its
    order, and finite positive times; no kernel launched (CPU tensors)."""
    kernels.reset_launches()
    got = spmv.run(16, reps=2, dtype=dtype, device="cpu")
    want = j_spmv.run(16, 2, jdtype)
    assert [(s.name, s.flops, s.bytes, s.nnz) for s in got] == [(s.name, s.flops, s.bytes, s.nnz) for s in want]
    assert [s.name.split("_")[0] for s in got] == ["stencil7", "dia7", "ell8"]
    assert all(np.isfinite(s.seconds) and s.seconds > 0 for s in got)
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("dtype, jdtype, np_dt, tol", DTYPES)
def test_one_apply_matches_jax(dtype, jdtype, np_dt, tol):
    """Each row's ``op.mv(x)`` on the JAX package's numpy system against
    the JAX container of that form on the same x: f64 to 1e-12 and f32 to
    1e-6 of max|y|."""
    grid = JGrid3D(16, 16, 16)
    ja, bh, exact = j_assemble_poisson(grid)
    system = (HostCSR(ja.indptr, ja.indices, ja.data, ja.shape), bh, exact)
    rs = spmv.rows(16, dtype, "cpu", system)
    want_ops = {
        "stencil7": j_poisson_stencil(grid, dtype=jnp.dtype(jdtype).type)[0],
        "dia7": JDIA.from_csr(ja, dtype=np_dt),
        "ell8": JELL.from_csr(ja, width=8, dtype=np_dt),
    }
    assert [r.name.split("_")[0] for r in rs] == list(want_ops)
    for r in rs:
        x = r.x.numpy()
        assert x.dtype == np_dt
        want = np.asarray(want_ops[r.name.split("_")[0]].mv(jnp.asarray(x)))
        got = r.op.mv(r.x).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), r.name


def test_rows_share_one_assembly():
    """Passed one f64 system, both dtypes take its values: the f32
    containers hold them cast."""
    system = spmv.assemble_poisson(spmv.Grid3D(8, 8, 8))
    r32 = spmv.rows(8, torch.float32, "cpu", system)
    r64 = spmv.rows(8, torch.float64, "cpu", system)
    assert torch.equal(r32[1].op.bands, r64[1].op.bands.float())
    assert torch.equal(r32[2].op.vals, r64[2].op.vals.float()) and torch.equal(r32[2].op.cols, r64[2].op.cols)


def test_spmv_main_prints_a_line_a_row(capsys):
    assert spmv.main(["8", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == [
        f"{f}_8^3_{dt}" for dt in ("float32", "float64") for f in ("stencil7_mv", "dia7_mv", "ell8_mv")
    ]
    assert all("GB/s" in line and "Gnnz/s" in line for line in lines)


@pytest.mark.parametrize("main, argv", [
    (spmv.main, []), (bwprobe.main, []),
])
def test_cuda_request_without_a_card_raises(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(argv)


# --- bwprobe -----------------------------------------------------------------

def test_bwprobe_rows_match_jax_and_count_bytes():
    """The JAX package's rows, names and pass counts at a few MB, every
    row's bytes its passes times its field's size."""
    probes = bwprobe.run((1, 2), ((6, 5, 4),), 1, device="cpu", reps=2, chains=2)
    names = [p.name for p in probes]
    assert names == [
        f"{row} ({mb} MB, {k}-pass)" for mb in (1, 2) for row, k in (
            ("copy-ish x+1", 2), ("axpy a+1.5x", 3), ("triad a+b*x", 4), ("reduce sum", 1))
    ] + ["axpy 3-D (6, 5, 4) (3-pass)", "axpy bf16 (1 MB, 3-pass)"]
    mib = 1024 * 1024
    sizes = [mb * mib for mb in (1, 2) for _ in range(4)] + [6 * 5 * 4 * 4, mib]
    assert [p.passes for p in probes] == [2, 3, 4, 1] * 2 + [3, 3]
    for p, size in zip(probes, sizes):
        assert p.size == size and p.bytes == p.passes * size
        assert np.isfinite(p.seconds) and p.seconds > 0 and p.gb_s > 0
    best = bwprobe.ceiling(probes)
    assert sorted(best) == [2, 3, 4]
    assert best[3] == max(p.gb_s for p in probes if p.passes == 3)


def test_bwprobe_shapes_are_the_ports_padded_layout():
    """The 3-D rows: the padded 300^3 field of the port's layout (not the
    TPU's (306, 304, 384)) and the plain one."""
    assert bwprobe.SHAPES == ((306, 300, 300), (300, 300, 300)) == (padded_shape((300, 300, 300)), (300, 300, 300))
    assert bwprobe.SIZES_MB == (64, 143, 512) and bwprobe.BF16_MB == 512


def test_bwprobe_steps_compute_their_rows(monkeypatch):
    """Each row's step is the JAX row's function (x + 1, c + 1.5 x,
    c + d x, sum x) in one PyTorch call, so it moves its pass count."""
    seen = []

    def record(fn, args, reps, chains):
        seen.append(fn(*args))
        return 1.0

    monkeypatch.setattr(bwprobe, "chain_seconds", record)
    bwprobe.run((1,), (), 1, device="cpu")
    a = torch.ones(1024 * 1024 // (4 * 512), 512)
    torch.testing.assert_close(seen[0], a + 1)
    torch.testing.assert_close(seen[1], 2 * a + 1.5 * a)
    torch.testing.assert_close(seen[2], 2 * a + 3 * a * a)
    assert seen[3].item() == a.sum().item()
    a16 = torch.ones(1024 * 1024 // (2 * 512), 512, dtype=torch.bfloat16)
    torch.testing.assert_close(seen[4], 2 * a16 + 1.5 * a16)


def test_bwprobe_summary_names_the_ceiling_and_the_device():
    probes = bwprobe.run((1,), (), 1, device="cpu", reps=2, chains=1)
    line = bwprobe.summary(probes, "cpu")
    assert line.startswith("measured ceiling: 2-pass ") and line.endswith("; cpu")
    assert "published" not in line   # the H100's rate is no yardstick for the host

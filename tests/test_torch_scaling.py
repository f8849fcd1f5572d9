"""``tpusparse_torch.bench.scaling`` and ``bench.plots`` against the JAX
package's, and the aij headline entry against ``bench_aij.py``.

The sweeps run over z-shards of one device (the port's z-sharded route):
``run_strong`` / ``run_weak`` at 12 a side over 1, 2 and 4 shards with
``layout="padded"`` against the JAX package's own sweeps of the same
route at the same grids (each inner count within 2, Linf within 1e-6 +
1e-3 of JAX's, the gate of ``test_torch_sharded.py``); the efficiency
forms and ``comm_model``'s volume terms equal to JAX's, its efficiency
equal once JAX's link constants are put in; the record's keys JAX's less
``hlo_validation``; both figures from a port record and from the JAX
package's own ``runs/scaling_strong.json``; and ``headline --aij
[--nodetect]`` with ``bench_aij.py``'s metric names and JAX's counts."""

import json
import pathlib

import numpy as np
import pytest
import torch

from tpusparse.bench import scaling as j_scaling
from tpusparse.bench.driver import solve_poisson as j_solve_poisson
from tpusparse.dist.mesh import _factor2 as j_factor2
from tpusparse_torch.bench import headline, plots, scaling

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHARDS = [1, 2, 4]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def sweeps():
    """{mode: (port points, JAX points)} at 12 a side over ``SHARDS``."""
    out = {}
    for mode in ("strong", "weak"):
        got = getattr(scaling, f"run_{mode}")(12, SHARDS, layout="padded", device="cpu")
        want = getattr(j_scaling, f"run_{mode}")(12, SHARDS, layout="padded")
        out[mode] = (got, want)
    return out


def _pts(mod, rows):
    return [mod.ScalingPoint(*r) for r in rows]


# (n_devices, nx, ny, nz, t_solve, iters, linf, nnz): a weak sweep's shape
ROWS = [
    (1, 64, 64, 64, 0.21, 30, 1e-3, scaling._poisson_nnz(64, 64, 64)),
    (2, 64, 64, 128, 0.33, 33, 1e-3, scaling._poisson_nnz(64, 64, 128)),
    (4, 64, 128, 128, 0.52, 31, 1e-3, scaling._poisson_nnz(64, 128, 128)),
    (8, 64, 128, 256, 0.97, 38, 1e-3, scaling._poisson_nnz(64, 128, 256)),
]


def test_factor2_and_nnz_match_jax():
    for n in range(1, 65):
        assert scaling._factor2(n) == j_factor2(n)
    for shape in ((12, 12, 12), (64, 128, 256), (3, 1, 7)):
        assert scaling._poisson_nnz(*shape) == j_scaling._poisson_nnz(*shape)


def test_reference_line_and_rates_match_jax():
    for got, want in zip(_pts(scaling, ROWS), _pts(j_scaling, ROWS)):
        assert scaling._reference_line(got) == j_scaling._reference_line(want)
        assert got.nnz_per_s == want.nnz_per_s


@pytest.mark.parametrize("weak", [False, True])
def test_efficiency_matches_jax(weak):
    got, want = _pts(scaling, ROWS), _pts(j_scaling, ROWS)
    assert scaling.efficiency(got, weak) == j_scaling.efficiency(want, weak)
    assert scaling.tts_efficiency(got) == j_scaling.tts_efficiency(want)


def test_comm_model_volume_terms_match_jax():
    got = scaling.comm_model(_pts(scaling, ROWS), 7e-3)
    want = j_scaling.comm_model(_pts(j_scaling, ROWS), 7e-3)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("n_devices", "mesh", "halo_bytes_per_iter", "coarse_seam_bytes_per_iter", "psums_per_iter"):
            assert g[key] == w[key], key


def test_comm_model_takes_jax_efficiency_with_jax_constants(monkeypatch):
    """The formula is JAX's: with JAX's v5e link constants in place of the
    H100's, every projected term and efficiency is JAX's."""
    monkeypatch.setitem(scaling.MODEL, "link_bytes_per_s", j_scaling.MODEL["ici_bytes_per_s"])
    monkeypatch.setitem(scaling.MODEL, "psum_latency_s", j_scaling.MODEL["psum_latency_s"])
    got = scaling.comm_model(_pts(scaling, ROWS), 7e-3)
    want = j_scaling.comm_model(_pts(j_scaling, ROWS), 7e-3)
    assert got == want


def test_model_carries_the_h100_link_and_names_its_sources():
    """NVLink's 900 GB/s bidirectional (450 a direction), not the v5e ICI;
    the latency a stated assumption; the rest of JAX's model as it is."""
    assert scaling.MODEL["link_bytes_per_s"] == 4.5e11 != j_scaling.MODEL["ici_bytes_per_s"]
    assert "ici_bytes_per_s" not in scaling.MODEL
    assert set(scaling.MODEL_SOURCES) == {"link_bytes_per_s", "psum_latency_s"}
    assert "900 GB/s" in scaling.MODEL_SOURCES["link_bytes_per_s"]
    assert "assumption" in scaling.MODEL_SOURCES["psum_latency_s"]
    for key in ("fine_applies_per_iter", "psums_per_iter", "sharded_levels", "coarsen_ratio"):
        assert scaling.MODEL[key] == j_scaling.MODEL[key]


@pytest.mark.parametrize("mode", ["strong", "weak"])
@pytest.mark.parametrize("i", range(len(SHARDS)))
def test_sweep_point_matches_jax(sweeps, mode, i):
    """The point at ``SHARDS[i]`` z-shards: JAX's grid and nnz, inner within
    2 of JAX's sweep, Linf within 1e-6 + 1e-3 of it."""
    got, want = sweeps[mode][0][i], sweeps[mode][1][i]
    assert (got.n_devices, got.nx, got.ny, got.nz, got.nnz) == (want.n_devices, want.nx, want.ny, want.nz, want.nnz)
    assert abs(got.iters - want.iters) <= 2
    assert abs(got.linf_error - want.linf_error) < 1e-6 + 1e-3 * abs(want.linf_error)
    assert np.isfinite(got.t_solve) and got.t_solve > 0


@pytest.mark.parametrize("mode", ["strong", "weak"])
def test_record_keys_match_jax(sweeps, mode, tmp_path):
    """``save_json``: the keys of the JAX package's record
    (``runs/scaling_{mode}.json``) less ``hlo_validation``, ``emulated``
    true, the backend the device's type; the weak projection names its
    constants' sources."""
    path = tmp_path / f"torch_scaling_{mode}.json"
    scaling.save_json(sweeps[mode][0], mode, path, backend="cpu")
    rec = json.loads(path.read_text())
    jax_rec = json.loads((ROOT / "runs" / f"scaling_{mode}.json").read_text())
    assert list(rec) == [k for k in jax_rec if k != "hlo_validation"]
    assert rec["emulated"] is True and rec["backend"] == "cpu"
    assert [set(p) for p in rec["points"]] == [set(jax_rec["points"][0])] * len(SHARDS)
    assert list(rec["efficiency"]) == [str(d) for d in SHARDS]
    if mode == "weak":
        assert set(rec["projection_model"]) == set(scaling.MODEL) | {"t_iter_1dev_s", "sources"}
        assert [set(p) for p in rec["projection"]] == [set(p) for p in jax_rec["projection"][:len(SHARDS)]]


def test_point_outside_the_route_raises_naming_queue_12():
    """A point off the fused z route (uniform f64 here), refused as queue
    12 before the (z, y) route was ported, runs there; a point whose options
    the JAX driver refuses with n_devices > 1 raises in its words."""
    pts = scaling.run_strong(12, [1, 2], precision="f64", device="cpu")
    assert [p.n_devices for p in pts] == [1, 2] and abs(pts[0].iters - pts[1].iters) <= 1
    with pytest.raises(NotImplementedError, match="single-device"):
        scaling.run_strong(12, [2], pc="sor", device="cpu")


def test_scaling_main_writes_its_own_record(tmp_path, monkeypatch, capsys):
    """The CLI on the CPU: the reference lines, the efficiencies and the
    record at the default ``runs/torch_scaling_strong.json`` (never the JAX
    package's ``runs/scaling_strong.json``)."""
    monkeypatch.chdir(tmp_path)
    assert scaling.main(["strong", "--n", "12", "--devices", "1,2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "1 Devices [12x12x12]" in out and "2 Devices [12x12x12]" in out and "2 devices: efficiency" in out
    rec = json.loads((tmp_path / "runs" / "torch_scaling_strong.json").read_text())
    assert [p["n_devices"] for p in rec["points"]] == [1, 2] and rec["emulated"] is True
    assert not (tmp_path / "runs" / "scaling_strong.json").exists()


@pytest.mark.parametrize("main, argv", [
    (scaling.main, ["strong"]), (headline.main, ["--aij"]),
])
def test_cuda_request_without_a_card_raises(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(argv)


# --- plots -------------------------------------------------------------------

@pytest.mark.parametrize("source", ["port", "jax"])
def test_plots_render_both_figures(sweeps, source, tmp_path):
    """Both PNGs (> 1 kB) from a port record and from the JAX package's own
    ``runs/scaling_strong.json`` (one format)."""
    path = ROOT / "runs" / "scaling_strong.json"
    if source == "port":
        path = tmp_path / "torch_scaling_strong.json"
        scaling.save_json(sweeps["strong"][0], "strong", path, backend="cpu")
    rec = plots.load(path)
    for fig, name in ((plots.plot_scaling, "strong_scaling.png"), (plots.plot_efficiency, "scaling_efficiency.png")):
        out = fig([rec], tmp_path / source / name)
        assert out.read_bytes()[:4] == b"\x89PNG" and out.stat().st_size > 1024


def test_plots_main_writes_under_results_torch(sweeps, tmp_path, monkeypatch, capsys):
    """The default ``--out`` is ``results/torch/``: the JAX package's
    figures in ``results/`` stay as they are."""
    rec_path = tmp_path / "torch_scaling_weak.json"
    scaling.save_json(sweeps["weak"][0], "weak", rec_path, backend="cpu")
    monkeypatch.chdir(tmp_path)
    assert plots.main([str(rec_path), str(ROOT / "runs" / "scaling_weak.json")]) == 0
    for name in ("strong_scaling.png", "scaling_efficiency.png"):
        assert (tmp_path / "results" / "torch" / name).stat().st_size > 1024
        assert not (tmp_path / "results" / name).exists()


# --- the aij headline entry (bench_aij.py) -----------------------------------

@pytest.mark.parametrize("detect", [True, False])
def test_aij_headline_takes_bench_aij_names_and_jax_counts(detect, capsys):
    """``headline --aij [--nodetect] 16``: one JSON line on stdout whose
    metric is ``bench_aij.py``'s (its f-string, read from the script), the
    report on stderr; the solve takes the JAX package's counts."""
    src = (ROOT / "bench_aij.py").read_text()
    assert 'f"poisson{N}_aij{tag}_cg_gamg_solve_s"' in src and 'tag = "" if detect else "_nodetect"' in src
    tag = "" if detect else "_nodetect"
    argv = ["--aij", "16"] + ([] if detect else ["--nodetect"])
    assert headline.main(argv, device="cpu") == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == f"poisson16_aij{tag}_cg_gamg_solve_s" and line["unit"] == "s"
    assert line["vs_baseline"] == pytest.approx(headline.BASELINE_SOLVE_S / line["value"])
    assert "[Nx, Ny, Nz]: [16, 16, 16]" in err
    rep, _ = headline.run(16, device="cpu", mat_type="aij", structure_detect=detect)
    want = j_solve_poisson(16, rtol=1e-8, atol=1e-12, pc="gamg", mat_type="aij", structure_detect=detect)
    assert (rep.reason, rep.outer_iters) == (want.reason, want.outer_iters) == (2, 2)
    assert abs(rep.iters - want.iters) <= 1
    assert abs(rep.linf_error - want.linf_error) < 1e-6


def test_nodetect_needs_aij():
    with pytest.raises(SystemExit):
        headline.main(["--nodetect", "16"], device="cpu")

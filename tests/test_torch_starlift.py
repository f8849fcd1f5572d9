"""Structure detection (``sparse/starlift.py``) and the lifted aij route of
the port against the JAX package's on the CPU: the proof and its refusals,
the lifted fields bitwise equal to JAX's ``star_lift`` on the same bands,
the driver's lifted solve against the port's own stencil solve (the same
route: padded, where the JAX driver on the CPU goes plain), and the
uniform-precision lifted solves against the JAX driver's."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from tpusparse.__main__ import main as j_main
from tpusparse.bench.driver import solve_poisson as j_solve_poisson
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import assemble_poisson as j_assemble_poisson
from tpusparse.grid.poisson import poisson_dia_device as j_poisson_dia_device
from tpusparse.sparse.dia import DIA as JDIA
from tpusparse.sparse.starlift import star_lift as j_star_lift
from tpusparse_torch.__main__ import main
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import (
    assemble_poisson,
    poisson_dia_device,
    poisson_stencil,
    poisson_stencil_device,
)
from tpusparse_torch.interop import dfdia_from_numpy, dia_from_numpy
from tpusparse_torch.sparse import dia as dia_module
from tpusparse_torch.sparse.dia import DFDIA, DIA
from tpusparse_torch.sparse.starlift import star_lift
from tpusparse_torch.sparse.stencil import StarStencil3D

KW = dict(rtol=1e-8, atol=1e-12, device="cpu", warmup=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _x(shape, seed, dtype=torch.float64):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(dtype)


def test_lift_device_assembly_matches_structured_oracle():
    """The device-assembled two-float system lifts; its f64 operator is
    the host oracle's, bit for bit, and its f32 twin within 1e-6."""
    grid = Grid3D(12, 10, 8)
    op_hi, op_lo, _, _ = poisson_dia_device(grid, device="cpu")
    lifted = star_lift(op_lo, op_hi, grid.shape)
    assert lifted is not None
    star_hi, star_lo = lifted
    assert isinstance(star_hi, StarStencil3D) and star_hi.pinned and star_lo.pinned
    assert star_hi.dtype == torch.float64 and star_lo.dtype == torch.float32
    op_ref = poisson_stencil(grid, dtype=np.float64, device="cpu")[0]
    x = _x(grid.shape, 0)
    assert torch.equal(star_hi.mv(x), op_ref.mv(x))
    want = op_ref.mv(x)
    rel = (star_lo.mv(x.float()).double() - want).abs().max() / want.abs().max()
    assert rel < 1e-6


@pytest.mark.parametrize("n", [12, 16, 24])
def test_lifted_fine_operator_is_the_stencil_routes(n):
    """The lifted f32 operator (the f32-rounded f64 sum) against the
    stencil route's (``poisson_stencil_device`` in f32, its diagonal summed
    in f32): bitwise equal on the cube at these sizes, so both routes run
    the same inner solves.  ``chip_smoke.py`` checks 300^3 on the card."""
    grid = Grid3D(n, n, n)
    op_hi, op_lo, _, _ = poisson_dia_device(grid, device="cpu")
    _, star_lo = star_lift(op_lo, op_hi, grid.shape)
    ref = poisson_stencil_device(grid, dtype=torch.float32, device="cpu")[0]
    assert torch.equal(star_lo.diag, ref.diag)
    assert (star_lo.cx, star_lo.cy, star_lo.cz) == (ref.cx, ref.cy, ref.cz)


def test_lift_host_f64_and_anisotropic_extent():
    grid = Grid3D(8, 6, 10, lx=1.0, ly=2.0, lz=0.5)
    a, _, _ = assemble_poisson(grid, dtype=np.float64)
    d = DIA.from_csr(a, device="cpu")
    lifted = star_lift(d, d, grid.shape)
    assert lifted is not None
    star_hi, star_lo = lifted
    assert star_lo is star_hi  # uniform precision shares the container
    op_ref = poisson_stencil(grid, dtype=np.float64, device="cpu")[0]
    x = _x(grid.shape, 1)
    assert torch.equal(star_hi.mv(x), op_ref.mv(x))


def _host_dia(n=8):
    grid = Grid3D(n, n, n)
    a, _, _ = assemble_poisson(grid, dtype=np.float64)
    return grid, DIA.from_csr(a, device="cpu")


def _with_bands(d, bands, offsets=None):
    return DIA(bands=bands, offsets=offsets or d.offsets, shape=d.shape)


@pytest.mark.parametrize("case", ["variable_leg", "wrap_nonzero", "missing_legs", "asymmetric_legs"])
def test_lift_refuses_non_star_matrices(case):
    grid, d = _host_dia()
    k1 = d.offsets.index(1)
    bands = d.bands.clone()
    if case == "variable_leg":
        bands[k1, 100] *= 1.0 + 1e-7
    elif case == "wrap_nonzero":
        # i = nx - 1: the star's zero fill would drop it, so the proof must refuse
        bands[k1, 7] = 3.0
    elif case == "asymmetric_legs":
        km1 = d.offsets.index(-1)
        bands[km1] = torch.where(bands[km1] != 0, bands[km1] * 2.0, bands[km1])
    if case == "missing_legs":
        v = _with_bands(d, bands[:5], d.offsets[:5])
    else:
        v = _with_bands(d, bands)
    assert star_lift(v, v, grid.shape) is None


@pytest.mark.parametrize("assembly", ["device", "host64", "host32"])
def test_lifted_fields_match_jax_star_lift(assembly):
    """Both packages' ``star_lift`` on the same numpy bands: the lifted
    diag (f64 and f32), legs and pin bitwise equal."""
    grid, jgrid = Grid3D(9, 7, 6), JGrid3D(9, 7, 6)
    if assembly == "device":
        jh, jl, _, _ = j_poisson_dia_device(jgrid)
        op_hi = dfdia_from_numpy(
            np.asarray(jh.hi), None if jh.lo is None else np.asarray(jh.lo), jh.offsets,
            jh.shape, device="cpu",
        )
        op_lo = DIA(bands=op_hi.hi, offsets=op_hi.offsets, shape=op_hi.shape)
    else:
        dt = np.float64 if assembly == "host64" else np.float32
        a, _, _ = j_assemble_poisson(jgrid, dtype=dt)
        jh = jl = JDIA.from_csr(a)
        op_hi = op_lo = dia_from_numpy(np.asarray(jh.bands), jh.offsets, jh.shape, device="cpu")
    want = j_star_lift(jl, jh, jgrid.shape)
    got = star_lift(op_lo, op_hi, grid.shape)
    assert want is not None and got is not None
    for w, g in zip(want, got):
        assert g.pinned == w.pinned
        assert g.diag.numpy().dtype == np.asarray(w.diag).dtype
        np.testing.assert_array_equal(g.diag.numpy(), np.asarray(w.diag))
        for leg in ("cx", "cy", "cz"):
            assert getattr(g, leg) == float(np.asarray(getattr(w, leg))), leg


@pytest.fixture(scope="module")
def lifted_and_stencil():
    return solve_poisson(16, mat_type="aij", view=True, **KW), solve_poisson(16, **KW)


def test_aij_driver_lifts_to_structured_iteration_parity(lifted_and_stencil):
    """The lifted aij solve takes the port's stencil route: exactly its
    counts, its Linf to 1e-10."""
    aij, stencil = lifted_and_stencil
    assert "star DETECTED" in aij.solver_view
    assert "layout: padded-resident (fused fine level)" in aij.solver_view
    assert set(aij.setup_breakdown) == {"star_lift", "hierarchy_build"}
    assert (aij.iters, aij.outer_iters, aij.reason) == (stencil.iters, stencil.outer_iters, 2)
    np.testing.assert_allclose(aij.linf_error, stencil.linf_error, rtol=1e-10)
    assert aij.mat_type == "aij"
    assert json.loads(aij.json_sidecar())["setup_breakdown"]["star_lift"] >= 0.0


def _counting_dia_mv(monkeypatch):
    calls = []
    real = dia_module.dia_mv

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(dia_module, "dia_mv", counted)
    return calls


@pytest.mark.parametrize("detect", [False, True])
def test_structure_detect_chooses_the_route(monkeypatch, detect):
    """``structure_detect=False`` keeps the structure-blind route: the
    solve applies ``DIA.mv`` (K5's wrapper) and prints no detection; the
    default lifts, and the solve never applies a DIA."""
    calls = _counting_dia_mv(monkeypatch)
    rep = solve_poisson(12, mat_type="aij", structure_detect=detect, view=True, **KW)
    assert rep.reason == 2
    assert ("star DETECTED" in rep.solver_view) == detect
    assert ("mat_type: aij (DIA/HybridDIA containers)" in rep.solver_view) == (not detect)  # JAX's words
    assert (len(calls) == 0) == detect
    assert ("star_lift" in rep.setup_breakdown) == detect


def test_aij_host_assembly_also_lifts():
    """The two-float system assembled on the host (``assemble_poisson``,
    uploaded through ``DFDIA.from_host_bands``) lifts to the device
    assembly's star, bit for bit."""
    grid = Grid3D(16, 16, 16)
    a, _, _ = assemble_poisson(grid)
    bands64, offsets, shape = DIA.host_bands(a)
    op_hi = DFDIA.from_host_bands(bands64, offsets, shape, device="cpu")
    host = star_lift(DIA(bands=op_hi.hi, offsets=offsets, shape=shape), op_hi, grid.shape)
    dev_hi, dev_lo, _, _ = poisson_dia_device(grid, device="cpu")
    dev = star_lift(dev_lo, dev_hi, grid.shape)
    assert host is not None and dev is not None
    for h, d in zip(host, dev):
        assert h.pinned == d.pinned and h.dtype == d.dtype
        assert torch.equal(h.diag, d.diag)
        assert (h.cx, h.cy, h.cz) == (d.cx, d.cy, d.cz)


@pytest.mark.parametrize(
    "precision, rtol, linf_abs",
    [("f64", 1e-8, 1e-10), ("f32", 1e-6, 2e-5)],
)
def test_uniform_lifted_solves_match_jax(precision, rtol, linf_abs):
    """``-precision f64|f32 -mat_type aij``: the host assembly lifted onto
    the plain route in that dtype, in both packages at 12^3."""
    kw = dict(rtol=rtol, atol=1e-12, mat_type="aij", precision=precision, view=True)
    want = j_solve_poisson(12, warmup=False, **kw)
    got = solve_poisson(12, device="cpu", warmup=False, **kw)
    for rep in (want, got):
        assert "star DETECTED" in rep.solver_view and "layout: plain" in rep.solver_view
    assert got.reason == want.reason == 2
    assert got.outer_iters == 0 and got.mat_type == "aij"
    assert abs(got.iters - want.iters) <= 1
    assert abs(got.linf_error - want.linf_error) < linf_abs


def _cli(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fn(argv) == 0
    text = out.getvalue()
    side = [line for line in text.splitlines() if line.startswith("JSON: ")]
    assert len(side) == 1
    return text, json.loads(side[0][len("JSON: "):])


def test_aij_through_the_cli():
    """``-mat_type aij`` through both CLIs at 8^3: detected in both, the
    same reason, sweeps and Linf to 1e-6; the port's lifted solve takes its
    own ``-mat_type stencil`` counts exactly.  (At 8^3 and 10^3 the two
    packages' inner counts differ on the stencil route itself, 19 / 14 at
    8^3: the second sweep follows the first one's rounding, ROADMAP section 3.)"""
    argv = ["-da_grid_x", "8", "-da_grid_y", "8", "-da_grid_z", "8", "-ksp_rtol", "1e-8",
            "-ksp_atol", "1e-12", "-ksp_view"]
    wtext, want = _cli(j_main, [*argv, "-mat_type", "aij"])
    text, got = _cli(main, [*argv, "-mat_type", "aij", "-device", "cpu"])
    _, stencil = _cli(main, [*argv, "-device", "cpu"])
    assert "star DETECTED" in wtext and "star DETECTED" in text
    assert (got["reason"], got["outer_iters"], got["mat_type"]) == (want["reason"], want["outer_iters"], "aij")
    assert (got["iters"], got["outer_iters"]) == (stencil["iters"], stencil["outer_iters"])
    assert got["linf_error"] == pytest.approx(want["linf_error"], abs=1e-6)
    assert "star_lift" in got["setup_breakdown"]

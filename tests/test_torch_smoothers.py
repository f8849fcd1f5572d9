"""The plain-layout options of the structured GAMG and the standalone PCs:
multicolor SOR (``gs_color_masks``), block Jacobi (``flat_band_fields``,
``BlockJacobi``, ``PCRLineJacobi``), the dense LU coarse solve, and
``-pc_type jacobi|sor|none``, each against the JAX package: the pieces on
equal inputs, the cycles on a shared hierarchy, and 24^3 solves through
both packages' CLIs (``-device cpu`` here).

Tolerances: masks and band fields exactly (same arithmetic); inverted
blocks and the dense coarse inverse at rtol 1e-4 (f32 vs f32 LU, or f64
then cast); cycles at rtol 1e-5, atol 1e-6 of their range; solves with the
reason and outer sweeps equal, inner within 1 and Linf within 1e-8.  The
weak standalone PCs' 140-280 f32 CG iterations on the pinned operator
follow the dots' summation order (at 24^3 the port takes 280 with
``-pc_type none`` on one CPU thread, as JAX does, and 201 on two), so this
file runs on one thread; the card's tests keep a wider window.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import port_copy

from tpusparse.__main__ import main as j_main
from tpusparse.amg.geo import gamg_setup_geo as j_gamg_setup_geo
from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.amg.hierarchy import dense_coarse_inverse as j_dense_coarse_inverse
from tpusparse.amg.hierarchy import gamg_setup as j_gamg_setup
from tpusparse.amg.hierarchy import vcycle as j_vcycle
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import poisson_dia_device as j_poisson_dia_device
from tpusparse.grid.poisson import poisson_stencil_device as j_poisson_stencil_device
from tpusparse.solve.bjacobi import BlockJacobi as JBlockJacobi
from tpusparse.solve.bjacobi import PCRLineJacobi as JPCRLineJacobi
from tpusparse.sparse.varstencil import VarStencil27 as JVarStencil27
from tpusparse_torch.__main__ import main
from tpusparse_torch.amg.hierarchy import (
    DENSE_COARSE_CAP,
    AMGParams,
    dense_coarse_inverse,
    gamg_setup,
    vcycle,
)
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil_device
from tpusparse_torch.interop import dia_from_numpy, star_from_numpy
from tpusparse_torch.solve.bjacobi import BlockJacobi, PCRLineJacobi
from tpusparse_torch.sparse.varstencil import VarStencil27


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stars(nx, ny, nz, pinned=True):
    jop = j_poisson_stencil_device(JGrid3D(nx, ny, nz), dtype=np.float32)[0]
    jop = dataclasses.replace(jop, pinned=pinned)
    op = star_from_numpy(np.asarray(jop.diag), jop.cx, jop.cy, jop.cz, pinned, device="cpu")
    return jop, op


def _var27(shape, seed=1):
    coef = np.random.default_rng(seed).standard_normal((27, *shape)).astype(np.float32)
    return JVarStencil27(coef=jnp.asarray(coef)), VarStencil27(coef=torch.tensor(coef))


@pytest.mark.parametrize("shape", [(6, 5, 7), (2, 3, 2)])
def test_gs_color_masks_match(shape):
    nz, ny, nx = shape
    jop, op = _stars(nx, ny, nz)
    for got, want in zip(op.gs_color_masks(), jop.gs_color_masks(), strict=True):
        np.testing.assert_array_equal(got.expand(shape).numpy(), np.asarray(want))
    jv, pv = _var27(shape)
    for got, want in zip(pv.gs_color_masks(), jv.gs_color_masks(), strict=True):
        np.testing.assert_array_equal(got.expand(shape).numpy(), np.asarray(want))


@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("max_abs_offset", [2, 8, 36, 1000])
def test_flat_band_fields_match(max_abs_offset, pinned):
    """Exact bands of the star (pinned row and column masked in) and of a
    27-point operator, including a grid with nx = 2 where 3-D offsets
    alias to one flat offset."""
    jop, op = _stars(7, 5, 6, pinned)
    for shape, ops in (((6, 5, 7), (jop, op)), ((3, 4, 2), _var27((3, 4, 2))), ((6, 5, 7), _var27((6, 5, 7), 2))):
        want = ops[0].flat_band_fields(max_abs_offset)
        got = ops[1].flat_band_fields(max_abs_offset)
        assert sorted(got) == sorted(want)
        for o in want:
            np.testing.assert_array_equal(got[o].expand(shape).numpy(), np.asarray(want[o]))


@pytest.mark.parametrize("bs", [7, 35, 12])
def test_block_jacobi_from_bands_matches(bs):
    """Dense inverted blocks (bs = nx: x-lines, bs = nx*ny: xy-planes, and a
    bs that does not divide n) and their apply."""
    jop, op = _stars(7, 5, 6)
    jb = JBlockJacobi.from_bands(jop.diagonal_field(), jop.flat_band_fields(bs), bs)
    pb = BlockJacobi.from_bands(op.diagonal_field(), op.flat_band_fields(bs), bs)
    want = np.asarray(jb.dinv_blocks)
    np.testing.assert_allclose(pb.dinv_blocks.numpy(), want, rtol=1e-4, atol=1e-6 * np.abs(want).max())
    r = np.random.default_rng(4).standard_normal((6, 5, 7), dtype=np.float32)
    w = np.asarray(jb.apply(jnp.asarray(r)))
    np.testing.assert_allclose(pb.apply(torch.tensor(r)).numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max())


def test_pcr_line_jacobi_matches(monkeypatch):
    """Past the dense cap, tridiagonal x-line blocks go to PCR in both
    packages; its apply solves the blocks exactly."""
    monkeypatch.setattr(JBlockJacobi, "DENSE_ENTRY_CAP", 16)
    monkeypatch.setattr(BlockJacobi, "DENSE_ENTRY_CAP", 16)
    jop, op = _stars(13, 5, 6)
    jb = JBlockJacobi.from_bands(
        jop.diagonal_field(), {o: f for o, f in jop.flat_band_fields(13).items() if abs(o) == 1}, 13,
    )
    pb = BlockJacobi.from_bands(
        op.diagonal_field(), {o: f for o, f in op.flat_band_fields(13).items() if abs(o) == 1}, 13,
    )
    assert isinstance(jb, JPCRLineJacobi) and isinstance(pb, PCRLineJacobi)
    assert pb.shifts == jb.shifts == (1, 2, 4, 8)
    r = np.random.default_rng(5).standard_normal((6, 5, 13), dtype=np.float32)
    want = np.asarray(jb.apply(jnp.asarray(r)))
    got = pb.apply(torch.tensor(r))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    # the exact solve: the tridiagonal line blocks times z give back r
    lines = op.flat_band_fields(13)
    az = op.diagonal_field() * got + lines[1] * torch.roll(got, -1, 2) * (torch.arange(13) < 12)
    az = az + lines[-1] * torch.roll(got, 1, 2) * (torch.arange(13) > 0)
    np.testing.assert_allclose(az.numpy(), r, rtol=1e-4, atol=1e-5)


def test_pcr_build_matches_on_random_blocks():
    rng = np.random.default_rng(6)
    nb, bs = 5, 11
    lo, up = rng.uniform(-1, 0, (nb, bs)), rng.uniform(-1, 0, (nb, bs))
    lo[:, 0] = 0.0
    up[:, -1] = 0.0
    d = 2.5 + rng.uniform(0, 1, (nb, bs))
    args = [a.astype(np.float32) for a in (lo, d, up)]
    jb = JPCRLineJacobi.build(*(jnp.asarray(a) for a in args), nb * bs - 3)
    pb = PCRLineJacobi.build(*(torch.tensor(a) for a in args), nb * bs - 3)
    for g, w in zip((*pb.alphas, *pb.gammas, pb.binv), (*jb.alphas, *jb.gammas, jb.binv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    r = rng.standard_normal(nb * bs - 3).astype(np.float32)
    np.testing.assert_allclose(pb.apply(torch.tensor(r)).numpy(), np.asarray(jb.apply(jnp.asarray(r))), rtol=1e-5)


@pytest.fixture(scope="module")
def plain_hiers():
    """JAX plain hierarchies at 12^3 (SOR smoother, LU coarse solve, x-line
    block Jacobi), built op by op."""
    jop = j_poisson_stencil_device(JGrid3D(12, 12, 12), dtype=np.float32)[0]
    with jax.disable_jit():
        return {
            name: j_gamg_setup(jop, JAMGParams(**kw))
            for name, kw in (
                ("sor", dict(smoother="sor")), ("lu", dict(coarse_solve="lu")),
                ("bjacobi", dict(bjacobi_bs=12)),
            )
        }


@pytest.mark.parametrize("name", ["sor", "lu", "bjacobi"])
def test_plain_cycle_on_shared_hierarchy(plain_hiers, name):
    """The SOR smoother (reversed colors after the coarse correction), the
    dense coarse inverse and the block-Jacobi sub-PC in the plain cycle."""
    jh = plain_hiers[name]
    ph = port_copy(jh)
    b = np.random.default_rng(7).standard_normal((12, 12, 12), dtype=np.float32)
    want = np.asarray(j_vcycle(jh, jnp.asarray(b)))
    got = vcycle(ph, torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("name", ["sor", "lu", "bjacobi"])
def test_plain_setup_matches(plain_hiers, name):
    """The port's setup of the same options: shapes, rho (for block Jacobi
    rho(M_block^-1 A)), the coarse inverse and the sub-PC's blocks."""
    jh = plain_hiers[name]
    op = poisson_stencil_device(Grid3D(12, 12, 12), dtype=torch.float32, device="cpu")[0]
    kw = {"sor": dict(smoother="sor"), "lu": dict(coarse_solve="lu"), "bjacobi": dict(bjacobi_bs=12)}[name]
    ph = gamg_setup(op, AMGParams(**kw))
    assert ph.n_levels == jh.n_levels
    for plev, jlev in zip(ph.levels, jh.levels):
        assert plev.rho == pytest.approx(float(jlev.rho), rel=1e-5)
        assert (plev.bjac is None) == (jlev.bjac is None)
        if plev.bjac is not None:
            want = np.asarray(jlev.bjac.dinv_blocks)
            np.testing.assert_allclose(
                plev.bjac.dinv_blocks.numpy(), want, rtol=1e-4, atol=1e-6 * np.abs(want).max()
            )
            assert plev.bjac.bs == jlev.bjac.bs == plev.op.grid_shape[2]
    if name == "lu":
        want = np.asarray(jh.levels[-1].coarse_inv)
        got = ph.levels[-1].coarse_inv.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_dense_coarse_inverse_matches():
    """On a random 27-point operator (field view), a flat DIA, and the
    size guard."""
    jv, pv = _var27((3, 4, 5), 3)
    jv = JVarStencil27(coef=jv.coef.at[13].add(30.0))   # well conditioned
    pv = VarStencil27(coef=torch.tensor(np.asarray(jv.coef)))
    want = np.asarray(j_dense_coarse_inverse(jv))
    np.testing.assert_allclose(dense_coarse_inverse(pv).numpy(), want, rtol=1e-4, atol=1e-7)
    _, jop, _, _ = j_poisson_dia_device(JGrid3D(5, 4, 3))
    with jax.disable_jit():
        jh = j_gamg_setup_geo(jop, (3, 4, 5), JAMGParams(coarse_solve="lu"))
    jc = jh.levels[-1]
    pc = dia_from_numpy(np.asarray(jc.op.bands), jc.op.offsets, jc.op.shape, device="cpu")
    want = np.asarray(jc.coarse_inv)
    np.testing.assert_allclose(dense_coarse_inverse(pc).numpy(), want, rtol=1e-4, atol=1e-6 * np.abs(want).max())
    big = poisson_stencil_device(Grid3D(17, 17, 17), dtype=torch.float32, device="cpu")[0]
    assert 17**3 > DENSE_COARSE_CAP
    with pytest.raises(ValueError, match="dense-inverse cap"):
        dense_coarse_inverse(big)


def test_padded_layout_refuses_plain_only_options():
    """layout='padded' raises for what only the plain cycle honours, as in
    the JAX driver; 'auto' takes the plain layout there."""
    for kw in (dict(amg_params=AMGParams(smoother="sor")), dict(amg_params=AMGParams(coarse_solve="lu")),
               dict(amg_params=AMGParams(bjacobi_bs=6)), dict(pc="sor")):
        with pytest.raises(ValueError, match="layout='padded'"):
            solve_poisson(6, device="cpu", layout="padded", warmup=False, **kw)
    rep = solve_poisson(6, device="cpu", warmup=False, view=True, amg_params=AMGParams(smoother="sor"))
    assert "layout: plain" in rep.solver_view


class _Captured(Exception):
    pass


def test_ssor_apply_matches_jax(monkeypatch):
    """``-pc_type sor``'s apply (one forward and one reversed colour sweep)
    against the JAX driver's own, taken from its first inner solve, on one
    seeded residual; and symmetric, as CG needs it (a dropped or unreversed
    second sweep is not)."""
    import tpusparse.solve.refine as j_refine

    from tpusparse.bench.driver import solve_poisson as j_solve_poisson
    from tpusparse_torch.bench.driver import _ssor

    taken = {}

    def capture(*args, m_lo_mv=None, **kw):
        taken["m"] = m_lo_mv
        raise _Captured

    monkeypatch.setattr(j_refine, "cg_refined", capture)
    with jax.disable_jit(), pytest.raises(_Captured):
        j_solve_poisson(7, 6, 5, pc="sor", layout="plain", warmup=False)
    _, op = _stars(7, 6, 5)
    apply = _ssor(op)
    rng = np.random.default_rng(8)
    r, s = (rng.standard_normal((5, 6, 7), dtype=np.float32) for _ in range(2))
    want = np.asarray(taken["m"](jnp.asarray(r)))
    got = apply(torch.tensor(r))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    ms = apply(torch.tensor(s))
    assert torch.dot(got.reshape(-1), torch.tensor(s).reshape(-1)).item() == pytest.approx(
        torch.dot(ms.reshape(-1), torch.tensor(r).reshape(-1)).item(), rel=1e-5
    )


def _run(fn, argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fn(argv) == 0
    side = [line for line in out.getvalue().splitlines() if line.startswith("JSON: ")]
    assert len(side) == 1
    return json.loads(side[0][len("JSON: "):])


GRID = ["-da_grid_x", "24", "-da_grid_y", "24", "-da_grid_z", "24", "-ksp_rtol", "1e-8", "-ksp_atol", "1e-12"]
# (option values, the JAX CLI's layout as its TPU auto resolves it)
CLI = {
    "sor_smoother": (["-mg_levels_pc_type", "sor"], "plain"),
    "lu_coarse": (["-mg_coarse_pc_type", "lu"], "plain"),
    "xline_bjacobi": (["-pc_bjacobi_bs", "24"], "plain"),
    "pc_jacobi": (["-pc_type", "jacobi"], "padded"),
    "pc_sor": (["-pc_type", "sor"], "plain"),
    "pc_none": (["-pc_type", "none"], "padded"),
    "aij_lu": (["-mat_type", "aij", "-mat_structure_detect", "0", "-mg_coarse_pc_type", "lu"], "auto"),
}


@pytest.mark.parametrize("name", list(CLI))
def test_cli_solve_matches_jax(name):
    """The port's CLI with ``-device cpu`` (``-layout auto``) against the
    JAX CLI on the layout its TPU would take."""
    argv, layout = CLI[name]
    want = _run(j_main, [*GRID, *argv, "-layout", layout])
    got = _run(main, [*GRID, *argv, "-device", "cpu"])
    assert (got["reason"], got["outer_iters"]) == (want["reason"], want["outer_iters"])
    assert want["reason"] == 2
    assert abs(got["iters"] - want["iters"]) <= 1
    assert abs(got["linf_error"] - want["linf_error"]) < 1e-8

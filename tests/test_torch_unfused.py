"""The unfused padded V-cycle: kernels K10-K16 (the single-step fused7
modes) and the filtered-leg forms of every fused kernel, held as plain
twins against ``fused7_xla``; the port's unfused cycle and W-cycle on a
copy of the JAX hierarchy against the JAX package's; and 24^3 solves with
Chebyshev(3), Richardson(3) and the W-cycle against the JAX package's
padded solve (its unfused XLA cycle where its fused level declines).

Tolerances: fields at rtol 1e-5 and atol 1e-6 of their own range
(``tests/test_fused7.py`` without its floor); the cycles likewise.  The
solves: outer sweeps and reason equal, inner within 1 (f32 dots summed in
another order may move one inner solve across its tolerance), Linf within
1e-6 (``tests/test_padded.py:102``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import port_copy

from tpusparse.amg.fused_cycle import vcycle_fused as j_vcycle_fused
from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.amg.hierarchy import gamg_setup as j_gamg_setup
from tpusparse.amg.hierarchy import vcycle as j_vcycle
from tpusparse.bench.driver import solve_poisson as j_solve_poisson
from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import poisson_stencil_device as j_poisson_stencil_device
from tpusparse.kernels.fused7 import fused7_xla
from tpusparse.sparse.padded import PaddedStar as JPaddedStar
from tpusparse.sparse.padded import crop_field as j_crop_field
from tpusparse.sparse.padded import pad_field as j_pad_field
from tpusparse_torch.amg.fused_cycle import fused_fine_supported, vcycle_fused
from tpusparse_torch.amg.hierarchy import AMGParams, vcycle
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.kernels import fused7 as k
from tpusparse_torch.sparse.padded import crop_field, pad_field

# the fused-kernel scalars of tests/test_fused7.py:32-36
G, AD, S0, GW, G2 = 0.731, 0.377, 1.618, 0.243, 0.519
SHAPES = [(12, 12, 12), (10, 9, 13)]
# the filtered P-smoothing legs: z dropped (a (1, 3, 3) level), and y and x
FILTERS = [None, ("cz",), ("cy", "cx")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ops(shape, pinned=True, drop=None):
    """(JAX PaddedStar, its filtered twin or None, the port's (diag_p, cx,
    cy, cz), the port's flegs or None) for the Poisson operator at shape."""
    nz, ny, nx = shape
    jop = j_poisson_stencil_device(JGrid3D(nx, ny, nz), dtype=np.float32)[0]
    jp = dataclasses.replace(JPaddedStar.from_star(jop), pinned=pinned)
    legs = (pad_field(torch.tensor(np.asarray(jop.diag)), 1.0), float(jop.cx), float(jop.cy), float(jop.cz))
    if drop is None:
        return jp, None, legs, None
    zero = jnp.zeros((), jnp.float32)
    jf = dataclasses.replace(jp, **{name: zero for name in drop})
    flegs = tuple(0.0 if name in drop else float(getattr(jop, name)) for name in ("cx", "cy", "cz"))
    return jp, jf, legs, flegs


def _fields(shape, count, seed=3):
    rng = np.random.default_rng(seed)
    a = [rng.standard_normal(shape, dtype=np.float32) for _ in range(count)]
    return [j_pad_field(jnp.asarray(v)) for v in a], [pad_field(torch.tensor(v)) for v in a]


def _close(got, want, shape):
    """Port output (padded, zero pads) against the JAX one, on the domain."""
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, shape)
        return
    if want.ndim == 0:
        assert got.item() == pytest.approx(float(want), rel=1e-5)
        return
    w = np.asarray(j_crop_field(want, shape))
    g = crop_field(got, shape).numpy()
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * np.abs(w).max())
    pads = got.clone()
    crop_field(pads, shape).zero_()
    assert not pads.any()  # the layout's pad-zero invariant


# (mode, port call on (legs, x, b, d, pin, flegs))
SINGLE = {
    "mv": lambda L, x, b, d, P, f: k.fused7_mv(*L, x, *P),
    "residual": lambda L, x, b, d, P, f: k.fused7_residual(*L, x, b, *P),
    "rich": lambda L, x, b, d, P, f: k.fused7_rich(*L, x, b, G, *P),
    "cheb0": lambda L, x, b, d, P, f: k.fused7_cheb0(*L, x, b, G, *P),
    "cheb": lambda L, x, b, d, P, f: k.fused7_cheb(*L, x, b, d, AD, G, *P),
    "pre2": lambda L, x, b, d, P, f: k.fused7_pre2(*L, b, S0, AD, G, *P),
    "restrict": lambda L, x, b, d, P, f: k.fused7_restrict(*L, x, G, *P, flegs=f),
    "prolong": lambda L, x, b, d, P, f: k.fused7_prolong(*L, x, G, *P, flegs=f),
}


@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", list(SINGLE))
def test_single_step_twins_match_fused7_xla(mode, shape, pinned):
    """K10-K16 (and ``mv``, K1) against ``fused7_xla``'s mode."""
    jp, _, legs, _ = _ops(shape, pinned)
    (jx, jb, jd), (x, b, d) = _fields(shape, 3)
    want = fused7_xla(mode, jp, jx, jb, jd, G, AD, S0)
    _close(SINGLE[mode](legs, x, b, d, (shape, pinned), None), want, shape)


@pytest.mark.parametrize("drop", FILTERS[1:])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["restrict", "prolong"])
def test_smoothing_twins_take_filtered_legs(mode, shape, drop):
    """K15/K16 with ``flegs`` against ``fused7_xla(..., fop=...)``."""
    jp, jf, legs, flegs = _ops(shape, drop=drop)
    (jx, jb, jd), (x, b, d) = _fields(shape, 3)
    want = fused7_xla(mode, jp, jx, jb, jd, G, AD, S0, fop=jf)
    _close(SINGLE[mode](legs, x, b, d, (shape, True), flegs), want, shape)
    # and the filter matters: the unfiltered pass differs
    plain = SINGLE[mode](legs, x, b, d, (shape, True), None)
    assert not torch.allclose(plain, SINGLE[mode](legs, x, b, d, (shape, True), flegs))


# (mode, port call on (legs, t, b, x1, pin, flegs)) for the fused modes
FUSED = {
    "descent": lambda L, t, b, x1, P, f: k.fused7_descent(*L, b, S0, AD, G, GW, *P, flegs=f),
    "descent_rr": lambda L, t, b, x1, P, f: k.fused7_descent_rr(*L, b, S0, AD, G, GW, *P, flegs=f),
    "ascent": lambda L, t, b, x1, P, f: k.fused7_ascent(*L, t, b, x1, G, AD, G2, GW, *P, flegs=f),
    "ascent_rz": lambda L, t, b, x1, P, f: k.fused7_ascent_rz(*L, t, b, x1, G, AD, G2, GW, *P, flegs=f),
    "descent1": lambda L, t, b, x1, P, f: k.fused7_descent1(*L, b, G, GW, *P, flegs=f),
    "descent1_rr": lambda L, t, b, x1, P, f: k.fused7_descent1_rr(*L, b, G, GW, *P, flegs=f),
    "ascent1": lambda L, t, b, x1, P, f: k.fused7_ascent1(*L, t, b, x1, G, GW, *P, flegs=f),
    "ascent1_rz": lambda L, t, b, x1, P, f: k.fused7_ascent1_rz(*L, t, b, x1, G, GW, *P, flegs=f),
    "descentu": lambda L, t, b, x1, P, f: k.fused7_descentu(*L, t, b, S0, AD, G, GW, G2, *P, flegs=f),
}


@pytest.mark.parametrize("drop", FILTERS)
@pytest.mark.parametrize("mode", list(FUSED))
def test_fused_twins_take_filtered_legs(mode, drop):
    """Every fused kernel's twin with ``flegs`` against ``fused7_xla``
    with ``fop`` (and, for ``drop=None``, the default legs unchanged)."""
    shape = SHAPES[1]
    jp, jf, legs, flegs = _ops(shape, drop=drop)
    (jt, jb, jx1), (t, b, x1) = _fields(shape, 3, seed=4)
    if mode == "descentu":  # x_p = r_old, b_p = ap; g2 = alpha
        want = fused7_xla(mode, jp, jt, jb, jt, G, AD, S0, gw=GW, g2=G2, fop=jf)
    else:
        want = fused7_xla(mode, jp, jt, jb, jx1, G, AD, S0, gw=GW, g2=G2, fop=jf)
    _close(FUSED[mode](legs, t, b, x1, (shape, True), flegs), want, shape)


# level-0 (smoother, degree) and cycle index the fused fine level declines
# (or, for the W-cycle, takes): the unfused padded cycle's configurations
CYCLES = [
    (dict(degree=3), 1), (dict(smoother="richardson", degree=3), 1),
    (dict(degree=4), 1), (dict(), 2), (dict(degree=3), 2),
]


@pytest.mark.parametrize("params, gamma", CYCLES)
def test_unfused_cycle_on_shared_hierarchy(params, gamma):
    """``hierarchy.vcycle`` on a copy of the JAX hierarchy (padded fine
    level: K10-K16's twins) against the JAX package's unfused cycle."""
    n, shape = 12, (12, 12, 12)
    jop = j_poisson_stencil_device(JGrid3D(n, n, n), dtype=np.float32)[0]
    jh = j_gamg_setup(JPaddedStar.from_star(jop), JAMGParams(**params))
    ph = port_copy(jh)
    b = np.random.default_rng(6).standard_normal(shape, dtype=np.float32)
    want = np.asarray(j_crop_field(j_vcycle(jh, j_pad_field(jnp.asarray(b)), gamma=gamma), shape))
    got = crop_field(vcycle(ph, pad_field(torch.tensor(b)), gamma=gamma), shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_fused_w_cycle_on_shared_hierarchy():
    """``vcycle_fused`` with gamma 2 against the JAX package's."""
    n, shape = 12, (12, 12, 12)
    jop = j_poisson_stencil_device(JGrid3D(n, n, n), dtype=np.float32)[0]
    jh = j_gamg_setup(JPaddedStar.from_star(jop), JAMGParams())
    ph = port_copy(jh)
    assert fused_fine_supported(ph)
    b = np.random.default_rng(7).standard_normal(shape, dtype=np.float32)
    want = np.asarray(j_crop_field(j_vcycle_fused(jh, j_pad_field(jnp.asarray(b)), gamma=2), shape))
    got = crop_field(vcycle_fused(ph, pad_field(torch.tensor(b)), gamma=2), shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


KW = dict(atol=1e-12, pc="gamg", warmup=False)
# name: (n, rtol, JAX kwargs, port kwargs).  The W-cycle at 24^3 is held
# on its first sweep (rtol 1e-5): at rtol 1e-8 the second sweep's
# right-hand side is the first's residual, 1e-5 of ||b||, and that solve's
# count follows the rounding (the port takes 16 on one CPU thread, 19 on
# two or four, JAX 19: ROADMAP section 3, as the 16^3 plain layout); the
# whole solve is held at 18^3.
SOLVES = {
    "chebyshev3": (24, 1e-8, dict(amg_params=JAMGParams(degree=3)), dict(amg_params=AMGParams(degree=3))),
    "richardson3": (
        24, 1e-8, dict(amg_params=JAMGParams(smoother="richardson", degree=3)),
        dict(amg_params=AMGParams(smoother="richardson", degree=3)),
    ),
    "w_cycle": (24, 1e-5, dict(mg_cycle="w"), dict(mg_cycle="w")),
    "w_cycle_18": (18, 1e-8, dict(mg_cycle="w"), dict(mg_cycle="w")),
}


@pytest.fixture(scope="module")
def solves():
    return {
        name: (
            j_solve_poisson(n, layout="padded", rtol=rtol, **KW, **jkw),
            solve_poisson(n, device="cpu", view=True, rtol=rtol, **KW, **pkw),
        )
        for name, (n, rtol, jkw, pkw) in SOLVES.items()
    }


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_matches_jax(solves, name):
    want, got = solves[name]
    assert (got.outer_iters, got.reason) == (want.outer_iters, want.reason)
    assert want.reason == 2
    assert abs(got.iters - want.iters) <= 1
    # one sweep to rtol 1e-5 leaves an algebraic error of ~3e-6 in Linf
    assert abs(got.linf_error - want.linf_error) < (1e-6 if want.outer_iters > 1 else 1e-5)


def test_solves_take_the_intended_cycle(solves):
    """Degree 3 runs the unfused padded cycle; the W-cycle keeps the fused
    fine level and says so in -ksp_view."""
    assert "unfused cycle, kernels K10-K16" in solves["chebyshev3"][1].solver_view
    assert "unfused cycle" in solves["richardson3"][1].solver_view
    view = solves["w_cycle"][1].solver_view
    assert "fused fine level" in view and "cycle: W" in view

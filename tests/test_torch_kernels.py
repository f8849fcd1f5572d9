"""K1-K4, K6, K7 and the dot-free K3'/K4'/K6'/K7' parity: the port's kernel wrappers (on CPU tensors: their plain
twins) against the JAX package's XLA references and Pallas interpreter.

Inputs are made with numpy from a fixed seed and fed to both packages;
outputs are compared after cropping to the domain (the two packages pad
differently).  On a CUDA device the wrappers launch the hand-written
kernels instead; ``test_torch_cuda.py`` holds those against the twins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.grid.grid3d import Grid3D as JGrid3D
from tpusparse.grid.poisson import poisson_stencil as j_poisson_stencil
from tpusparse.kernels.fused7 import fused7_xla
from tpusparse.kernels.stencil7 import star7_mv_padded as j_star7_mv_padded
from tpusparse.sparse.padded import PaddedStar as JPaddedStar
from tpusparse.sparse.padded import crop_field as j_crop_field
from tpusparse.sparse.padded import pad_field as j_pad_field
from tpusparse.sparse.varstencil import OFFSETS
from tpusparse.sparse.varstencil import VarStencil27 as JVarStencil27
from tpusparse.sparse.varstencil import shift3 as j_shift3
from tpusparse_torch.interop import padded_star_from_numpy
from tpusparse_torch.kernels.fused7 import (
    fused7_ascent,
    fused7_ascent1,
    fused7_ascent1_rz,
    fused7_ascent_rz,
    fused7_descent,
    fused7_descent1,
    fused7_descent1_rr,
    fused7_descent_rr,
    fused7_mvdot,
)
from tpusparse_torch.kernels.stencil7 import star7_mv_padded
from tpusparse_torch.sparse.padded import crop_field, pad_field
from tpusparse_torch.sparse.varstencil import VarStencil27, shift3

SHAPES = [(12, 12, 12), (40, 11, 13)]   # (nz, ny, nx)
# the fused-kernel scalars of tests/test_fused7.py:32-36
G, AD, S0, GW, G2 = 0.731, 0.377, 1.618, 0.243, 0.519


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _system(shape, pinned=True, seed=7):
    """The f32 Poisson operator in both packages plus random fields."""
    nz, ny, nx = shape
    jop, jb, _ = j_poisson_stencil(JGrid3D(nx, ny, nz), pin=pinned, dtype=np.float32)
    jpop = JPaddedStar.from_star(jop, backend="xla")
    pop = padded_star_from_numpy(
        np.asarray(jop.diag), jop.cx, jop.cy, jop.cz, pinned, device="cpu",
    )
    rng = np.random.default_rng(seed)
    fields = {
        "x": rng.standard_normal(shape, dtype=np.float32),
        "d": rng.standard_normal(shape, dtype=np.float32),
        "b": np.asarray(jb, dtype=np.float32),
    }
    return jpop, pop, fields


def _jax_padded(fields):
    return {k: j_pad_field(jnp.asarray(v)) for k, v in fields.items()}


def _port_padded(fields):
    return {k: pad_field(torch.tensor(v)) for k, v in fields.items()}


def _check_field(got, want):
    """tests/test_fused7.py:53-69: rtol 1e-5, atol 1e-6 of this output's own
    range.  Without that file's 1e-3 floor, which exceeds the whole range of
    K3's x1 (~1e-4 here)."""
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def _check_dot(got, want):
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_twin_matches_xla_reference(shape, pinned):
    jpop, pop, f = _system(shape, pinned)
    want = np.asarray(j_crop_field(jpop.mv(_jax_padded(f)["x"]), shape))
    x_p = _port_padded(f)["x"]
    got = crop_field(
        star7_mv_padded(pop.diag, pop.cx, pop.cy, pop.cz, x_p, shape, pinned), shape
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_k1_twin_matches_pallas_interpreter():
    shape = (12, 12, 12)
    jpop, pop, f = _system(shape, True)
    y = j_star7_mv_padded(
        jpop.diag, jpop.cx, jpop.cy, jpop.cz, _jax_padded(f)["x"], shape, True,
        interpret=True,
    )
    want = np.asarray(j_crop_field(y, shape))
    got = crop_field(pop.mv(_port_padded(f)["x"]), shape).numpy()
    # the interpreter sums in another order than the XLA reference (they
    # differ from each other by 2.4e-4 here): where the terms (~1e3) cancel,
    # one ulp of a term remains, so atol scales with the output range
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_k1_keeps_the_pads_zero():
    shape = (40, 11, 13)
    _, pop, f = _system(shape)
    y = pop.mv(_port_padded(f)["x"])
    inner = torch.zeros_like(y, dtype=torch.bool)
    inner[3:-3, :, :13] = True
    assert torch.all(y[~inner] == 0)


@pytest.mark.parametrize("shape", SHAPES)
def test_k2_mvdot_twin_matches_fused7_xla(shape):
    jpop, pop, f = _system(shape)
    jf = _jax_padded(f)
    wy, wdot = fused7_xla("mvdot", jpop, jf["x"], jf["b"], jf["d"], G, AD, S0, gw=GW, g2=G2)
    y, dot = fused7_mvdot(pop.diag, pop.cx, pop.cy, pop.cz, _port_padded(f)["x"], shape, True)
    _check_field(crop_field(y, shape).numpy(), np.asarray(j_crop_field(wy, shape)))
    _check_dot(dot, wdot)


@pytest.mark.parametrize("shape", SHAPES)
def test_k3_descent_rr_twin_matches_fused7_xla(shape):
    jpop, pop, f = _system(shape)
    jf = _jax_padded(f)
    want = fused7_xla("descent_rr", jpop, jf["x"], jf["b"], jf["d"], G, AD, S0, gw=GW, g2=G2)
    got = fused7_descent_rr(
        pop.diag, pop.cx, pop.cy, pop.cz, _port_padded(f)["b"], S0, AD, G, GW, shape, True,
    )
    for g_, w_ in zip(got[:2], want[:2]):
        _check_field(crop_field(g_, shape).numpy(), np.asarray(j_crop_field(w_, shape)))
    _check_dot(got[2], want[2])


@pytest.mark.parametrize("shape", SHAPES)
def test_k4_ascent_rz_twin_matches_fused7_xla(shape):
    jpop, pop, f = _system(shape)
    jf = _jax_padded(f)
    # fused7_xla's ascent: t = x_p, x1 = d_p
    wz, wdot = fused7_xla("ascent_rz", jpop, jf["x"], jf["b"], jf["d"], G, AD, S0, gw=GW, g2=G2)
    pf = _port_padded(f)
    z, dot = fused7_ascent_rz(
        pop.diag, pop.cx, pop.cy, pop.cz, pf["x"], pf["b"], pf["d"], G, AD, G2, GW, shape, True,
    )
    _check_field(crop_field(z, shape).numpy(), np.asarray(j_crop_field(wz, shape)))
    _check_dot(dot, wdot)


# mode -> (port wrapper, its scalar arguments); fused7_xla's slots are
# (g, ad, s0, gw, g2) = (G, AD, S0, GW, G2) in every call below
DESCENTS = {
    "descent": (fused7_descent, (S0, AD, G, GW)),
    "descent1_rr": (fused7_descent1_rr, (G, GW)),
    "descent1": (fused7_descent1, (G, GW)),
}
ASCENTS = {
    "ascent": (fused7_ascent, (G, AD, G2, GW)),
    "ascent1_rz": (fused7_ascent1_rz, (G, GW)),
    "ascent1": (fused7_ascent1, (G, GW)),
}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", list(DESCENTS))
def test_descent_modes_twin_matches_fused7_xla(mode, shape):
    """K3' (descent), K6 (descent1_rr) and K6' (descent1) at K3's
    tolerances: fields as _check_field, dots 1e-5 relative."""
    jpop, pop, f = _system(shape)
    jf = _jax_padded(f)
    want = fused7_xla(mode, jpop, jf["x"], jf["b"], jf["d"], G, AD, S0, gw=GW, g2=G2)
    wrapper, scalars = DESCENTS[mode]
    got = wrapper(pop.diag, pop.cx, pop.cy, pop.cz, _port_padded(f)["b"], *scalars, shape, True)
    assert len(got) == len(want) == (3 if mode.endswith("_rr") else 2)
    for g_, w_ in zip(got[:2], want[:2]):
        _check_field(crop_field(g_, shape).numpy(), np.asarray(j_crop_field(w_, shape)))
    if mode.endswith("_rr"):
        _check_dot(got[2], want[2])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", list(ASCENTS))
def test_ascent_modes_twin_matches_fused7_xla(mode, shape):
    """K4' (ascent), K7 (ascent1_rz) and K7' (ascent1) at K4's tolerances;
    fused7_xla's ascents take t = x_p, x1 = d_p."""
    jpop, pop, f = _system(shape)
    jf = _jax_padded(f)
    want = fused7_xla(mode, jpop, jf["x"], jf["b"], jf["d"], G, AD, S0, gw=GW, g2=G2)
    wrapper, scalars = ASCENTS[mode]
    pf = _port_padded(f)
    got = wrapper(pop.diag, pop.cx, pop.cy, pop.cz, pf["x"], pf["b"], pf["d"], *scalars, shape, True)
    if mode.endswith("_rz"):
        (got, dot), (want, wdot) = got, want
        _check_dot(dot, wdot)
    _check_field(crop_field(got, shape).numpy(), np.asarray(j_crop_field(want, shape)))


@pytest.mark.parametrize("off", [OFFSETS[0], OFFSETS[4], OFFSETS[13], OFFSETS[22], OFFSETS[26]])
def test_shift3_matches_jax(off):
    x = np.random.default_rng(2).standard_normal((5, 4, 6), dtype=np.float32)
    got = shift3(torch.tensor(x), off).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_shift3(jnp.asarray(x), off)))


def test_bf16_coefficients_promote_to_f32():
    """After cast_coarse_coefs a bf16 stack multiplies f32 vectors: the
    result is f32 and equals the f32 apply of the bf16-rounded stack."""
    rng = np.random.default_rng(1)
    coef = torch.from_numpy(rng.standard_normal((27, 5, 4, 6), dtype=np.float32))
    x = torch.from_numpy(rng.standard_normal((5, 4, 6), dtype=np.float32))
    y16 = VarStencil27(coef=coef.to(torch.bfloat16)).mv(x)
    y32 = VarStencil27(coef=coef.to(torch.bfloat16).float()).mv(x)
    assert y16.dtype == torch.float32
    torch.testing.assert_close(y16, y32, rtol=0, atol=0)
    jcoef = jnp.asarray(coef.numpy()).astype(jnp.bfloat16)
    jy = np.asarray(JVarStencil27(coef=jcoef).mv(jnp.asarray(x.numpy())))
    assert jy.dtype == np.float32
    np.testing.assert_allclose(y16.numpy(), jy, rtol=1e-6, atol=1e-6)

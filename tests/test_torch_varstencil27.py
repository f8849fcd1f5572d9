"""The coarse levels' 27-point apply, ``kernels/varstencil27.py``.

On the CPU: the plain twin ``varstencil27_mv_torch`` against the JAX
package's ``VarStencil27.mv`` (f32, f64, and bf16 coefficients on f32
fields, one field and a stack of 3 vmapped), and ``VarStencil27.mv``
equal to the twin bit for bit, launching nothing.

On the card (``requires_cuda``, skipped without one): the kernel equal to
the twin bit for bit for every (coefficient, field) dtype pair the port
makes, at ragged shapes of one tile and of several, and the 720^3
stencil cell's 80^3 and 240^3 levels, on a stack of 3 and on a
non-contiguous field, one launch an apply; any other pair raises.  The
module imports JAX only inside the CPU tests, so the card's tests run
where JAX is not installed:

    python -m pytest tests/test_torch_varstencil27.py -m requires_cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from tpusparse_torch import kernels
from tpusparse_torch.kernels.varstencil27 import PAIRS, varstencil27_mv, varstencil27_mv_torch
from tpusparse_torch.sparse.varstencil import VarStencil27

SHAPES = [(3, 3, 3), (5, 7, 9), (1, 4, 6), (9, 8, 10)]   # (nz, ny, nx)
# several tiles of 16 x 64 with ragged edges (x a multiple of 4 or not),
# then the 80^3 and 240^3 levels, which march several planes a block
CARD_SHAPES = SHAPES + [(20, 33, 70), (12, 17, 132), (80, 80, 80), (240, 240, 240)]
STACKS = [None, 3]   # one field, or a stack of 3 columns


def _inputs(shape, k, cdt, xdt, seed=11):
    """numpy coefficients (27, *shape) and a field (or a stack of k) in
    float64, and the same as torch tensors of ``cdt`` and ``xdt``; every
    coefficient set, those whose target leaves the grid too."""
    rng = np.random.default_rng(seed)
    coef = rng.standard_normal((27, *shape))
    x = rng.standard_normal(shape if k is None else (k, *shape))
    return coef, x, torch.from_numpy(coef).to(cdt), torch.from_numpy(x).to(xdt)


def _jax_mv(coef, x):
    """The JAX package's apply on numpy inputs (a stack vmapped), imported
    here: the card's tests run where JAX is not installed."""
    import jax

    from tpusparse.sparse.varstencil import VarStencil27 as JVarStencil27

    jop = JVarStencil27(coef=jax.numpy.asarray(coef))
    xs = jax.numpy.asarray(x)
    return np.asarray(jop.mv(xs) if xs.ndim == 3 else jax.vmap(jop.mv)(xs))


@pytest.mark.parametrize("k", STACKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES)
def test_twin_matches_jax(shape, dtype, k):
    coef, x, tcoef, tx = _inputs(shape, k, dtype, dtype)
    got = varstencil27_mv_torch(tcoef, tx)
    want = _jax_mv(tcoef.numpy(), tx.numpy())
    assert got.dtype == dtype and want.dtype == tcoef.numpy().dtype
    tol = 1e-6 if dtype == torch.float32 else 1e-13
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("k", STACKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_twin_bf16_coefficients_match_jax(shape, k):
    """bf16 coefficients on f32 fields (``cast_coarse_coefs``): both
    promote to f32."""
    import jax.numpy as jnp

    coef, x, tcoef, tx = _inputs(shape, k, torch.bfloat16, torch.float32)
    got = varstencil27_mv_torch(tcoef, tx)
    want = _jax_mv(jnp.asarray(tcoef.float().numpy()).astype(jnp.bfloat16), tx.numpy())
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", STACKS)
@pytest.mark.parametrize("pair", list(PAIRS), ids=lambda p: f"{p[0]}-{p[1]}".replace("torch.", ""))
@pytest.mark.parametrize("shape", SHAPES)
def test_mv_is_the_twin_on_the_cpu(shape, pair, k):
    """``VarStencil27.mv`` on CPU tensors is the twin, bit for bit, and
    launches nothing."""
    _, _, tcoef, tx = _inputs(shape, k, *pair)
    before = dict(kernels.LAUNCHES)
    got = VarStencil27(coef=tcoef).mv(tx)
    want = varstencil27_mv_torch(tcoef, tx)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert kernels.LAUNCHES == before


def test_wrapper_refuses_mismatched_shapes():
    coef = torch.zeros((27, 3, 4, 5))
    with pytest.raises(ValueError):
        varstencil27_mv(coef, torch.zeros((3, 4, 6)))
    with pytest.raises(ValueError):
        varstencil27_mv(coef[:26], torch.zeros((3, 4, 5)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("pair", list(PAIRS), ids=lambda p: f"{p[0]}-{p[1]}".replace("torch.", ""))
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_equals_twin(cuda, shape, pair):
    """One launch an apply, bit-equal to the twin on the card: one field,
    a stack of 3 columns, and a non-contiguous field."""
    gen = torch.Generator(cuda).manual_seed(3)
    coef = torch.randn((27, *shape), generator=gen, device=cuda).to(pair[0])
    x = torch.randn((3, *shape), generator=gen, device=cuda).to(pair[1])
    fields = [x[0], x]
    if min(shape) > 1:
        fields.append(x[1].transpose(0, 2).contiguous().transpose(0, 2))
        assert not fields[-1].is_contiguous()
    for field in fields:
        before = kernels.LAUNCHES["varstencil27_mv"]
        got = varstencil27_mv(coef, field)
        assert kernels.LAUNCHES["varstencil27_mv"] == before + 1
        want = varstencil27_mv_torch(coef, field)
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert all(torch.equal(varstencil27_mv(coef, x)[c], varstencil27_mv(coef, x[c])) for c in range(3))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("pair", [(torch.float32, torch.float64), (torch.float64, torch.float32),
                                  (torch.float16, torch.float32), (torch.float32, torch.bfloat16)],
                         ids=lambda p: f"{p[0]}-{p[1]}".replace("torch.", ""))
def test_kernel_refuses_other_pairs(cuda, pair):
    coef = torch.ones((27, 3, 4, 5), device=cuda, dtype=pair[0])
    with pytest.raises(TypeError):
        varstencil27_mv(coef, torch.ones((3, 4, 5), device=cuda, dtype=pair[1]))

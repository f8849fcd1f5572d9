"""CG's vector updates, ``kernels/cgupdate.py`` (``cg_update_r``: r - alpha
ap; ``cg_update_xp``: x + alpha p and z + beta p), on the CPU.

The twins equal the three statements ``solve/cg.py``'s loop ran before the
kernels, bit for bit, in f32 and f64 and with an f64 scalar on f32 fields,
on flat and padded 3-D shapes whose size is not a multiple of 4; the
wrappers refuse mismatched shapes, dtypes and devices, scalars that are not
0-d f32 / f64 tensors, and non-contiguous fields, and a CPU call counts no
launch.  ``cg`` itself, which now updates x after the preconditioner, gives
the same x, iterations, residual norm and reason as a reference loop with
the old statements in the old order, on the inner solves of ``KSP``'s
padded (fused ``a_mv_dot`` / ``m_mv_dots`` and without them), DIA and
``VarStencil27`` routes, under ``check_every=2``, ``spectrum``,
``norm_type="preconditioned"`` and a ``return_state`` / ``state0`` resume.
The kernels themselves are held to the twins on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from tpusparse_torch import KSP, Grid3D, kernels
from tpusparse_torch.grid.hpcg import hpcg_stencil
from tpusparse_torch.grid.poisson import poisson_dia_device, poisson_stencil_device
from tpusparse_torch.kernels.cgupdate import cg_update_r, cg_update_r_torch, cg_update_xp, cg_update_xp_torch
from tpusparse_torch.kernels.stencil7 import padded_shape
from tpusparse_torch.solve.cg import (
    CGResult,
    ConvergedReason,
    _dot,
    cg,
    convergence_test,
    norm_h,
    np_float,
)
from tpusparse_torch.utils.profiling import read

N = 12   # the solves' grid: N^3
SHAPES = [(1,), (3,), (4097,), (1001,), padded_shape((5, 6, 7))]   # n % 4 != 0 but for 4097's tail of 1
FIELD_SCALAR = [(torch.float32, torch.float32), (torch.float32, torch.float64), (torch.float64, torch.float64),
                (torch.float64, torch.float32)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fields(shape, dtype, sdtype, seed=3):
    rng = np.random.default_rng(seed)
    x, p, z, r, ap = (torch.tensor(rng.standard_normal(shape), dtype=dtype) for _ in range(5))
    alpha, beta = (torch.tensor(v, dtype=sdtype) for v in rng.standard_normal(2))
    return x, p, z, r, ap, alpha, beta


@pytest.mark.parametrize("dtype, sdtype", FIELD_SCALAR)
@pytest.mark.parametrize("shape", SHAPES)
def test_twins_equal_the_old_statements(shape, dtype, sdtype):
    x, p, z, r, ap, alpha, beta = _fields(shape, dtype, sdtype)
    before = dict(kernels.LAUNCHES)
    new_r = cg_update_r(r, ap, alpha)
    new_x, new_p = cg_update_xp(x, p, z, alpha, beta)
    assert kernels.LAUNCHES == before
    assert torch.equal(new_r, r - alpha * ap)
    assert torch.equal(new_x, x + alpha * p)
    assert torch.equal(new_p, z + beta * p)
    assert torch.equal(cg_update_r_torch(r, ap, alpha), new_r)
    assert all(map(torch.equal, cg_update_xp_torch(x, p, z, alpha, beta), (new_x, new_p)))
    assert new_r.dtype == new_x.dtype == new_p.dtype == dtype
    # fresh outputs: the inputs are not written
    assert all(t.data_ptr() not in {x.data_ptr(), p.data_ptr(), z.data_ptr()} for t in (new_x, new_p))


def _bad_calls():
    """(label, call, exception) of every refusal."""
    x, p, z, r, ap, alpha, beta = _fields((4, 5, 6), torch.float32, torch.float32)
    wide = torch.zeros(4, 5, 12)
    return [
        ("shape", lambda: cg_update_r(r, ap[:3], alpha), ValueError),
        ("shape xp", lambda: cg_update_xp(x, p, z.reshape(-1), alpha, beta), ValueError),
        ("dtype", lambda: cg_update_r(r, ap.double(), alpha), TypeError),
        ("dtype xp", lambda: cg_update_xp(x, p.double(), z, alpha, beta), TypeError),
        ("f16 fields", lambda: cg_update_r(r.half(), ap.half(), alpha), TypeError),
        ("bf16 fields", lambda: cg_update_xp(x.bfloat16(), p.bfloat16(), z.bfloat16(), alpha, beta), TypeError),
        ("device", lambda: cg_update_r(r, ap.to("meta"), alpha), ValueError),
        ("device xp", lambda: cg_update_xp(x, p, z.to("meta"), alpha, beta), ValueError),
        ("scalar device", lambda: cg_update_r(r, ap, alpha.to("meta")), ValueError),
        ("scalar shape", lambda: cg_update_r(r, ap, alpha.reshape(1)), ValueError),
        ("scalar dtype", lambda: cg_update_xp(x, p, z, alpha, beta.half()), ValueError),
        ("non-contiguous", lambda: cg_update_r(wide[..., ::2], ap, alpha), ValueError),
        ("non-contiguous xp", lambda: cg_update_xp(x, p.transpose(0, 2).contiguous().transpose(0, 2), z,
                                                   alpha, beta), ValueError),
    ]


@pytest.mark.parametrize("index", range(len(_bad_calls())))
def test_wrappers_refuse(index):
    label, call, exc = _bad_calls()[index]
    before = dict(kernels.LAUNCHES)
    with pytest.raises(exc):
        call()
    assert kernels.LAUNCHES == before, label


def _cg_old(a_mv, b, x0=None, *, rtol=1e-5, atol=1e-50, maxiter=10000, m_mv=None, state0=None,
            return_state=False, a_mv_dot=None, m_mv_dots=None, check_every=1, spectrum=False, divtol=1e5,
            norm_type="unpreconditioned"):
    """``cg``'s unfused loop as it was before the kernels: the three
    statements x + alpha p, r - alpha ap, z + beta p, x updated first."""
    m_mv = m_mv or (lambda r: r)
    x0 = torch.zeros_like(b) if x0 is None else x0
    f = np_float(b.dtype)
    bnorm = norm_h(b, f)
    classify = convergence_test(f, bnorm, rtol, atol, divtol, maxiter)
    precond = norm_type == "preconditioned"
    if state0 is None:
        x, r = x0, b - a_mv(x0)
        if m_mv_dots is not None:
            z, rz, rr = m_mv_dots(r)
            rnorm = torch.sqrt(rr)
        else:
            z = m_mv(r)
            rz, rnorm = _dot(r, z), torch.sqrt(_dot(r, r))
        if precond:
            rnorm = torch.sqrt(torch.abs(rz))
        p, it = z, 0
    else:
        x, r, z, p, rz, rnorm, it = state0
    rnorm_h = f(read(rnorm))
    reason = classify(rnorm_h, it)
    scalars = []
    while reason == ConvergedReason.ITERATING:
        for _ in range(check_every):
            if a_mv_dot is not None:
                ap, pap = a_mv_dot(p)
                alpha = rz / pap.to(rz.dtype)
            else:
                ap = a_mv(p)
                alpha = rz / _dot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            if m_mv_dots is not None:
                z, rz_new, rr = m_mv_dots(r)
                rnorm = torch.sqrt(rr)
            else:
                z = m_mv(r)
                rz_new, rnorm = _dot(r, z), torch.sqrt(_dot(r, r))
            if precond:
                rnorm = torch.sqrt(torch.abs(rz_new))
            beta = rz_new / rz
            p = z + beta * p
            rz = rz_new
            it += 1
            scalars.append(torch.stack([alpha, beta]).to(torch.float64))
        rnorm_h = f(read(rnorm))
        reason = classify(rnorm_h, it)
    result = CGResult(x=x, iters=it, resnorm=float(rnorm_h), reason=int(reason), bnorm=float(bnorm))
    if return_state:
        return result, (x, r, z, p, rz, rnorm, it)
    if spectrum:
        return result, torch.stack(scalars).T.numpy() if scalars else np.zeros((2, 0))
    return result


class _Recorder:
    """``KSP``'s inner solver: ``cg``, recording each call's arguments
    (``func`` is ``cg``, so the padded route hands it the fused forms)."""

    func = staticmethod(cg)

    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return cg(*args, **kw)


def _ksp(route):
    grid = Grid3D(N, N, N)
    ksp = KSP(rtol=1e-8, atol=1e-12)
    if route in ("padded", "padded_unfused"):
        ksp.set_operators(poisson_stencil_device(grid, device="cpu")[0], device="cpu")
        shape = (N, N, N)
    elif route == "dia":
        op_hi, op_lo, _, _ = poisson_dia_device(grid, device="cpu")
        ksp.set_operators(op_hi, op_lo, device="cpu")
        shape = (N ** 3,)
    else:
        ksp.set_operators(hpcg_stencil(grid, torch.float64, "cpu"), hpcg_stencil(grid, torch.float32, "cpu"),
                          device="cpu")
        shape = (N, N, N)
    return ksp, shape


_INNER = {}


def _inner(route):
    """The first inner CG solve's (a_mv, b, kwargs) of a ``KSP`` solve on
    ``route`` at N^3, from a smooth right-hand side with noise."""
    if route not in _INNER:
        ksp, shape = _ksp(route)
        rec = _Recorder()
        ksp._ksp_solve = rec
        rng = np.random.default_rng(5)
        b = torch.tensor(rng.standard_normal(shape)) + torch.linspace(-1.0, 1.0, int(np.prod(shape))).reshape(shape)
        ksp.solve(b)
        (a_mv, b_lo), kw = rec.calls[0]
        kw = dict(kw)
        if route == "padded":
            assert "a_mv_dot" in kw and "m_mv_dots" in kw
        else:
            kw.pop("a_mv_dot", None)
            kw.pop("m_mv_dots", None)
            assert kw.get("m_mv") is not None
        _INNER[route] = (a_mv, b_lo, kw)
    return _INNER[route]


ROUTES = ["padded", "padded_unfused", "dia", "varstencil"]
VARIANTS = {
    "plain": {},
    "check_every": {"check_every": 2},
    "preconditioned": {"norm_type": "preconditioned"},
    "spectrum": {"spectrum": True},
}


def _same(new: CGResult, old: CGResult):
    assert torch.equal(new.x, old.x)
    assert (new.iters, new.resnorm, new.reason) == (old.iters, old.resnorm, old.reason)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("route", ROUTES)
def test_cg_equals_the_old_loop(route, variant):
    a_mv, b, kw = _inner(route)
    kw = {**kw, **VARIANTS[variant]}
    new, old = cg(a_mv, b, **kw), _cg_old(a_mv, b, **kw)
    if variant == "spectrum":
        (new, (alphas, betas)), (old, ab) = new, old
        assert np.array_equal(alphas[:new.iters], ab[0]) and np.array_equal(betas[:new.iters], ab[1])
        assert not alphas[new.iters:].any()
    _same(new, old)
    assert new.iters > 2 and new.reason > 0


@pytest.mark.parametrize("route", ROUTES)
def test_cg_state_resume_equals_the_old_loop(route):
    a_mv, b, kw = _inner(route)
    kw = {k: v for k, v in kw.items() if k != "maxiter"}
    x0 = 0.25 * b
    x0_copy = x0.clone()
    (new, new_state), (old, old_state) = (
        fn(a_mv, b, x0, maxiter=2, return_state=True, **kw) for fn in (cg, _cg_old)
    )
    assert torch.equal(x0, x0_copy)   # the caller's guess is not written
    _same(new, old)
    assert new.reason == ConvergedReason.DIVERGED_ITS
    for got, want in zip(new_state, old_state):
        assert torch.equal(torch.as_tensor(got), torch.as_tensor(want))
    state = tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in new_state)
    resumed, old_resumed = cg(a_mv, b, state0=new_state, maxiter=200, **kw), _cg_old(
        a_mv, b, state0=old_state, maxiter=200, **kw)
    _same(resumed, old_resumed)
    assert resumed.reason > 0
    # the resumed solve wrote none of the state it was given
    assert all(torch.equal(torch.as_tensor(a), torch.as_tensor(c)) for a, c in zip(new_state, state))

"""On the card: every CUDA kernel of ``tpusparse_torch`` against its plain
PyTorch twin at small ragged shapes, and small stencil and aij solves on
the card against the same solves on the CPU.

These tests need a CUDA device and skip without one.  The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m requires_cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from tpusparse_torch import kernels
from tpusparse_torch.amg.hierarchy import AMGParams
from tpusparse_torch.bench.driver import solve_poisson
from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.grid.poisson import poisson_stencil_device
from tpusparse_torch.kernels.diaband import dia_mv, dia_mv_torch
from tpusparse_torch.kernels.fused7 import (
    fused7_ascent,
    fused7_ascent1,
    fused7_ascent1_rz,
    fused7_ascent1_rz_torch,
    fused7_ascent1_torch,
    fused7_ascent_rz,
    fused7_ascent_rz_torch,
    fused7_ascent_torch,
    fused7_descent,
    fused7_descent1,
    fused7_descent1_rr,
    fused7_descent1_rr_torch,
    fused7_descent1_torch,
    fused7_descent_rr,
    fused7_descent_rr_torch,
    fused7_descent_torch,
    fused7_mvdot,
    fused7_mvdot_torch,
)
from tpusparse_torch.kernels.stencil7 import star7_mv_padded, star7_mv_padded_torch
from tpusparse_torch.sparse.padded import PaddedStar, pad_field

pytestmark = pytest.mark.requires_cuda

# the fused-kernel scalars of tests/test_fused7.py:32-36
G, AD, S0, GW, G2 = 0.731, 0.377, 1.618, 0.243, 0.519

CASES = {
    "star7_mv_padded": (star7_mv_padded, star7_mv_padded_torch),
    "fused7_mvdot": (fused7_mvdot, fused7_mvdot_torch),
    "fused7_descent_rr": (fused7_descent_rr, fused7_descent_rr_torch),
    "fused7_ascent_rz": (fused7_ascent_rz, fused7_ascent_rz_torch),
    "fused7_descent": (fused7_descent, fused7_descent_torch),
    "fused7_ascent": (fused7_ascent, fused7_ascent_torch),
    "fused7_descent1_rr": (fused7_descent1_rr, fused7_descent1_rr_torch),
    "fused7_ascent1_rz": (fused7_ascent1_rz, fused7_ascent1_rz_torch),
    "fused7_descent1": (fused7_descent1, fused7_descent1_torch),
    "fused7_ascent1": (fused7_ascent1, fused7_ascent1_torch),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


def _args(name, shape, pinned, device):
    nz, ny, nx = shape
    op = PaddedStar.from_star(poisson_stencil_device(
        Grid3D(nx, ny, nz), pin=pinned, dtype=torch.float32, device=device)[0])
    rng = np.random.default_rng(7)
    x, b, x1 = (
        pad_field(torch.tensor(rng.standard_normal(shape, dtype=np.float32), device=device))
        for _ in range(3)
    )
    legs = (op.diag, op.cx, op.cy, op.cz)
    return {
        "star7_mv_padded": (*legs, x, shape, pinned),
        "fused7_mvdot": (*legs, x, shape, pinned),
        "fused7_descent_rr": (*legs, b, S0, AD, G, GW, shape, pinned),
        "fused7_ascent_rz": (*legs, x, b, x1, G, AD, G2, GW, shape, pinned),
        "fused7_descent": (*legs, b, S0, AD, G, GW, shape, pinned),
        "fused7_ascent": (*legs, x, b, x1, G, AD, G2, GW, shape, pinned),
        "fused7_descent1_rr": (*legs, b, G, GW, shape, pinned),
        "fused7_ascent1_rz": (*legs, x, b, x1, G, GW, shape, pinned),
        "fused7_descent1": (*legs, b, G, GW, shape, pinned),
        "fused7_ascent1": (*legs, x, b, x1, G, GW, shape, pinned),
    }[name]


@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("shape", [(40, 11, 13), (7, 5, 9), (12, 12, 12), (3, 2, 1)])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_twin(cuda, name, shape, pinned):
    kernel, twin = CASES[name]
    args = _args(name, shape, pinned, cuda)
    before = kernels.LAUNCHES[name]
    got, want = kernel(*args), twin(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g_, w_ in zip(got, want):
        assert g_.device == cuda and g_.shape == w_.shape
        if w_.dim() == 0:
            assert abs(g_.item() - w_.item()) <= 1e-5 * abs(w_.item())
        else:
            # tests/test_fused7.py:53-69, atol from each output's own range
            atol = 1e-6 * w_.abs().max().item()
            torch.testing.assert_close(g_, w_, rtol=1e-5, atol=atol)


def _box27(ny, nx):
    return tuple(sorted({dz * ny * nx + dy * nx + dx for dz in (-1, 0, 1)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)}))


@pytest.mark.parametrize(
    "n, offsets",
    [
        (40 * 11 * 13, (-143, -13, -1, 0, 1, 13, 143)),       # ragged star, K = 7
        (40 * 11 * 13, _box27(11, 13)),                        # K = 27
        (1000, (-1500, -999, -7, 0, 3, 999, 1200)),           # beyond both ends
        (7, (-3, 0, 2)),                                       # less than a warp
        (5000, tuple(range(-24, 24))),                         # K = 48
    ],
)
def test_dia_mv_matches_twin(cuda, n, offsets):
    rng = np.random.default_rng(11)
    bands = torch.tensor(rng.standard_normal((len(offsets), n), dtype=np.float32), device=cuda)
    x = torch.tensor(rng.standard_normal(n, dtype=np.float32), device=cuda)
    before = kernels.LAUNCHES["dia_mv"]
    got, want = dia_mv(bands, x, offsets), dia_mv_torch(bands, x, offsets)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dia_mv"] == before + 1
    assert got.device == cuda and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * want.abs().max().item())


def test_twins_do_not_count(cuda):
    before = dict(kernels.LAUNCHES)
    star7_mv_padded_torch(*_args("star7_mv_padded", (6, 5, 7), True, cuda))
    assert kernels.LAUNCHES == before


def test_small_solve_on_card_matches_cpu(cuda):
    kw = dict(rtol=1e-8, atol=1e-12, pc="gamg", warmup=False)
    kernels.reset_launches()
    gpu = solve_poisson(16, device=cuda, **kw)
    stencil = ("star7_mv_padded", "fused7_mvdot", "fused7_descent_rr", "fused7_ascent_rz")
    assert all(kernels.LAUNCHES[name] > 0 for name in stencil)
    assert all(n == 0 for name, n in kernels.LAUNCHES.items() if name not in stencil)
    cpu = solve_poisson(16, device="cpu", **kw)
    assert (gpu.reason, gpu.outer_iters) == (cpu.reason, cpu.outer_iters) == (2, 2)
    assert abs(gpu.iters - cpu.iters) <= 1
    assert abs(gpu.linf_error - cpu.linf_error) < 1e-6


def test_small_aij_solve_on_card_matches_cpu(cuda):
    kw = dict(rtol=1e-8, atol=1e-12, pc="gamg", warmup=False, mat_type="aij")
    kernels.reset_launches()
    gpu = solve_poisson(16, device=cuda, **kw)
    assert kernels.LAUNCHES["dia_mv"] > 0
    assert all(n == 0 for name, n in kernels.LAUNCHES.items() if name != "dia_mv")
    cpu = solve_poisson(16, device="cpu", **kw)
    assert (gpu.reason, gpu.outer_iters) == (cpu.reason, cpu.outer_iters)
    assert gpu.reason == 2
    assert abs(gpu.iters - cpu.iters) <= 1
    assert abs(gpu.linf_error - cpu.linf_error) < 1e-6


REFERENCE = AMGParams(smoother="richardson", degree=1)   # the reference config's smoother


@pytest.mark.parametrize(
    "ksp, used, window",
    [("cg", ("fused7_descent1_rr", "fused7_ascent1_rz"), 0.03),
     ("bcgs", ("fused7_descent1", "fused7_ascent1"), 0.10)],
)
def test_small_reference_config_solve_on_card_matches_cpu(cuda, ksp, used, window):
    """The reference config (Richardson(1), rtol 1e-14) at 16^3 on the card
    against the same solve on the CPU: the degree-1 kernels (K6/K7 for CG,
    K6'/K7' for the other methods) and no degree-2 one.  With Richardson(1)
    the inner count follows the dots' summation order: CG within 3%,
    BiCGStab within 10% (135 on the card vs 142 on the CPU here; at 24^3
    the JAX package's own two cycles take 228 and 292)."""
    kw = dict(rtol=1e-14, atol=1e-12, amg_params=REFERENCE, ksp=ksp, warmup=False)
    kernels.reset_launches()
    gpu = solve_poisson(16, device=cuda, **kw)
    assert all(kernels.LAUNCHES[name] > 0 for name in used)
    assert all(kernels.LAUNCHES[name] == 0 for name in ("fused7_descent_rr", "fused7_ascent_rz",
                                                          "fused7_descent", "fused7_ascent"))
    cpu = solve_poisson(16, device="cpu", **kw)
    assert (gpu.reason, gpu.outer_iters) == (cpu.reason, cpu.outer_iters)
    assert gpu.reason > 0
    assert abs(gpu.iters - cpu.iters) <= window * cpu.iters + 1
    assert abs(gpu.linf_error - cpu.linf_error) < 1e-9


def test_gmres_solve_on_card_launches_the_dot_free_kernels(cuda):
    kernels.reset_launches()
    gpu = solve_poisson(16, device=cuda, rtol=1e-8, atol=1e-12, ksp="gmres", warmup=False)
    assert kernels.LAUNCHES["fused7_descent"] > 0 and kernels.LAUNCHES["fused7_ascent"] > 0
    assert kernels.LAUNCHES["fused7_descent_rr"] == kernels.LAUNCHES["fused7_mvdot"] == 0
    cpu = solve_poisson(16, device="cpu", rtol=1e-8, atol=1e-12, ksp="gmres", warmup=False)
    assert (gpu.reason, gpu.outer_iters) == (cpu.reason, cpu.outer_iters) == (2, 2)
    assert abs(gpu.iters - cpu.iters) <= 1

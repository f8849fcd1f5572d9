"""The plain reference against ``tpusparse_torch`` on the CPU: the same
operator, and the port's solutions judged correct by it."""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark import rhs, spec
from benchmark.reference.poisson7 import Poisson7
from tpusparse_torch import Grid3D
from tpusparse_torch.grid.poisson import assemble_poisson, poisson_stencil_device

SHAPES = [((5, 4, 3), (1.0, 2.0, 0.5)), ((7, 6, 9), (1.0, 1.0, 1.0)), ((2, 5, 1), (1.0, 1.0, 3.0)),
          ((16, 16, 16), (1.0, 1.0, 1.0))]


@pytest.mark.parametrize("pin", [True, False])
@pytest.mark.parametrize("shape,extent", SHAPES)
def test_reference_applies_the_ports_assembled_matrix(shape, extent, pin):
    nz, ny, nx = shape
    a = assemble_poisson(Grid3D(nx, ny, nz, lx=extent[0], ly=extent[1], lz=extent[2]), pin=pin)[0]
    csr = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
    x = torch.randn(shape, dtype=torch.float64, generator=torch.Generator().manual_seed(7))
    ref = Poisson7(shape, extent, pin=pin)
    want = torch.as_tensor(csr @ x.reshape(-1).numpy())
    for block in (1, 2, 32):
        got = torch.cat([ref.apply(x, z0, min(z0 + block, nz)) for z0 in range(0, nz, block)]).reshape(-1)
        assert torch.max(torch.abs(got - want)) <= 1e-13 * torch.max(torch.abs(want))


def test_reference_applies_the_ports_device_stencil():
    grid = Grid3D(12, 10, 8)
    op = poisson_stencil_device(grid, device="cpu")[0]
    x = torch.randn(grid.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    rnorm, _ = Poisson7(grid.shape).residual(x, op.mv(x))
    assert rnorm <= 1e-13 * float(torch.linalg.vector_norm(op.mv(x)))


@pytest.mark.parametrize("route", ["stencil", "aij"])
def test_reference_judges_the_ports_solves(route):
    config = {"grid": [16, 16, 16], "extent": [1.0, 1.0, 1.0], "pin": True, "route": route, "precision": "mixed",
              "ksp": {"ksp_type": "cg", "pc_type": "gamg", "rtol": 1e-8, "atol": 1e-12, "maxiter": 10000,
                      "layout": "padded" if route == "stencil" else "auto"},
              "gamg": {"nsmooths": 1, "threshold": 0.0, "smoother": "chebyshev", "degree": 2}}
    mix = {"field_seed": 5, "modes": 8, "wavenumber_max": 8, "scale_exponent": 8, "noise_share": 0.01}
    sys_ = spec.load_problem("poisson7").build(config, "cpu")
    ref = Poisson7(sys_.shape)
    for step in range(3):
        b = rhs.make_rhs(mix, sys_.shape, 11, step, device="cpu")
        res = sys_.ksp.solve(sys_.encode(b))
        rnorm, bnorm = ref.residual(res.x, b)
        assert res.reason > 0 and rnorm / bnorm <= 1e-8
        # the port's own float64 residual agrees with the reference's
        assert abs(res.resnorm - rnorm) <= 1e-6 * bnorm


def test_rhs_is_mean_free_and_scaled_by_powers_of_two():
    mix = {"field_seed": 5, "modes": 8, "wavenumber_max": 8, "scale_exponent": 8, "noise_share": 0.01}
    shape = (10, 12, 14)
    fields = {seed: [rhs.make_rhs(mix, shape, seed, step, device="cpu") for step in range(6)] for seed in (21, 22)}
    for b in fields[21]:
        assert abs(float(b.mean())) <= 1e-12 * float(b.abs().max())
    # every step a field of its own ...
    flat = torch.stack([b.reshape(-1) / torch.linalg.vector_norm(b) for b in fields[21]])
    cos = (flat @ flat.T).abs() - torch.eye(len(flat), dtype=flat.dtype)
    assert float(cos.max()) < 0.9
    # ... and every seed the same fields, each under a sign and a power of two of its own
    for a, b in zip(fields[21], fields[22]):
        i = int(torch.argmax(b.abs()))
        r = float(a.reshape(-1)[i] / b.reshape(-1)[i])
        assert torch.equal(a, b * r) and abs(np.log2(abs(r))) % 1 == 0
    # the noise is that share of the smooth part's norm
    smooth = rhs.make_rhs({**mix, "noise_share": 0.0}, shape, 21, 3, device="cpu")
    share = torch.linalg.vector_norm(fields[21][3] - smooth) / torch.linalg.vector_norm(smooth)
    assert abs(float(share) - 0.01) <= 1e-12

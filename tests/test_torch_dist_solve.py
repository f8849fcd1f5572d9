"""``solve_poisson(16, n_devices=4, ...)`` in one process (W = 1: all four
blocks here) against the JAX package's ``solve_poisson(..., n_devices=4)``
on its virtual mesh, for the option sets the JAX driver runs there as its
GSPMD program: the plain layout, Chebyshev(3), a degree-1 Chebyshev and a
Richardson(1) smoother, ``-precision f64`` and ``f32``, ``-pc_type
jacobi`` and ``-pc_dtype bf16`` (the port's (z, y) plain route on
``make_mesh(4)`` = (2, 2)), and ``-ksp_type gmres`` and ``chebyshev``.  Each: the same reason, the same outer count
and the inner count within 1, and Linf within ``tests/
test_torch_sharded.py``'s 1e-6 + 1e-3 |Linf| (f64: 1e-10; f32: 1e-4, its
own rounding).  rtol is 1e-6, as there: at 1e-8 the inner count sits on
the f32 floor, where the JAX package's own four-device Chebyshev(3) solve
takes 14 inner against its one- and two-device 17 (and mixed-precision
GMRES 13 against 17: the Krylov cases run in f64).

The aij, filtered-level-0, p = 2 / 8 and refusal cases are in
``test_torch_dist_routes.py``; the same solves on gloo ranks in
``test_torch_multihost.py``.
"""

import numpy as np
import pytest
import torch

from tpusparse.amg.hierarchy import AMGParams as JAMGParams
from tpusparse.bench.driver import solve_poisson as j_solve_poisson
from tpusparse_torch import kernels
from tpusparse_torch.amg.hierarchy import AMGParams
from tpusparse_torch.bench.driver import solve_poisson


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# (id, solve_poisson's options, AMGParams fields, Linf tolerance or None for
# 1e-6 + 1e-3 |Linf|)
CASES = [
    ("plain", dict(layout="plain"), {}, None),
    ("chebyshev3", {}, dict(degree=3), None),
    ("chebyshev1", {}, dict(degree=1), None),
    ("richardson1", {}, dict(smoother="richardson", degree=1), None),
    ("f64", dict(precision="f64"), {}, 1e-10),
    ("f32", dict(precision="f32"), {}, 1e-4),
    ("jacobi", dict(pc="jacobi"), {}, None),
    ("bf16", dict(pc_dtype="bf16"), {}, None),
    ("pc-none", dict(pc="none"), {}, None),
    # the plain-only GAMG options; level 0's block-Jacobi sub-PC dropped as
    # JAX's shard_hierarchy drops it (ROADMAP §3)
    ("bjacobi-levels", {}, dict(bjacobi_bs=4), None),
    ("sor-smoother", {}, dict(smoother="sor"), None),
    ("lu-coarse", {}, dict(coarse_solve="lu"), None),
    # the Krylov shells' reductions: GMRES's CGS2 products, Chebyshev's
    # start vector from global indices
    ("gmres", dict(ksp="gmres", precision="f64"), {}, 1e-10),
    ("chebyshev-ksp", dict(ksp="chebyshev", precision="f64"), {}, 1e-10),
]


def check_against_jax(n, p, kw, params, tol, route):
    """One case: the port at W = 1 against the JAX package on ``p`` of its
    virtual devices."""
    kw = dict(rtol=1e-6, **kw)
    kernels.reset_launches()
    got = solve_poisson(n, n_devices=p, device="cpu", view=True,
                        amg_params=AMGParams(**params) if params else None, **kw)
    assert not any(kernels.LAUNCHES.values())   # CPU tensors: the twins
    want = j_solve_poisson(n, n_devices=p, amg_params=JAMGParams(**params) if params else None, **kw)
    assert got.reason == want.reason == 2
    assert got.outer_iters == want.outer_iters and abs(got.iters - want.iters) <= 1
    tol = 1e-6 + 1e-3 * abs(want.linf_error) if tol is None else tol
    assert abs(got.linf_error - want.linf_error) < tol
    assert (got.z_shards, got.ranks, got.sharded_route) == (p, 1, route)
    return got


@pytest.mark.parametrize("kw, params, tol", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_gspmd_options_match_jax_at_four_blocks(kw, params, tol):
    got = check_against_jax(16, 4, kw, params, tol, "(z, y) plain")
    assert got.mesh == [2, 2] and "(z, y) mesh 2 x 2 of 8 x 8-plane blocks on one device" in got.solver_view

"""Two mismatches with the JAX package that ROADMAP §3 logged without a test,
each held here on the CPU with its resolution.

- ``-ksp_type pipecg -precision f32 -pc_dtype bf16`` at 18^3 stalls in both
  packages from the third iteration.  From the twelfth on, gamma = <r, u> is
  f32 rounding noise (|gamma| < 5e-7 against ||r|| ||u|| of 13-18; ||r||
  194.3 in JAX, 217.2 in the port, ||u|| 0.068 / 0.084, the bf16 V-cycle's
  output never zero): where the port's sum lands on exactly 0, beta is 0/0
  and the solve ends with DIVERGED_NANORINF (-9), where JAX's does not it
  runs to maxiter (-3).  Rounding alone: both are held to a negative
  reason, JAX's pinned.
- The standalone PCs on the structure-blind aij route: under ``jit`` XLA
  fuses ``DIA.mv`` into another rounding than its eager form, which the
  port's twin equals bitwise, so the port is held to JAX's solve run under
  ``jax.disable_jit()``.  With Jacobi the counts are equal.  Without a
  preconditioner the second outer sweep starts from the first's f32 floor,
  a residual of rounding noise whose unpreconditioned CG count follows the
  dots' summation order (``jnp.vdot`` and ``torch.dot`` already part in
  ||b||'s last digits): 160 against 201 inner at 18^3, 281 against 280 at
  24^3, so that case is held to 25% of JAX's count.
"""

import jax
import pytest
import torch

from tpusparse.bench.driver import DivergedError as JDivergedError
from tpusparse.bench.driver import solve_poisson as j_solve_poisson
from tpusparse_torch.bench.driver import DivergedError, solve_poisson


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_pipecg_bf16_stall_ends_negative_in_both():
    kw = dict(ksp="pipecg", precision="f32", pc_dtype="bf16", maxiter=25, rtol=1e-8, atol=1e-12)
    with pytest.raises(JDivergedError, match=r"Diverged reason: -3$"):
        j_solve_poisson(18, **kw)
    with pytest.raises(DivergedError, match=r"Diverged reason: -(3|9)$"):
        solve_poisson(18, device="cpu", **kw)


@pytest.mark.parametrize("n", [18, 24])
@pytest.mark.parametrize("pc, window", [("jacobi", 0.0), ("none", 0.25)])
def test_aij_standalone_pc_counts_match_jax_eager(n, pc, window):
    kw = dict(mat_type="aij", structure_detect=False, pc=pc, rtol=1e-8, atol=1e-12)
    got = solve_poisson(n, device="cpu", **kw)
    with jax.disable_jit():
        want = j_solve_poisson(n, warmup=False, **kw)
    assert (got.reason, got.outer_iters) == (want.reason, want.outer_iters)
    assert got.reason == 2
    assert abs(got.iters - want.iters) <= window * want.iters
    assert got.linf_error == pytest.approx(want.linf_error, abs=1e-6)

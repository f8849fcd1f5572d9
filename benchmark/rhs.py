"""The one traffic generator: right-hand sides of the pressure equation.

A mix file (``traffic/<mix>.json``) gives its parameters:

- ``modes``, ``wavenumber_max``, ``field_seed``: the smooth part of step
  i's right-hand side is a sum of ``modes`` products cos(kx pi x) cos(ky
  pi y) cos(kz pi z) over the cell centres, each k drawn from 1 ..
  ``wavenumber_max`` and each amplitude from a standard normal, by a
  generator seeded by (``field_seed``, i).  These are eigenvectors of the
  Neumann Laplacian on the grid, so each has mean zero over the cells;
- ``noise_share``: white noise drawn on the device by a
  ``torch.Generator`` seeded by (``field_seed``, i), its mean taken out,
  scaled to that share of the smooth part's 2-norm and added;
- ``scale_exponent``: the field is then multiplied by a sign and a power
  of two 2^e, e in -``scale_exponent`` .. ``scale_exponent``, drawn from
  (seed, i).

So every step solves a field of its own, and every seed solves the same
sequence of fields: the seed sets only each field's sign and scale, which
CG from x0 = 0 under a relative gate follows exactly (a power of two
scales without rounding), so the work of a run does not depend on its
seed.  A mean-free right-hand side keeps the pinned system away from its
one small eigenvalue (the constant mode), as a discrete divergence is.

The other keys are the harness's: ``warmup_steps`` (untimed steps in
set-up), ``sample`` (how many solved right-hand sides the check keeps, a
reservoir sample drawn from the seed) and ``trace_seconds`` (with
``--trace 1``, whole solves are profiled from the window's start until
this many seconds have passed).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

WARMUP = -1  # the step index of the untimed warm-up solve


def stream_seed(*parts) -> int:
    """A 63-bit seed for one draw of the stream, from its parts."""
    digest = hashlib.sha256(":".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_rhs(mix: dict, shape: tuple[int, int, int], seed: int, step: int, *, device) -> torch.Tensor:
    """The (nz, ny, nx) float64 right-hand side of (``seed``, ``step``) on
    ``device``."""
    rng = np.random.default_rng(stream_seed(mix["field_seed"], "field", step))
    modes, kmax = int(mix["modes"]), int(mix["wavenumber_max"])
    ks = rng.integers(1, kmax + 1, size=(modes, 3))  # (kz, ky, kx) a mode
    amps = torch.as_tensor(rng.standard_normal(modes), dtype=torch.float64, device=device)

    def cosines(axis: int, n: int) -> torch.Tensor:  # (modes, n)
        c = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
        k = torch.as_tensor(ks[:, axis], dtype=torch.float64, device=device)
        return torch.cos(math.pi * k[:, None] * c[None, :])

    nz, ny, nx = shape
    zy = (amps[:, None, None] * cosines(0, nz)[:, :, None] * cosines(1, ny)[:, None, :]).reshape(modes, nz * ny)
    b = (zy.T @ cosines(2, nx)).reshape(shape)  # the sum of the modes, one matrix product
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(mix["field_seed"], "noise", step))
    noise = torch.randn(shape, dtype=torch.float64, device=device, generator=gen)
    noise -= noise.mean()
    noise *= float(mix["noise_share"]) * torch.linalg.vector_norm(b) / torch.linalg.vector_norm(noise)
    b += noise
    del noise
    e = int(mix["scale_exponent"])
    sign, power = np.random.default_rng(stream_seed(seed, "scale", step)).integers(-e, e + 1, size=2)
    return b.mul_((-1.0 if sign < 0 else 1.0) * 2.0 ** int(power))

"""Structure detection: lift an assembled general (MATAIJ) matrix onto the
structured route when it is a constant-coefficient 7-point star — port of
``tpusparse/sparse/starlift.py``.

The reference benchmarks one matrix class: the DMDA 7-point Poisson operator
forced into generic CSR (``DMSetMatType(MATAIJ)``).  ``star_lift`` proves
from the assembled bands that the matrix is a star with one constant per
axis, an arbitrary diagonal field and, optionally, the ``MatZeroRowsColumns``
pin on row/column 0; the driver then runs the stencil route's kernels
(K1-K4) instead of the banded K5.

The proof is exact: bitwise equality against the candidate constants, on
the f64 value hi + lo of a two-float ``DFDIA``.  Any deviation (a variable
leg, asymmetric legs, a nonzero at a domain-wrap position that the star's
zero fill would drop) returns None and the matrix keeps the general route.
The bands are promoted one at a time, so the check holds one f64 band at
once (seven would be 1.5 GB at 300^3), and the result comes to the host in
one read.
"""

from __future__ import annotations

import torch

from tpusparse_torch.sparse.dia import DFDIA, DIA
from tpusparse_torch.sparse.stencil import StarStencil3D


def _axis_masks(shape, device):
    """{flat offset: interior-validity mask} for a (gz, gy, gx) grid in
    natural ordering, each broadcastable to the grid.  Deliberately an
    independent encoding of the star's legs (not
    ``StarStencil3D.flat_band_fields``): the proof checks the matrix
    against what the stencil apply will do, so reusing its own mask code
    would make the proof circular."""
    gz, gy, gx = shape
    k = torch.arange(gz, device=device)[:, None, None]
    j = torch.arange(gy, device=device)[None, :, None]
    i = torch.arange(gx, device=device)[None, None, :]
    return {
        1: i < gx - 1,
        -1: i > 0,
        gx: j < gy - 1,
        -gx: j > 0,
        gx * gy: k < gz - 1,
        -gx * gy: k > 0,
    }


def _check_bands(hi, lo, offsets, shape):
    """Decide star-liftability of the (K, n) bands ``hi`` (+ ``lo``) in
    f64: ``(verdict, diag)`` with ``verdict`` the f64 device vector (ok,
    pinned, cx, cy, cz) and ``diag`` the f64 diagonal field.

    ``ok`` requires, for each +-u leg pair of each axis, one shared
    constant on the structurally valid mask (less the pin positions when
    pinned) and exact zeros everywhere else in the band.
    """
    gz, gy, gx = shape
    dev = hi.device
    ki = {o: k for k, o in enumerate(offsets)}

    def band(o):
        # a copy even of f64 bands (the diagonal returned must not keep
        # the (K, n) storage alive); lo is added in place, promoted
        v = hi[ki[o]].to(torch.float64, copy=True)
        if lo is not None:
            v += lo[ki[o]]
        return v.reshape(shape)

    def entry(o, r):
        v = hi[ki[o], r].to(torch.float64)
        return v + lo[ki[o], r].to(torch.float64) if lo is not None else v

    masks = _axis_masks(shape, dev)
    # the pin pattern (MatZeroRowsColumns on row/col 0): A[0, o] == 0 for
    # every o > 0 leg and A[-o, 0] == 0 for every o < 0 leg
    pinned = torch.ones((), dtype=torch.bool, device=dev)
    for o in masks:
        pinned = pinned & (entry(o, 0 if o > 0 else -o) == 0)

    ok = torch.ones((), dtype=torch.bool, device=dev)
    cs = []
    for u in (1, gx, gx * gy):
        c_axis = None
        for o in (u, -u):
            v = band(o)
            # the pin position of this band: row 0 for an upper leg, the
            # row -o (the origin's +o neighbour) for a lower one
            pin = torch.zeros(gz * gy * gx, dtype=torch.bool, device=dev)
            pin[0 if o > 0 else -o] = True
            use = masks[o] & ~(pin.reshape(shape) & pinned)
            # candidate constant: the first used entry
            c = v.reshape(-1)[torch.argmax(use.reshape(-1).to(torch.uint8))]
            ok = ok & torch.where(use, v == c, v == 0).all()
            if c_axis is None:
                c_axis = c
            else:
                ok = ok & (c_axis == c)
            del v
        cs.append(c_axis)
    verdict = torch.stack([ok.to(torch.float64), pinned.to(torch.float64), *cs])
    return verdict, band(0)


def star_lift(op_lo, op_hi, shape):
    """Try to lift banded operators onto ``StarStencil3D``.

    ``op_lo``: the f32 :class:`DIA` the hierarchy would be built on.
    ``op_hi``: the outer operator, a :class:`DFDIA` (mixed precision: its
    f64 value hi + lo is what is proved and lifted) or a :class:`DIA`
    (uniform precision; may be ``op_lo`` itself).  ``shape``: the (gz, gy,
    gx) grid.

    Returns ``(star_hi, star_lo)`` or None when the matrix is not an exact
    constant-coefficient star.  ``star_hi`` is f64 for a ``DFDIA``, else in
    the bands' dtype; ``star_lo`` takes the f32 bands' diagonal and the
    constants rounded to f32, and is ``star_hi`` itself when ``op_lo is
    op_hi``.  The fields are copies: the bands can be dropped afterwards.
    """
    gz, gy, gx = shape
    offsets = tuple(op_lo.offsets)
    star_offs = {0, 1, -1, gx, -gx, gx * gy, -gx * gy}
    if min(gx, gy, gz) < 2:
        return None
    # a missing leg means a zero axis coefficient: possible, but not the
    # benchmark class; keep the lift conservative
    if set(offsets) != star_offs or len(offsets) != len(star_offs):
        return None
    if op_lo.shape[0] != gz * gy * gx:
        return None
    if isinstance(op_hi, DFDIA):
        hi, lo = op_hi.hi, op_hi.lo
    elif isinstance(op_hi, DIA):
        hi, lo = op_hi.bands, None
    else:
        return None
    if tuple(op_hi.offsets) != offsets:
        return None

    verdict, diag = _check_bands(hi, lo, offsets, (gz, gy, gx))
    ok, pinned, cx, cy, cz = verdict.tolist()  # the one host read
    if not ok:
        return None
    pinned = bool(pinned)
    kd = offsets.index(0)
    hi_dtype = torch.float64 if isinstance(op_hi, DFDIA) else hi.dtype

    def rounded(c, dtype):
        return torch.tensor(c, dtype=torch.float64).to(dtype).item()

    star_hi = StarStencil3D(
        diag=diag.to(hi_dtype),
        cx=rounded(cx, hi_dtype), cy=rounded(cy, hi_dtype), cz=rounded(cz, hi_dtype),
        pinned=pinned,
    )
    if op_lo is op_hi:
        return star_hi, star_hi
    # the f32 twin copies the f32 bands' diagonal: for a DFDIA, hi is
    # float32(A) by the two-float split
    lo_bands = op_hi.hi if isinstance(op_hi, DFDIA) else op_lo.bands
    star_lo = StarStencil3D(
        diag=lo_bands[kd].reshape(gz, gy, gx).clone(),
        cx=rounded(cx, lo_bands.dtype), cy=rounded(cy, lo_bands.dtype),
        cz=rounded(cz, lo_bands.dtype), pinned=pinned,
    )
    return star_hi, star_lo

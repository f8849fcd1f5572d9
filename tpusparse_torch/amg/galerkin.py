"""Galerkin coarse operators A_c = P^T A P by exact probing — port of
``tpusparse/amg/galerkin.py``.

A_c is known a priori to be a 27-point ``VarStencil27``, so its
coefficients are probed exactly with 27 comb vectors: comb (a,b,c) is the
indicator of the coarse cells p with ``p % 3 == (a,b,c)``; A_c has radius 1
and comb members are 3 apart, so

    coef[offset][p] = y[p + offset]        for p in the comb,  y = A_c e.

Each probe is restrict(A(prolong(e))): at level 0 that is three K1 launches,
81 for the level.
"""

from __future__ import annotations

import torch

from tpusparse_torch.sparse.varstencil import OFFSETS, VarStencil27, pad1, shifted_view


def galerkin_coarse(fine_op, dinv, transfer, dtype=None) -> VarStencil27:
    """Build A_c = P^T A P as a VarStencil27 via 27-comb probing.

    ``fine_op``: fine-level operator (PaddedStar or VarStencil27);
    ``dinv``: fine diagonal inverse field; ``transfer``: StructuredTransfer
    or PaddedTransfer.
    """
    c_shape = tuple(transfer.c_shape)
    dt = dtype or dinv.dtype
    dev = dinv.device

    def residue(axis):
        n = c_shape[axis]
        view = [1, 1, 1]
        view[axis] = n
        return (torch.arange(n, dtype=torch.int64, device=dev) % 3).reshape(view)

    kz, jy, ix = residue(0), residue(1), residue(2)
    coef = torch.zeros((27,) + c_shape, dtype=dt, device=dev)
    for comb in range(27):
        a, rem = divmod(comb, 9)
        b, c = divmod(rem, 3)
        mask = (kz == a) & (jy == b) & (ix == c)
        e = mask.to(dt)
        y = transfer.restrict(
            fine_op, dinv, fine_op.mv(transfer.prolong(fine_op, dinv, e))
        )
        yp = pad1(y)
        for o, off in enumerate(OFFSETS):
            coef[o] = torch.where(mask, shifted_view(yp, off, c_shape), coef[o])
    return VarStencil27(coef=coef)

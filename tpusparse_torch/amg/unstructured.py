"""GAMG setup for general (aij) matrices — port of the geometric,
device-resident route of ``tpusparse/amg/unstructured.py::gamg_setup_unstructured``.

When the fine matrix's sparsity pattern reveals a 3-D grid
(``amg/geo.py::infer_grid3d``), the whole hierarchy is built on the device
by ``gamg_setup_geo`` from the fine DIA alone, in its dtype: f32 under
mixed precision, the solve's dtype under uniform precision.  The JAX
package's other routes (greedy Vanek aggregation with factored or ELL
transfers, the banded ``amg/deviceagg.py`` setup, HybridDIA/ELL level
containers, and the block-Jacobi level smoother on aij, which leaves the
geometric route for the greedy one) are ROADMAP queue 1, item 9.2, and
raise ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusparse_torch.amg.geo import gamg_setup_geo, infer_grid3d
from tpusparse_torch.amg.hierarchy import AMGParams, Hierarchy
from tpusparse_torch.sparse.csr import HostCSR
from tpusparse_torch.sparse.dia import DIA

_ITEM_9_2 = "is not ported to tpusparse_torch yet (ROADMAP queue 1, item 9.2)"


def gamg_setup_unstructured(
    a: HostCSR | None, params: AMGParams = AMGParams(), dtype=None, *, fine_op=None,
    device="cuda",
) -> Hierarchy:
    """The AMG hierarchy of the general matrix ``a`` (a HostCSR, or None
    when ``fine_op`` is given), as the JAX package's signature has it.

    ``fine_op``: the fine level's DIA already on its device (the aij
    driver's f32 bands, which the two-float outer operator aliases), or a
    ``DFDIA`` (uniform f64 on the two-float operator); its
    offsets stand for the matrix's diagonals, so they are not recomputed
    from ``a`` (a pass over 2 nnz int64 at 300^3).  Without it the fine
    DIA is built from ``a`` on ``device`` in ``dtype`` (a numpy dtype;
    default the matrix's).  With both, ``dtype`` must be ``fine_op``'s.
    """
    if params.coarse_solve not in ("jacobi", "lu"):
        raise ValueError(f"unknown coarse_solve {params.coarse_solve!r} (jacobi | lu)")
    if params.nsmooths < 0:
        raise ValueError(f"nsmooths must be >= 0, got {params.nsmooths}")
    if params.smoother == "sor":
        raise ValueError(
            "smoother='sor' (multicolor GS) needs colorable grid operators;"
            " the DIA levels have no coloring"
        )
    if fine_op is not None and not hasattr(fine_op, "offsets"):
        raise NotImplementedError(f"a fine operator of type {type(fine_op).__name__} {_ITEM_9_2}")
    if a is None and fine_op is None:
        raise ValueError("pass the host matrix a or the fine_op DIA")
    if params.bjacobi_bs != 0:
        # the JAX package leaves the geometric route for the greedy host
        # setup here (tpusparse/amg/unstructured.py:286-291, :420-440)
        raise NotImplementedError(
            f"the block-Jacobi level smoother (bjacobi_bs) on aij, which runs the greedy host setup, {_ITEM_9_2}"
        )
    if fine_op is not None:
        offsets, n = fine_op.offsets, fine_op.n_rows
    else:
        if not isinstance(a, HostCSR):
            a = HostCSR.from_scipy(a)
        rows = np.repeat(np.arange(a.n_rows, dtype=np.int64), a.row_nnz())
        offsets, n = tuple(np.unique(a.indices.astype(np.int64) - rows).tolist()), a.n_rows
    geo_shape = infer_grid3d(offsets, n)
    if geo_shape is None:
        raise NotImplementedError(
            f"aggregation of a sparsity pattern that is not a 3-D grid (the greedy and banded routes) {_ITEM_9_2}"
        )
    if fine_op is None:
        fine_op = DIA.from_csr(a, dtype=dtype, device=device)
    elif dtype is not None and fine_op.dtype != torch.from_numpy(np.zeros(0, dtype)).dtype:
        raise ValueError(f"fine_op dtype {fine_op.dtype} != requested {np.dtype(dtype)}")
    return gamg_setup_geo(fine_op, geo_shape, params)

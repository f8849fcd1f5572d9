"""GAMG setup for general (aij) matrices — port of the geometric,
device-resident route of ``tpusparse/amg/unstructured.py::gamg_setup_unstructured``.

When the fine DIA's sparsity pattern reveals a 3-D grid
(``amg/geo.py::infer_grid3d``), the whole hierarchy is built on the device
by ``gamg_setup_geo``: no host matrix at any level.  The JAX package's
other routes (greedy Vanek aggregation with factored or ELL transfers, the
banded ``amg/deviceagg.py`` setup, HybridDIA/ELL level containers and
block-Jacobi smoothers) are not ported yet (ROADMAP queue 9) and raise.
"""

from __future__ import annotations

from tpusparse_torch.amg.geo import gamg_setup_geo, infer_grid3d
from tpusparse_torch.amg.hierarchy import AMGParams, Hierarchy
from tpusparse_torch.sparse.dia import DIA

_QUEUE9 = "is not ported to tpusparse_torch yet (ROADMAP queue 9)"


def gamg_setup_unstructured(fine_op: DIA, params: AMGParams = AMGParams()) -> Hierarchy:
    """Build the AMG hierarchy of the general matrix whose fine-level
    operator is the DIA ``fine_op`` (already on its device, in the
    hierarchy's dtype)."""
    if params.nsmooths < 0:
        raise ValueError(f"nsmooths must be >= 0, got {params.nsmooths}")
    if params.smoother == "sor":
        raise ValueError(
            "smoother='sor' (multicolor GS) needs colorable grid operators;"
            " the DIA levels have no coloring"
        )
    if not isinstance(fine_op, DIA):
        raise NotImplementedError(f"a fine operator of type {type(fine_op).__name__} {_QUEUE9}")
    if params.bjacobi_bs != 0:
        raise NotImplementedError(f"the block-Jacobi smoother (bjacobi_bs) {_QUEUE9}")
    geo_shape = infer_grid3d(fine_op.offsets, fine_op.n_rows)
    if geo_shape is None:
        raise NotImplementedError(f"aggregation of a non-grid sparsity pattern {_QUEUE9}")
    return gamg_setup_geo(fine_op, geo_shape, params)

"""Sparse containers: the stencil operators and the padded-resident layout,
the host CSR and its PETSc binary I/O, the COO, BSR and DIA families and
the padded ELL: the exports of ``tpusparse/sparse/__init__.py`` but
``PallasDIA`` and the two-float ``StarStencilDF`` (ROADMAP "Not to
port")."""

from tpusparse_torch.sparse.bsr import BSR
from tpusparse_torch.sparse.coo import COO
from tpusparse_torch.sparse.csr import HostCSR
from tpusparse_torch.sparse.dia import DIA
from tpusparse_torch.sparse.ell import ELL
from tpusparse_torch.sparse.io import (
    load_matrix,
    load_petsc_mat,
    load_petsc_vec,
    save_petsc_mat,
    save_petsc_vec,
)
from tpusparse_torch.sparse.padded import PaddedStar, crop_field, pad_field
from tpusparse_torch.sparse.stencil import StarStencil3D
from tpusparse_torch.sparse.varstencil import VarStencil27

__all__ = [
    "BSR",
    "COO",
    "HostCSR",
    "DIA",
    "ELL",
    "PaddedStar",
    "StarStencil3D",
    "VarStencil27",
    "crop_field",
    "pad_field",
    "load_matrix",
    "load_petsc_mat",
    "load_petsc_vec",
    "save_petsc_mat",
    "save_petsc_vec",
]

"""PETSc binary viewer I/O — ``MatLoad`` / ``VecLoad`` parity; port of
``tpusparse/sparse/io.py``.

PETSc users dump operators with ``-ksp_view_mat binary`` /
``MatView(PETSC_VIEWER_BINARY)`` and reload them with ``MatLoad`` (KSP
tutorial ``ex10.c``, "solve a linear system read from a file").  This
module reads and writes that on-disk format, byte for byte the files the
JAX package writes:

Matrix object (SeqAIJ storage, every field big-endian):

    int32   MAT_FILE_CLASSID (1211216)
    int32   M (rows)
    int32   N (cols)
    int32   nnz (total nonzeros)
    int32   row_lengths[M]
    int32   column_indices[nnz]     (0-based, ascending within a row)
    float64 values[nnz]

Vector object:

    int32   VEC_FILE_CLASSID (1211214)
    int32   n
    float64 values[n]

A file may hold several objects back to back (ex10's convention: the
matrix, then optionally the right-hand side); ``read_petsc_objects`` walks
them in order.  ``load_matrix`` also reads MatrixMarket ``.mtx`` files
through scipy.  Everything here is numpy on the host.
"""

from __future__ import annotations

import os

import numpy as np

from tpusparse_torch.sparse.csr import HostCSR

__all__ = [
    "MAT_FILE_CLASSID",
    "VEC_FILE_CLASSID",
    "save_petsc_mat",
    "load_petsc_mat",
    "save_petsc_vec",
    "load_petsc_vec",
    "read_petsc_objects",
    "load_matrix",
]

MAT_FILE_CLASSID = 1211216
VEC_FILE_CLASSID = 1211214

_I = np.dtype(">i4")   # PetscInt (32-bit build), big-endian
_S = np.dtype(">f8")   # PetscScalar (real, double), big-endian


def save_petsc_mat(path: str, a) -> None:
    """MatView(binary): write ``a`` (HostCSR, scipy sparse or a dense
    array) in PETSc's binary matrix format."""
    if not isinstance(a, HostCSR):
        import scipy.sparse as sp

        a = HostCSR.from_scipy(sp.csr_matrix(a if sp.issparse(a) else np.asarray(a)))
    m, n = a.shape
    nnz = a.nnz
    if max(m, n, nnz) >= 2**31:
        raise ValueError(
            f"PETSc classic binary format carries 32-bit ints; matrix {m}x{n} nnz={nnz} does not fit"
        )
    with open(path, "wb") as f:
        np.asarray([MAT_FILE_CLASSID, m, n, nnz], dtype=_I).tofile(f)
        np.asarray(a.row_nnz(), dtype=_I).tofile(f)
        np.asarray(a.indices, dtype=_I).tofile(f)
        np.asarray(a.data, dtype=_S).tofile(f)


def save_petsc_vec(path: str, v, append: bool = False) -> None:
    """VecView(binary): write a 1-D array; ``append=True`` adds the object
    after the ones already in the file (ex10's matrix-then-rhs file)."""
    v = np.asarray(v, dtype=np.float64).reshape(-1)
    with open(path, "ab" if append else "wb") as f:
        np.asarray([VEC_FILE_CLASSID, v.size], dtype=_I).tofile(f)
        v.astype(_S).tofile(f)


def _read_exact(f, dtype, count: int) -> np.ndarray:
    out = np.fromfile(f, dtype=dtype, count=count)
    if out.size != count:
        raise ValueError(f"truncated PETSc binary file: wanted {count} x {dtype}, got {out.size}")
    return out


def _read_mat(f) -> HostCSR:
    m, n, nnz = (int(x) for x in _read_exact(f, _I, 3))
    if min(m, n) < 0 or nnz < 0:
        raise ValueError(
            f"bad PETSc matrix header (M={m}, N={n}, nnz={nnz}); dense/non-AIJ storage is not supported"
        )
    row_nnz = _read_exact(f, _I, m).astype(np.int64)
    if row_nnz.min(initial=0) < 0 or int(row_nnz.sum()) != nnz:
        raise ValueError("row lengths do not sum to the header nnz")
    indices = _read_exact(f, _I, nnz).astype(np.int32)
    if nnz and (indices.min() < 0 or indices.max() >= n):
        raise ValueError("column index out of range")
    data = _read_exact(f, _S, nnz).astype(np.float64)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(row_nnz, out=indptr[1:])
    return HostCSR(indptr=indptr, indices=indices, data=data, shape=(m, n))


def _read_vec(f) -> np.ndarray:
    (n,) = (int(x) for x in _read_exact(f, _I, 1))
    if n < 0:
        raise ValueError(f"bad PETSc vector header (n={n})")
    return _read_exact(f, _S, n).astype(np.float64)


def read_petsc_objects(path: str) -> list:
    """Every object in a PETSc binary file, in file order (``HostCSR`` for
    a matrix, a 1-D ``np.ndarray`` for a vector)."""
    out: list = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        while f.tell() < size:
            (classid,) = (int(x) for x in _read_exact(f, _I, 1))
            if classid == MAT_FILE_CLASSID:
                out.append(_read_mat(f))
            elif classid == VEC_FILE_CLASSID:
                out.append(_read_vec(f))
            else:
                raise ValueError(
                    f"unknown PETSc object classid {classid} at byte {f.tell() - 4}"
                    f" (matrix={MAT_FILE_CLASSID}, vector={VEC_FILE_CLASSID})"
                )
    return out


def load_petsc_mat(path: str) -> HostCSR:
    """MatLoad: the first matrix object in ``path``."""
    for obj in read_petsc_objects(path):
        if isinstance(obj, HostCSR):
            return obj
    raise ValueError(f"no matrix object in {path}")


def load_petsc_vec(path: str) -> np.ndarray:
    """VecLoad: the first vector object in ``path``."""
    for obj in read_petsc_objects(path):
        if not isinstance(obj, HostCSR):
            return obj
    raise ValueError(f"no vector object in {path}")


def load_matrix(path: str) -> tuple[HostCSR, np.ndarray | None]:
    """A system from ``path``: (matrix, rhs or None).

    A PETSc binary file may carry the right-hand side after the matrix
    (ex10's layout); a MatrixMarket ``.mtx``/``.mtx.gz`` file carries the
    matrix only.
    """
    if path.endswith((".mtx", ".mtx.gz", ".mm")):
        import scipy.io as sio
        import scipy.sparse as sp

        return HostCSR.from_scipy(sp.csr_matrix(sio.mmread(path))), None
    objs = read_petsc_objects(path)
    mat = next((o for o in objs if isinstance(o, HostCSR)), None)
    if mat is None:
        raise ValueError(f"no matrix object in {path}")
    rhs = next((o for o in objs if not isinstance(o, HostCSR)), None)
    if rhs is not None and rhs.size != mat.shape[0]:
        raise ValueError(f"rhs length {rhs.size} != matrix rows {mat.shape[0]}")
    return mat, rhs

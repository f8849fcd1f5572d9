"""ctypes bindings of the host setup engine, ``csrc/native.cpp`` — the port's
own copy of the JAX package's native engine (greedy aggregation, CSR
SpGEMM and transpose: the Galerkin product P^T A P of the greedy GAMG
route; the reverse Cuthill-McKee order of ``sparse/reorder.py``; the f64
CSR matvec and the 7-point Poisson assembly).

The library is built with g++ at first use into ``csrc/build/``
(``kernels/_build.py::build_native``).  There is no fallback: when it
cannot be built, every entry point but ``available`` raises (the JAX
package falls back to numpy or returns None), since the pure-Python twins
(``amg/unstructured.py::_greedy_aggregate_py``, a scipy product) take
minutes at a million rows.  The twins stay for the tests.  RCM has no
twin: scipy's ``reverse_cuthill_mckee`` gives another order, and the
greedy aggregates, hence the iteration counts, follow the order.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpusparse_torch.kernels import _build
from tpusparse_torch.sparse.csr import HostCSR

_lib: ctypes.CDLL | None = None

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def lib() -> ctypes.CDLL:
    """The loaded engine (built at the first call)."""
    global _lib
    if _lib is None:
        lib_ = ctypes.CDLL(str(_build.build_native()))
        i64 = ctypes.c_int64
        lib_.tps_greedy_aggregate.argtypes = [i64, _I64P, _I32P, _U8P, _I64P]
        lib_.tps_greedy_aggregate.restype = i64
        lib_.tps_spgemm_symbolic.argtypes = [i64, i64, _I64P, _I32P, _I64P, _I32P, _I64P]
        lib_.tps_spgemm_symbolic.restype = None
        lib_.tps_spgemm_numeric.argtypes = [
            i64, i64, _I64P, _I32P, _F64P, _I64P, _I32P, _F64P, _I64P, _I32P, _F64P,
        ]
        lib_.tps_spgemm_numeric.restype = None
        lib_.tps_csr_transpose.argtypes = [i64, i64, _I64P, _I32P, _F64P, _I64P, _I32P, _F64P]
        lib_.tps_csr_transpose.restype = None
        lib_.tps_rcm_order.argtypes = [i64, _I64P, _I32P, _I64P]
        lib_.tps_rcm_order.restype = None
        lib_.tps_csr_spmv_f64.argtypes = [i64, _I64P, _I32P, _F64P, _F64P, _F64P]
        lib_.tps_csr_spmv_f64.restype = None
        f64 = ctypes.c_double
        lib_.tps_assemble_poisson7.argtypes = [i64, i64, i64, f64, f64, f64, _I64P, _I32P, _F64P]
        lib_.tps_assemble_poisson7.restype = None
        _lib = lib_
    return _lib


def available() -> bool:
    """Whether the engine builds and loads here (it is built on this call
    if it was not yet)."""
    try:
        lib()
    except (RuntimeError, OSError):
        return False
    return True


def _arrays(a: HostCSR):
    return (
        np.ascontiguousarray(a.indptr, np.int64),
        np.ascontiguousarray(a.indices, np.int32),
        np.ascontiguousarray(a.data, np.float64),
    )


def spmv(a: HostCSR, x: np.ndarray) -> np.ndarray:
    """y = A @ x in f64."""
    if x.shape != (a.shape[1],):
        raise ValueError(f"x shape {x.shape} != ({a.shape[1]},)")
    ip, ix, dt = _arrays(a)
    y = np.empty(a.n_rows, np.float64)
    lib().tps_csr_spmv_f64(a.n_rows, ip, ix, dt, np.ascontiguousarray(x, np.float64), y)
    return y


def assemble_poisson7(nx: int, ny: int, nz: int, dx: float, dy: float, dz: float) -> HostCSR:
    """The 7-point all-Neumann Laplacian on an ``nx`` x ``ny`` x ``nz`` grid
    with spacings ``dx``, ``dy``, ``dz`` (the reference's generateA,
    ``src/helper.cpp:161-246``), natural order, columns sorted."""
    n = nx * ny * nz
    indptr = np.empty(n + 1, np.int64)
    indices = np.empty(7 * n, np.int32)
    data = np.empty(7 * n, np.float64)
    lib().tps_assemble_poisson7(nx, ny, nz, dx, dy, dz, indptr, indices, data)
    nnz = int(indptr[n])
    return HostCSR(indptr=indptr, indices=indices[:nnz], data=data[:nnz], shape=(n, n))


def spgemm(a: HostCSR, b: HostCSR) -> HostCSR:
    """C = A @ B in f64, columns sorted."""
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    a_ip, a_ix, a_dt = _arrays(a)
    b_ip, b_ix, b_dt = _arrays(b)
    c_ip = np.empty(m + 1, np.int64)
    lib().tps_spgemm_symbolic(m, n, a_ip, a_ix, b_ip, b_ix, c_ip)
    c_ix = np.empty(int(c_ip[m]), np.int32)
    c_dt = np.empty(int(c_ip[m]), np.float64)
    lib().tps_spgemm_numeric(m, n, a_ip, a_ix, a_dt, b_ip, b_ix, b_dt, c_ip, c_ix, c_dt)
    return HostCSR(indptr=c_ip, indices=c_ix, data=c_dt, shape=(m, n))


def transpose(a: HostCSR) -> HostCSR:
    """A^T in f64, columns sorted."""
    m, n = a.shape
    ip, ix, dt = _arrays(a)
    b_ip = np.empty(n + 1, np.int64)
    b_ix = np.empty(ix.size, np.int32)
    b_dt = np.empty(ix.size, np.float64)
    lib().tps_csr_transpose(m, n, ip, ix, dt, b_ip, b_ix, b_dt)
    return HostCSR(indptr=b_ip, indices=b_ix, data=b_dt, shape=(n, m))


def ptap(p: HostCSR, a: HostCSR) -> HostCSR:
    """The Galerkin product P^T (A P) (PETSc's MatPtAP)."""
    return spgemm(transpose(p), spgemm(a, p))


def aggregate(a: HostCSR, strong: np.ndarray) -> tuple[np.ndarray, int]:
    """Greedy Vanek aggregation over the strong mask (a bool per entry of
    ``a.indices``): (aggregate ids int64[n], count)."""
    agg = np.empty(a.n_rows, np.int64)
    count = lib().tps_greedy_aggregate(
        a.n_rows, np.ascontiguousarray(a.indptr, np.int64), np.ascontiguousarray(a.indices, np.int32),
        np.ascontiguousarray(strong, np.uint8), agg,
    )
    return agg, int(count)


def rcm(a: HostCSR) -> np.ndarray:
    """The reverse Cuthill-McKee order of a structurally symmetric
    pattern: int64[n] with perm[new] = old."""
    perm = np.empty(a.n_rows, np.int64)
    lib().tps_rcm_order(
        a.n_rows, np.ascontiguousarray(a.indptr, np.int64), np.ascontiguousarray(a.indices, np.int32), perm,
    )
    return perm

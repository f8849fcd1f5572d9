"""PETSc binary I/O (``sparse/io.py``, MatLoad/VecLoad parity): the port's
files are byte for byte the JAX package's, each package reads the other's,
MatrixMarket files load alike, and malformed files raise JAX's errors."""

import gzip

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

from tpusparse.sparse import io as j_io
from tpusparse.sparse.csr import HostCSR as JHostCSR
from tpusparse_torch.sparse import io
from tpusparse_torch.sparse.csr import HostCSR


def _random_csr(m, n, density=0.3, seed=0):
    rng = np.random.default_rng(seed)
    a = sp.random(m, n, density=density, random_state=rng, format="csr")
    a.data = rng.standard_normal(a.nnz)
    return a


MATRICES = {
    "random": lambda: _random_csr(37, 23),
    "square": lambda: _random_csr(40, 40, density=0.1, seed=2),
    "empty rows": lambda: sp.csr_matrix(
        (np.array([5.0, -1.0]), (np.array([1, 3]), np.array([0, 2]))), shape=(4, 3)
    ),
    "dense": lambda: np.array([[2.0, 0.0], [-1.0, 3.0]]),
    "no entries": lambda: sp.csr_matrix((3, 3)),
}


def _as(pkg_csr, a):
    """``a`` as the given package's HostCSR where it is a scipy matrix."""
    return pkg_csr.from_scipy(a) if sp.issparse(a) else a


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("host", [False, True])
def test_files_are_byte_identical(tmp_path, name, host):
    """The same matrix (as a scipy/dense input, or as each package's
    HostCSR) and two appended vectors write the same bytes."""
    a = MATRICES[name]()
    mine, theirs = str(tmp_path / "t.petsc"), str(tmp_path / "j.petsc")
    rng = np.random.default_rng(1)
    v, w = rng.standard_normal(np.shape(a)[0]), np.arange(5.0)
    io.save_petsc_mat(mine, _as(HostCSR, a) if host else a)
    j_io.save_petsc_mat(theirs, _as(JHostCSR, a) if host else a)
    for path, pkg in ((mine, io), (theirs, j_io)):
        pkg.save_petsc_vec(path, v, append=True)
        pkg.save_petsc_vec(path, w, append=True)
    assert open(mine, "rb").read() == open(theirs, "rb").read()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_files(tmp_path, writer):
    a = _random_csr(29, 31, seed=4)
    x = np.random.default_rng(5).standard_normal(29)
    path = str(tmp_path / "s.petsc")
    pkg = j_io if writer == "jax" else io
    pkg.save_petsc_mat(path, a)
    pkg.save_petsc_vec(path, x, append=True)
    mine, theirs = io.read_petsc_objects(path), j_io.read_petsc_objects(path)
    assert len(mine) == len(theirs) == 2
    assert isinstance(mine[0], HostCSR) and mine[0].shape == theirs[0].shape == (29, 31)
    for field in ("indptr", "indices", "data"):
        got, want = getattr(mine[0], field), getattr(theirs[0], field)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mine[1], theirs[1])
    np.testing.assert_array_equal(io.load_petsc_vec(path), x)
    np.testing.assert_array_equal(io.load_petsc_mat(path).data, a.data)
    mat, rhs = io.load_matrix(path)
    np.testing.assert_array_equal(rhs, x)
    np.testing.assert_array_equal(mat.to_dense(), a.toarray())


@pytest.mark.parametrize("suffix", [".mtx", ".mtx.gz"])
def test_matrix_market_loads_as_in_jax(tmp_path, suffix):
    a = _random_csr(19, 19, seed=6)
    sio.mmwrite(str(tmp_path / "a.mtx"), a)
    path = str(tmp_path / f"a{suffix}")
    if suffix == ".mtx.gz":
        with open(tmp_path / "a.mtx", "rb") as src, gzip.open(path, "wb") as dst:
            dst.write(src.read())
    (mine, rhs), (theirs, jrhs) = io.load_matrix(path), j_io.load_matrix(path)
    assert rhs is None and jrhs is None
    np.testing.assert_array_equal(mine.indptr, theirs.indptr)
    np.testing.assert_array_equal(mine.indices, theirs.indices)
    np.testing.assert_array_equal(mine.data, theirs.data)


def _bad_files(tmp_path):
    """(label, path) of malformed PETSc files, each written with numpy."""
    i4 = np.dtype(">i4")
    out = {}

    def write(label, *parts):
        path = str(tmp_path / f"{label}.petsc")
        with open(path, "wb") as f:
            for dt, vals in parts:
                np.asarray(vals, dtype=dt).tofile(f)
        out[label] = path

    write("classid", (i4, [1234567, 2, 2, 0]))
    write("truncated header", (i4, [io.MAT_FILE_CLASSID, 2]))
    write("truncated values", (i4, [io.MAT_FILE_CLASSID, 2, 2, 2, 1, 1, 0, 1]), (">f8", [1.0]))
    write("negative rows", (i4, [io.MAT_FILE_CLASSID, -2, 2, 0]))
    write("row lengths", (i4, [io.MAT_FILE_CLASSID, 2, 2, 3, 1, 1, 0, 1]), (">f8", [1.0, 2.0]))
    write("column range", (i4, [io.MAT_FILE_CLASSID, 2, 2, 2, 1, 1, 0, 5]), (">f8", [1.0, 2.0]))
    write("negative vector", (i4, [io.VEC_FILE_CLASSID, -1]))
    write("truncated vector", (i4, [io.VEC_FILE_CLASSID, 3]), (">f8", [1.0]))
    write("vector only", (i4, [io.VEC_FILE_CLASSID, 1]), (">f8", [1.0]))
    write("rhs length", (i4, [io.MAT_FILE_CLASSID, 1, 1, 1, 1, 0]), (">f8", [2.0]),
          (i4, [io.VEC_FILE_CLASSID, 2]), (">f8", [1.0, 1.0]))
    return out


BAD = ["classid", "truncated header", "truncated values", "negative rows", "row lengths",
       "column range", "negative vector", "truncated vector", "vector only", "rhs length"]


@pytest.mark.parametrize("label", BAD)
def test_malformed_files_raise_jax_errors(tmp_path, label):
    """``load_matrix`` (read_petsc_objects, the rhs check) raises JAX's
    ValueError with JAX's message on each malformed file."""
    path = _bad_files(tmp_path)[label]
    with pytest.raises(ValueError) as want:
        j_io.load_matrix(path)
    with pytest.raises(ValueError) as got:
        io.load_matrix(path)
    assert str(got.value) == str(want.value)


def test_load_errors_without_the_object(tmp_path):
    path = _bad_files(tmp_path)["vector only"]
    for pkg in (io, j_io):
        with pytest.raises(ValueError, match="no matrix object"):
            pkg.load_petsc_mat(path)
    path = str(tmp_path / "m.petsc")
    io.save_petsc_mat(path, sp.eye(3, format="csr"))
    for pkg in (io, j_io):
        with pytest.raises(ValueError, match="no vector object"):
            pkg.load_petsc_vec(path)


def test_exact_byte_layout(tmp_path):
    """The on-disk format is PETSc's documented layout: big-endian int32
    [classid, M, N, nnz], row lengths, column indices, f64 values."""
    path = str(tmp_path / "p.petsc")
    io.save_petsc_mat(path, sp.csr_matrix(np.array([[2.0, 0.0], [-1.0, 3.0]])))
    raw = open(path, "rb").read()
    np.testing.assert_array_equal(np.frombuffer(raw[:32], dtype=">i4"), [io.MAT_FILE_CLASSID, 2, 2, 3, 1, 2, 0, 0])
    np.testing.assert_array_equal(np.frombuffer(raw[36:], dtype=">f8"), [2.0, -1.0, 3.0])

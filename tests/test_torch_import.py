"""The PyTorch port stands alone: no module of ``tpusparse_torch`` imports
JAX, and its kernel wrappers refuse what their kernels do not take."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import tpusparse_torch
from tpusparse_torch import kernels
from tpusparse_torch.kernels import _build
from tpusparse_torch.kernels.fused7 import fused7_mvdot
from tpusparse_torch.kernels.stencil7 import padded_shape, star7_mv_padded

PKG = pathlib.Path(tpusparse_torch.__file__).parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the suite runs under several xdist workers
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 16
    bad = {
        str(f.relative_to(PKG)): m
        for f in files for m in _imported_modules(f)
        if m == "jax" or m.startswith(("jax.", "jaxlib", "tpusparse.")) or m == "tpusparse"
    }
    assert not bad, f"JAX imports in the port: {bad}"


@pytest.mark.parametrize(
    "module",
    ["__main__", "config/options.py", "config/__init__.py", "solve/simple.py",
     "solve/chebyshev.py", "solve/pipelined.py", "solve/gmres.py", "solve/fgmres.py",
     "solve/bcgs.py", "solve/minres.py", "ksp.py", "solve/multi.py", "solve/checkpoint.py",
     "solve/__init__.py", "__init__.py", "sparse/io.py", "sparse/coo.py", "sparse/bsr.py",
     "sparse/reorder.py", "sparse/__init__.py", "bench/__init__.py",
     # item 9.2: the containers, the setup engine and the two setups
     "sparse/ell.py", "sparse/dia.py", "native.py", "amg/unstructured.py", "amg/deviceagg.py",
     "bench/deviceaggbench.py"],
)
def test_cli_and_ksp_modules_are_scanned_and_import(module):
    """The CLI, the options database, the Krylov family and the file
    route's modules are among the files test_port_imports_no_jax scans,
    and each imports on its own."""
    import importlib

    path = PKG / (module if module.endswith(".py") else f"{module}.py")
    assert path in set(PKG.rglob("*.py"))
    name = "tpusparse_torch." + module.removesuffix(".py").replace("/", ".")
    importlib.import_module(name.removesuffix(".__init__"))


def test_chip_smoke_imports_no_jax():
    for m in _imported_modules(PKG.parent / "chip_smoke.py"):
        assert not (m == "jax" or m.startswith(("jax.", "tpusparse."))), m


def test_kernel_sources_present():
    names = {p.name for p in _build.sources()}
    assert {"stencil7.cu", "fused7.cu", "diaband.cu"} <= names
    assert "-use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.parametrize(
    "shape, want",
    [((300, 300, 300), (306, 300, 300)), ((40, 11, 13), (46, 11, 16)),
     ((12, 12, 12), (18, 12, 12))],
)
def test_padded_shape(shape, want):
    assert padded_shape(shape) == want


def _operands(shape, dtype=torch.float32):
    f = torch.zeros(padded_shape(shape), dtype=dtype)
    return f, f.clone()


@pytest.mark.parametrize("wrapper", [star7_mv_padded, fused7_mvdot])
def test_wrappers_refuse_bad_operands(wrapper):
    shape = (6, 5, 7)
    diag, x = _operands(shape)
    with pytest.raises(TypeError):
        wrapper(diag.double(), 1.0, 1.0, 1.0, x.double(), shape, True)
    with pytest.raises(ValueError):
        wrapper(diag, 1.0, 1.0, 1.0, x[:-1], shape, True)
    strided = torch.zeros(tuple(reversed(x.shape))).permute(2, 1, 0)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(diag, 1.0, 1.0, 1.0, strided, shape, True)
    with pytest.raises(ValueError):
        wrapper(diag.to("meta"), 1.0, 1.0, 1.0, x.to("meta"), shape, True)


def test_cpu_tensors_run_the_twin_and_count_nothing():
    kernels.reset_launches()
    shape = (6, 5, 7)
    diag, x = _operands(shape)
    diag += 1.0
    x[3:-3, :, :7] = torch.from_numpy(
        np.random.default_rng(0).standard_normal((6, 5, 7), dtype=np.float32)
    )
    y = star7_mv_padded(diag, 0.5, 0.25, 0.125, x, shape, False)
    assert y.device.type == "cpu"
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_build_rebuilds_only_when_a_source_changes(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build._digest()
    src.write_text("// two\n")
    assert _build._digest() != first
    src.write_text("// one\n")
    assert _build._digest() == first
    # an up-to-date library is loaded as it is: nvcc is not asked
    lib = tmp_path / "build" / f"libtpusparse_torch_{first}.so"
    lib.parent.mkdir()
    lib.write_bytes(b"")

    def no_nvcc():
        raise AssertionError("rebuilt an up-to-date library")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert _build.build() == lib

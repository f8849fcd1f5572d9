"""Build and load the CUDA kernels: nvcc into a shared library with a plain C
interface, loaded with ctypes.

The host setup engine ``csrc/native.cpp`` (plain C++, no CUDA) is built
the same way by ``build_native`` with g++, for ``tpusparse_torch/native.py``.

At first use, every ``csrc/*.cu`` is compiled for ``sm_90a`` by an nvcc
of its own, all started together, and the objects are linked into one
library under ``csrc/build/`` (listed in ``.gitignore``).  The library's
file name carries a hash of the sources and flags, so a changed source is
rebuilt and an unchanged one is loaded as it is.  Including no PyTorch
header keeps a build at seconds, not minutes.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0.  Pointers and
the stream travel as ``c_void_p``: a bare Python int would be cut to 32
bits.  No ``-use_fast_math``: ``1.0f / d`` stays IEEE division, as in the
JAX kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# ctypes argument codes for ``kernel`` signatures
P = ctypes.c_void_p   # device pointer or stream
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float

_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")


def _built(lib: Path, compile_to) -> Path:
    """``lib``, made by ``compile_to(path)`` unless it exists: written
    under a temporary name and renamed, so a concurrent reader never sees
    half a file.  An exclusive lock on ``csrc/build/.lock`` holds the
    check and the build, so ranks that start together build once: the
    first builds, the others wait and load its library."""
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        try:
            compile_to(tmp)
        except RuntimeError:
            tmp.unlink(missing_ok=True)
            raise
        os.replace(tmp, lib)
    return lib


def build() -> Path:
    """Path of the kernel library, compiling it when its sources changed."""
    return _built(BUILD_DIR / f"libtpusparse_torch_{_digest()}.so", lambda out: _compile(sources(), out))


def _compile(srcs: list[Path], out: Path) -> None:
    """Compile each of ``srcs`` to an object with an nvcc of its own, all
    started together, and link the objects into the shared library
    ``out``; raise with nvcc's messages when a step fails."""
    nvcc = _nvcc()
    objs = [out.with_name(f"{out.name}.{src.stem}.o") for src in srcs]
    try:
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)
        ]
        outputs = [proc.communicate()[0] for proc in procs]   # waits for each
        errors = [f"{src.name}:\n{output}" for src, proc, output in zip(srcs, procs, outputs)
                  if proc.returncode != 0]
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(out), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link with code {link.returncode}:\n{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


NATIVE_SRC = CSRC / "native.cpp"
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


def build_native() -> Path:
    """Path of the host setup engine (``csrc/native.cpp``, plain C++ for
    the CPU), compiled with g++ into ``csrc/build/`` when its source or
    flags changed; raise with g++'s messages when it fails."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(NATIVE_SRC.read_bytes())

    def gxx(out: Path) -> None:
        exe = shutil.which("g++") or shutil.which("c++")
        if exe is None:
            raise RuntimeError("g++ not found on PATH: the setup engine (csrc/native.cpp) cannot be built")
        proc = subprocess.run([exe, *GXX_FLAGS, "-o", str(out), str(NATIVE_SRC)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed with code {proc.returncode}:\n{proc.stderr}")

    return _built(BUILD_DIR / f"libtpusparse_torch_native_{h.hexdigest()[:16]}.so", gxx)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.tps_error_string.argtypes = [I]
        lib.tps_error_string.restype = ctypes.c_char_p
        lib.tps_block_size.argtypes = []
        lib.tps_block_size.restype = I
        _lib = lib
    return _lib


def launch(name: str, argtypes: list, device: torch.device, *args) -> None:
    """Call entry point ``name`` (declared with ``argtypes``) with ``args``
    and the current stream of ``device``; raise if the launch reported an
    error."""
    fn = getattr(library(), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = I
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = library().tps_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def block_size() -> int:
    """Threads per block of every kernel (one dot partial per block)."""
    return library().tps_block_size()

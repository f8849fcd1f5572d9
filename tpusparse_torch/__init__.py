"""tpusparse_torch — the PyTorch/CUDA port of tpusparse for NVIDIA Hopper.

The package mirrors ``tpusparse``'s module paths and names (so
``tpusparse_torch/amg/hierarchy.py::vcycle`` is the counterpart of
``tpusparse/amg/hierarchy.py::vcycle``) and covers the JAX package's
one-device solves of the manufactured 3D Poisson problem and of a system
read from a PETSc binary file: ``bench.driver.solve_poisson(n,
device=...)``, ``bench.driver.solve_from_file`` and the CLI — a Krylov method
preconditioned by structured or geometric GAMG (or a standalone PC) under
f64 defect correction, or in uniform precision.

Plain tensor code is eager PyTorch.  Every TPU kernel of the JAX package
has a hand-written CUDA C++ counterpart for ``sm_90a`` (``csrc/``: K1-K16,
K1p, K3z/K4z and K5, and the batched K1p and K5), built with nvcc at first use and bound with ctypes
(``kernels/_build.py``).  Every kernel wrapper
dispatches by tensor device only: a CPU tensor runs the kernel's plain
PyTorch twin, a CUDA tensor launches the kernel or raises.

The object API is the JAX package's: ``KSP`` (``ksp.py``, PETSc's
KSPSetOperators / KSPSetUp / KSPSolve / KSPMatSolve) over ``Grid3D`` and
``StarStencil3D``, the DIA family or a ``HostCSR`` (``sparse/csr.py``,
read from PETSc binary files by ``sparse/io.py``).  Importing the package
builds no kernel and touches no CUDA device.

The package imports ``torch`` and numpy, never ``jax``.
"""

__version__ = "0.1.0"

from tpusparse_torch.grid.grid3d import Grid3D
from tpusparse_torch.ksp import KSP, KSPResult
from tpusparse_torch.sparse.csr import HostCSR
from tpusparse_torch.sparse.ell import ELL
from tpusparse_torch.sparse.stencil import StarStencil3D

__all__ = ["ELL", "Grid3D", "HostCSR", "KSP", "KSPResult", "StarStencil3D", "__version__"]

"""tpusparse_torch — the PyTorch/CUDA port of tpusparse for NVIDIA Hopper.

The package mirrors ``tpusparse``'s module paths and names (so
``tpusparse_torch/amg/hierarchy.py::vcycle`` is the counterpart of
``tpusparse/amg/hierarchy.py::vcycle``) and covers the headline solve:
``bench.driver.solve_poisson(n, pc="gamg", device=...)`` — the manufactured
3D Poisson problem, CG + structured GAMG with a fused fine-level V-cycle,
under f64 defect correction.

Plain tensor code is eager PyTorch.  The four kernels on that path are
hand-written CUDA C++ for ``sm_90a`` (``csrc/``), built with nvcc at first
use and bound with ctypes (``kernels/_build.py``).  Every kernel wrapper
dispatches by tensor device only: a CPU tensor runs the kernel's plain
PyTorch twin, a CUDA tensor launches the kernel or raises.

The package imports ``torch`` and numpy, never ``jax``.
"""

__version__ = "0.1.0"

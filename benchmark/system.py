"""The system under test: ``tpusparse_torch``'s ``KSP`` on a configuration's
operator, built on the device by the configuration's problem
(``problems/<family>.py``), and what every problem shares.
"""

from __future__ import annotations

import dataclasses

import torch

from tpusparse_torch import KSP, Grid3D
from tpusparse_torch.amg.hierarchy import AMGParams

DTYPES = {"mixed": torch.float64, "f64": torch.float64, "f32": torch.float32}


@dataclasses.dataclass
class System:
    ksp: KSP
    shape: tuple[int, int, int]  # (nz, ny, nx)
    flat: bool                   # the route takes flat vectors
    dtype: torch.dtype           # of b and x

    def encode(self, b: torch.Tensor) -> torch.Tensor:
        """A float64 (nz, ny, nx) right-hand side in the form ``solve`` takes."""
        b = b.to(self.dtype)
        return b.reshape(-1) if self.flat else b

    def describe(self) -> str:
        """One line on the route the solves take (for the log)."""
        hier = getattr(self.ksp, "_pc_state", None)
        levels = getattr(hier, "levels", ())
        parts = [f"{type(lev.op).__name__}{tuple(lev.dinv.shape)}" for lev in levels]
        return (f"KSP {self.ksp.ksp_type}/{self.ksp.pc_type} precision {self.ksp.precision}, outer"
                f" {type(self.ksp._op).__name__}, inner {type(self.ksp._op_lo).__name__},"
                f" {len(parts)} levels: {' '.join(parts)}")


def grid_of(config: dict) -> Grid3D:
    nx, ny, nz = config["grid"]
    lx, ly, lz = config.get("extent", (1.0, 1.0, 1.0))
    return Grid3D(nx, ny, nz, lx=lx, ly=ly, lz=lz)


def new_ksp(config: dict, precision: str) -> KSP:
    """``KSP`` with the configuration's options: ``ksp`` (``ksp_type``,
    ``pc_type``, ``rtol``, ``atol``, ``maxiter``, ``layout``, taken under
    mixed precision only) and ``gamg`` (``AMGParams``' fields)."""
    opts = config["ksp"]
    return KSP(
        ksp_type=opts["ksp_type"], pc_type=opts["pc_type"], rtol=opts["rtol"], atol=opts["atol"],
        maxiter=opts["maxiter"], precision=precision, amg_params=AMGParams(**config["gamg"]),
        layout=opts["layout"] if precision == "mixed" else "auto",
    )

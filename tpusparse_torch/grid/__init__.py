"""Structured grid and the manufactured Poisson problem."""

from tpusparse_torch.grid.grid3d import Grid3D

__all__ = ["Grid3D"]

"""The solve drivers: the manufactured Poisson system and a system read
from a file."""

from tpusparse_torch.bench.driver import SolveReport, solve_from_file, solve_poisson

__all__ = ["solve_poisson", "solve_from_file", "SolveReport"]

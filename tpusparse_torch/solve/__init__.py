"""Krylov solvers: CG and mixed-precision defect correction."""

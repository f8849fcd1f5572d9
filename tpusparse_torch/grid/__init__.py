"""Structured grid and the manufactured Poisson problem."""

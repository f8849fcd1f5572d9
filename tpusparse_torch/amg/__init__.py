"""Structured smoothed-aggregation multigrid."""

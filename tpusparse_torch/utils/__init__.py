"""Utilities of the port: profiling (``profiling.py``)."""

"""Chebyshev ephemeris tables, their CUDA evaluation kernel, and the query facade."""

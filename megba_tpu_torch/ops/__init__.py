"""Geometry, residual engine, compensated sums and the segment kernels."""

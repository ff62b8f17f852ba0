"""Schur-complement PCG and its block-Jacobi preconditioner."""

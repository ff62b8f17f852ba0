"""Solve observability: the per-iteration trace."""

"""Schur normal-equation assembly."""

"""Seeded fault injection for the guarded solve (faults.py)."""

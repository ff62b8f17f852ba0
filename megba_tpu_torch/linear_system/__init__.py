"""Schur normal-equation assembly."""

from megba_tpu_torch.linear_system.builder import (
    SchurSystem,
    build_schur_system,
    damp_blocks,
    weight_system_inputs,
)

__all__ = [
    "SchurSystem",
    "build_schur_system",
    "damp_blocks",
    "weight_system_inputs",
]

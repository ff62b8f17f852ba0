"""Geometry, residual engine, compensated sums and the segment kernels."""

from megba_tpu_torch.ops import geo
from megba_tpu_torch.ops.jet import Jet, seed_jets
from megba_tpu_torch.ops.residuals import (
    bal_residual,
    make_residual_fn,
    make_residual_jacobian_fn,
)

__all__ = [
    "Jet",
    "bal_residual",
    "geo",
    "make_residual_fn",
    "make_residual_jacobian_fn",
    "seed_jets",
]

"""Compensated float32 reductions (PyTorch port of `megba_tpu/ops/accum.py`).

A plain float32 sum over millions of residual terms carries O(n*eps)
relative error, enough to flip LM accept/reject decisions near
convergence.  `comp_sum` keeps float32 storage but recovers every
addition's rounding error with the two-sum error-free transformation and
carries it in a parallel "lo" stream, over the same log-depth halves
tree as the JAX package ([rows, 128] reshape, top half folded onto the
bottom half), so both packages round the same way.  float64 inputs take
the plain sum.

PyTorch does not reassociate floating-point arithmetic in eager mode, so
the two-sum identities survive.
"""

from __future__ import annotations

from typing import Tuple

import torch


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-free transformation: a + b = s + err exactly (Knuth)."""
    s = a + b
    t = s - a
    err = (a - (s - t)) + (b - t)
    return s, err


def _fold(hi: torch.Tensor, lo: torch.Tensor):
    """Fold the leading axis in halves until one entry remains."""
    while hi.shape[0] > 1:
        m = hi.shape[0]
        half = (m + 1) // 2
        top_h, top_l = hi[half:], lo[half:]
        if top_h.shape[0] < half:  # odd: pad the folded half with zeros
            z = torch.zeros((half - top_h.shape[0],) + tuple(hi.shape[1:]),
                            dtype=hi.dtype, device=hi.device)
            top_h = torch.cat([top_h, z])
            top_l = torch.cat([top_l, z])
        s, e = two_sum(hi[:half], top_h)
        lo = lo[:half] + top_l + e
        hi = s
    return hi[0], lo[0]


def comp_sum(x: torch.Tensor) -> torch.Tensor:
    """Compensated sum of all elements of `x` (any shape), in x.dtype."""
    if x.dtype == torch.float64:
        return x.sum()
    flat = x.reshape(-1)
    n = flat.shape[0]
    if n == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    lanes = 128 if n >= 128 else 1
    rows = -(-n // lanes)
    pad = rows * lanes - n
    if pad:
        flat = torch.cat([flat, torch.zeros((pad,), dtype=flat.dtype,
                                            device=flat.device)])
    hi = flat.reshape(rows, lanes)
    hi, lo = _fold(hi, torch.zeros_like(hi))  # rows -> one [lanes] row
    hi, lo = _fold(hi, lo)  # lanes -> scalar
    return hi + lo


def comp_sum_sq(x: torch.Tensor) -> torch.Tensor:
    """Compensated Sum x_i^2 — the residual-norm / cost reduction."""
    return comp_sum(x * x)


def comp_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compensated <a, b>: products round once each, the sum is
    compensated."""
    return comp_sum(a * b)

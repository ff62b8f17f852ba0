"""Geometry ops on feature-major tensors.

PyTorch counterparts of `megba_tpu/ops/geo.py`.  The JAX functions act on
one item and are vmapped; these act on the leading axis directly, so the
same call takes one item (`[3]`) or a whole edge batch (`[3, n]`).
Branches are `torch.where` selects over safe operands, as in the JAX
code, so both sides of the small-angle guard stay finite.
"""

from __future__ import annotations

import torch

# Below this squared angle the Rodrigues formula switches to its
# first-order expansion (the JAX package's threshold).
_SMALL_ANGLE = 1e-12


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product along the leading axis of two [3, ...] tensors."""
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def angle_axis_rotate_point(angle_axis: torch.Tensor,
                            pt: torch.Tensor) -> torch.Tensor:
    """Rotate `pt` [3, ...] by `angle_axis` [3, ...] (Rodrigues form).

    result = pt cos(theta) + (k x pt) sin(theta) + k (k . pt)(1 - cos(theta)),
    with the theta -> 0 limit pt + w x pt.
    """
    theta2 = (angle_axis * angle_axis).sum(0)
    safe = theta2 > _SMALL_ANGLE
    theta2_safe = torch.where(safe, theta2, torch.ones_like(theta2))
    theta = torch.sqrt(theta2_safe)
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    k = angle_axis / theta
    cross = _cross(k, pt)
    dot = (k * pt).sum(0)
    rotated = pt * cos_t + cross * sin_t + k * dot * (1.0 - cos_t)
    approx = pt + _cross(angle_axis, pt)
    return torch.where(safe, rotated, approx)


def radial_distortion(p: torch.Tensor, f: torch.Tensor, k1: torch.Tensor,
                      k2: torch.Tensor) -> torch.Tensor:
    """BAL radial distortion f * (1 + k1 l^2 + k2 l^4) * p, p [2, ...]."""
    n = (p * p).sum(0)
    r = 1.0 + k1 * n + k2 * n * n
    return f * r * p

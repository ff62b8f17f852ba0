"""Geometry ops on feature-major tensors.

PyTorch counterparts of `megba_tpu/ops/geo.py`.  The JAX functions act on
one item and are vmapped; these act on the leading axes directly, so the
same call takes one item (`[3]`, a matrix `[3, 3]`) or a whole edge batch
(`[3, n]`, `[3, 3, n]`).  Branches are `torch.where` selects over safe
operands, as in the JAX code, so both sides of a guard stay finite and
so do their derivatives (a select back-propagates NaN from an unused
branch that saw an unsafe value).
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


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product over the two leading axes, [m, k, ...] x [k, n, ...]
    -> [m, n, ...], each entry summed in ascending k in the operands'
    full precision (the JAX package's `geo.mm`, a HIGHEST-precision
    matmul)."""
    m, k = a.shape[0], a.shape[1]
    n = b.shape[1]
    return torch.stack([
        torch.stack([sum(a[i, j] * b[j, c] for j in range(k))
                     for c in range(n)])
        for i in range(m)])


def skew(v: torch.Tensor) -> torch.Tensor:
    """[3, ...] -> [3, 3, ...] cross-product matrix [v]_x."""
    z = torch.zeros_like(v[0])
    return torch.stack([
        torch.stack([z, -v[2], v[1]]),
        torch.stack([v[2], z, -v[0]]),
        torch.stack([-v[1], v[0], z]),
    ])


def _eye3(like: torch.Tensor) -> torch.Tensor:
    """The 3 x 3 identity broadcast over the batch axes of `like` [...]."""
    one, z = torch.ones_like(like), torch.zeros_like(like)
    return torch.stack([torch.stack([one, z, z]), torch.stack([z, one, z]),
                        torch.stack([z, z, one])])


def angle_axis_to_rotation_matrix(angle_axis: torch.Tensor) -> torch.Tensor:
    """[3, ...] angle-axis -> [3, 3, ...] rotation matrix (Rodrigues,
    with the small-angle branch I + [w]_x)."""
    theta2 = (angle_axis * angle_axis).sum(0)
    safe = theta2 > _SMALL_ANGLE
    theta2_safe = torch.where(safe, theta2, torch.ones_like(theta2))
    theta = torch.sqrt(theta2_safe)
    k = angle_axis / theta
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    K = skew(k)
    eye = _eye3(theta2)
    R = eye + sin_t * K + (1.0 - cos_t) * mm(K, K)
    R_small = eye + skew(angle_axis)
    return torch.where(safe, R, R_small)


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """[4, ...] unit quaternion (w, x, y, z) -> [3, 3, ...] rotation
    matrix (JAX geo.py:121)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])


def drotated_dangle_axis(angle_axis: torch.Tensor,
                         pt: torch.Tensor) -> torch.Tensor:
    """Closed-form d(R(w) pt)/dw, [3, 3, ...] (JAX geo.py:212).

    Gallego & Yezzi (2015):
      d(R x)/dw = -R [x]_x (w w^T + (R^T - I) [w]_x) / theta^2,
    with the theta -> 0 limit -[x]_x.
    """
    theta2 = (angle_axis * angle_axis).sum(0)
    safe = theta2 > _SMALL_ANGLE
    theta2_safe = torch.where(safe, theta2, torch.ones_like(theta2))
    R = angle_axis_to_rotation_matrix(angle_axis)
    W = skew(angle_axis)
    X = skew(pt)
    outer = angle_axis[:, None] * angle_axis[None, :]
    full = -mm(mm(R, X), outer + mm(R.transpose(0, 1) - _eye3(theta2), W)
               ) / theta2_safe
    return torch.where(safe, full, -X)


def rotation2d_to_matrix(theta: torch.Tensor) -> torch.Tensor:
    """[...] angle -> [2, 2, ...] rotation matrix."""
    c = torch.cos(theta)
    s = torch.sin(theta)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v [n, ...] over its length along the leading axis."""
    return v / torch.sqrt(torch.clamp((v * v).sum(0), min=1e-30))


def rotation_matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """[3, 3, ...] rotation matrix -> [4, ...] unit quaternion (w, x, y, z).

    Branch-free Shepperd construction: the four candidate pivots are all
    computed (each with a floored square root) and `torch.argmax` over
    (trace, m00, m11, m22) picks one per item with `torch.where`, the
    first of equal scores as in the JAX package.
    """
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-30))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    c0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)])
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    c1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)])
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    c2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)])
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    c3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3])
    best = torch.argmax(torch.stack([tr, m00, m11, m22]), dim=0)
    q = torch.where(best == 0, c0, torch.where(
        best == 1, c1, torch.where(best == 2, c2, c3)))
    return normalize(q)


def quaternion_to_angle_axis(q: torch.Tensor) -> torch.Tensor:
    """[4, ...] unit quaternion (w, x, y, z) -> [3, ...] angle-axis (the
    SO(3) log), the angle in [0, pi].

    The scale 2 atan2(n, |w|) / n goes through the double-`where` trick:
    below n^2 = 1e-14 the square root and atan2 see n^2 = 1 (a safe
    operand), and the Taylor series 2/w - 2 n^2 / (3 w^3) is selected,
    so the gradient stays finite as n -> 0.  A select whose unused branch
    saw the unsafe value would back-propagate NaN.
    """
    w, vec = q[0], q[1:]
    vec = torch.where(w < 0, -vec, vec)
    w = torch.abs(w)
    n2 = (vec * vec).sum(0)
    small = n2 < 1e-14
    n2_safe = torch.where(small, torch.ones_like(n2), n2)
    n = torch.sqrt(n2_safe)
    w_floor = torch.clamp(w, min=1e-30)
    scale = torch.where(small,
                        2.0 / w_floor - 2.0 * n2 / (3.0 * w_floor ** 3),
                        2.0 * torch.atan2(n, w) / n)
    return scale * vec


def rotation_matrix_to_angle_axis(R: torch.Tensor) -> torch.Tensor:
    """[3, 3, ...] rotation matrix -> [3, ...] angle-axis: the SO(3) log
    map through the branch-free quaternion, differentiable away from the
    pi-rotation cut locus; the inverse of `angle_axis_to_rotation_matrix`."""
    return quaternion_to_angle_axis(rotation_matrix_to_quaternion(R))

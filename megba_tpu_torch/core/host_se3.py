"""Vectorised host-side (numpy) SE(3) helpers.

A copy of `megba_tpu/core/host_se3.py`: quaternion (xyzw) <-> angle-axis
charts with the double-cover fold, quaternion algebra, and batched SE(3)
compose / relative on [..., 6] = [angle_axis, translation] pose arrays.
The chart conventions match `ops/geo.py` (principal branch, small-angle
series).  The sim(3) family builds its host chart maps on them
(factors/sim3.py).
"""

from __future__ import annotations

import numpy as np


def quat_to_aa(q_xyzw: np.ndarray) -> np.ndarray:
    """[..., 4] (qx, qy, qz, qw) -> [..., 3] angle-axis, principal branch.

    angle = 2 atan2(||v||, w) after folding the double cover (w >= 0
    keeps the angle in [0, pi]); the small-angle series
    2/w (1 - ||v||^2 / (3 w^2)) guards ||v|| -> 0.
    """
    q = np.asarray(q_xyzw, np.float64)
    v = q[..., :3]
    w = q[..., 3]
    v = np.where(w[..., None] < 0, -v, v)
    w = np.abs(w)
    s2 = np.einsum("...i,...i->...", v, v)
    s = np.sqrt(s2)
    big = s > 1e-8
    with np.errstate(invalid="ignore", divide="ignore"):
        k_big = 2.0 * np.arctan2(s, w) / np.where(big, s, 1.0)
    w_safe = np.where(w == 0.0, 1.0, w)
    k_small = 2.0 / w_safe * (1.0 - s2 / (3.0 * w_safe * w_safe))
    k = np.where(big, k_big, k_small)
    return v * k[..., None]


def aa_to_quat(aa: np.ndarray) -> np.ndarray:
    """[..., 3] angle-axis -> [..., 4] (qx, qy, qz, qw); the small-angle
    branch uses sin(theta/2)/theta ~= 1/2 - theta^2/48."""
    a = np.asarray(aa, np.float64)
    theta2 = np.einsum("...i,...i->...", a, a)
    theta = np.sqrt(theta2)
    big = theta > 1e-8
    with np.errstate(invalid="ignore", divide="ignore"):
        k_big = np.sin(theta / 2.0) / np.where(big, theta, 1.0)
    k = np.where(big, k_big, 0.5 - theta2 / 48.0)
    return np.concatenate(
        [a * k[..., None], np.cos(theta / 2.0)[..., None]], axis=-1)


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product, xyzw layout, batched."""
    av, aw = a[..., :3], a[..., 3:4]
    bv, bw = b[..., :3], b[..., 3:4]
    v = aw * bv + bw * av + np.cross(av, bv)
    w = aw * bw - np.einsum("...i,...i->...", av, bv)[..., None]
    return np.concatenate([v, w], axis=-1)


def quat_conj(q: np.ndarray) -> np.ndarray:
    return np.concatenate([-q[..., :3], q[..., 3:4]], axis=-1)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vectors [..., 3] by unit quaternions [..., 4] (xyzw)."""
    qv, w = q[..., :3], q[..., 3:4]
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """T_a o T_b on [..., 6] poses ([angle_axis, translation])."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    qa = aa_to_quat(a[..., :3])
    qb = aa_to_quat(b[..., :3])
    aa = quat_to_aa(quat_mul(qa, qb))
    t = quat_rotate(qa, b[..., 3:]) + a[..., 3:]
    return np.concatenate([aa, t], axis=-1)


def relative(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """T_a^{-1} o T_b on [..., 6] poses (the between-factor measurement)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    qa_inv = quat_conj(aa_to_quat(a[..., :3]))
    aa = quat_to_aa(quat_mul(qa_inv, aa_to_quat(b[..., :3])))
    t = quat_rotate(qa_inv, b[..., 3:] - a[..., 3:])
    return np.concatenate([aa, t], axis=-1)

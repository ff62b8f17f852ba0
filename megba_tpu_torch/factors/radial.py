"""Full-intrinsics radial-distortion pinhole.

Counterpart of `megba_tpu/factors/radial.py`: separate focal lengths, a
principal point and k1/k2 as optimisable state, 12 camera dof:

  camera (12) = [angle-axis (3), t (3), fx, fy, cx, cy, k1, k2]
  point  (3)
  obs    (2)  = measured pixel

Projection (BAL minus convention on the normalised plane, then the full
intrinsic map): p = -P[:2]/P[2], d = 1 + k1 |p|^2 + k2 |p|^4,
u = fx d p_x + cx, v = fy d p_y + cy.  On the card its blocks run
kernels 1-3 at (od, d) = (2, 12) and (2, 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from megba_tpu_torch.factors.registry import FactorSpec, FactorTriage
from megba_tpu_torch.ops import geo

CAMERA_DIM = 12
POINT_DIM = 3
OBS_DIM = 2


def radial_residual(camera: torch.Tensor, point: torch.Tensor,
                    obs: torch.Tensor) -> torch.Tensor:
    """2-row full-intrinsics reprojection residual, camera [12, ...],
    point [3, ...], obs [2, ...] -> [2, ...]."""
    w, t = camera[0:3], camera[3:6]
    fx, fy, cx, cy, k1, k2 = (camera[6], camera[7], camera[8],
                              camera[9], camera[10], camera[11])
    P = geo.angle_axis_rotate_point(w, point) + t
    p = -P[0:2] / P[2]
    n = (p * p).sum(0)
    d = 1.0 + k1 * n + k2 * n * n
    uv = torch.stack([fx * d * p[0] + cx, fy * d * p[1] + cy])
    return uv - obs


def _radial_project_depth(cam_blocks: np.ndarray, pt_blocks: np.ndarray,
                          obs: np.ndarray):
    """Host twin of `radial_residual`'s projection + camera-frame depth."""
    from megba_tpu_torch.io.synthetic import rotate_batch

    del obs
    w, t = cam_blocks[:, 0:3], cam_blocks[:, 3:6]
    P = rotate_batch(w, pt_blocks) + t
    with np.errstate(divide="ignore", invalid="ignore"):
        p = -P[:, 0:2] / P[:, 2:3]
        n = np.sum(p * p, axis=1, keepdims=True)
        d = 1.0 + cam_blocks[:, 10:11] * n + cam_blocks[:, 11:12] * n * n
        uv = cam_blocks[:, 6:8] * d * p + cam_blocks[:, 8:10]
    return uv, P[:, 2]


def _radial_centers(cameras: np.ndarray) -> np.ndarray:
    from megba_tpu_torch.io.synthetic import camera_centers

    return camera_centers(cameras)


SPEC = FactorSpec(
    name="pinhole_radial",
    cam_dim=CAMERA_DIM,
    pt_dim=POINT_DIM,
    obs_dim=OBS_DIM,
    residual_dim=2,
    residual_fn=radial_residual,
    triage=FactorTriage(project_depth=_radial_project_depth,
                        uv_cols=(0, 2), camera_centers=_radial_centers),
    description="full-intrinsics pinhole: camera [aa(3), t(3), fx, fy, "
                "cx, cy, k1, k2] with optimisable distortion",
)


@dataclasses.dataclass
class SyntheticRadial:
    """Ground truth + perturbed init for a full-intrinsics scene."""

    cameras_gt: np.ndarray  # [Nc, 12]
    points_gt: np.ndarray
    cameras0: np.ndarray
    points0: np.ndarray
    obs: np.ndarray  # [nE, 2]
    cam_idx: np.ndarray
    pt_idx: np.ndarray


def make_synthetic_radial(
    num_cameras: int = 4,
    num_points: int = 24,
    obs_per_point: int = 3,
    pixel_noise: float = 0.3,
    param_noise: float = 1e-2,
    seed: int = 0,
    dtype: np.dtype = np.float64,
) -> SyntheticRadial:
    """A well-posed full-intrinsics scene (the JAX package's generator:
    the same draws from the same seed; observations from the model)."""
    r = np.random.default_rng(seed)
    obs_per_point = min(obs_per_point, num_cameras)

    points_gt = r.uniform(-1.0, 1.0, size=(num_points, 3))
    cameras_gt = np.zeros((num_cameras, 12))
    cameras_gt[:, 0:3] = r.normal(scale=0.05, size=(num_cameras, 3))
    cameras_gt[:, 3:5] = r.normal(scale=0.2, size=(num_cameras, 2))
    cameras_gt[:, 5] = -5.0 + r.normal(scale=0.2, size=num_cameras)
    cameras_gt[:, 6] = 500.0 + r.normal(scale=5.0, size=num_cameras)  # fx
    cameras_gt[:, 7] = 495.0 + r.normal(scale=5.0, size=num_cameras)  # fy
    cameras_gt[:, 8] = r.normal(scale=2.0, size=num_cameras)  # cx
    cameras_gt[:, 9] = r.normal(scale=2.0, size=num_cameras)  # cy
    cameras_gt[:, 10] = 0.05 + r.normal(scale=5e-3, size=num_cameras)  # k1
    cameras_gt[:, 11] = -0.01 + r.normal(scale=1e-3, size=num_cameras)  # k2

    base = r.integers(0, num_cameras, size=(num_points, 1))
    stride = 1 + r.integers(0, max(num_cameras // max(obs_per_point, 1), 1),
                            size=(num_points, 1))
    cam_idx = ((base + np.arange(obs_per_point)[None, :] * stride)
               % num_cameras).reshape(-1)
    pt_idx = np.repeat(np.arange(num_points), obs_per_point)
    missing = np.setdiff1d(np.arange(num_cameras), cam_idx)
    if missing.size:
        cam_idx = np.concatenate([cam_idx, missing])
        pt_idx = np.concatenate(
            [pt_idx, r.integers(0, num_points, size=missing.size)])

    uv, _ = _radial_project_depth(cameras_gt[cam_idx], points_gt[pt_idx],
                                  None)
    obs = uv + r.normal(scale=pixel_noise, size=uv.shape)

    order = np.argsort(cam_idx, kind="stable")
    scale = np.array([1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
                      20.0, 20.0, 2.0, 2.0, 5e-3, 5e-4])
    cameras0 = cameras_gt + r.normal(
        scale=param_noise, size=cameras_gt.shape) * scale
    points0 = points_gt + r.normal(scale=param_noise, size=points_gt.shape)
    return SyntheticRadial(
        cameras_gt=cameras_gt.astype(dtype),
        points_gt=points_gt.astype(dtype),
        cameras0=cameras0.astype(dtype),
        points0=points0.astype(dtype),
        obs=obs[order].astype(dtype),
        cam_idx=cam_idx[order].astype(np.int32),
        pt_idx=pt_idx[order].astype(np.int32),
    )

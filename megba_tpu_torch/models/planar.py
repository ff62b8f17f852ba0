"""Planar (2D) bundle adjustment model family.

Counterpart of `megba_tpu/models/planar.py`.  A camera is an SE(2) pose
plus focal length, [theta, tx, ty, f]; points are 2D; each observation
is the 1D image coordinate of a point on the camera's image line:

    p_cam = R(theta) X + t        (geo.rotation2d_to_matrix)
    u     = f * p_cam[0] / p_cam[1]
    r     = u - obs

camera_dim 4, point_dim 2, obs_dim 1: the same LM / Schur-PCG machinery
as BAL at other block widths, whose kernels on the card are kernels 1-3
at (od, d) = (1, 4) and (1, 2).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from megba_tpu_torch.ops import geo

CAMERA_DIM = 4
POINT_DIM = 2
OBS_DIM = 1


def residual(camera: torch.Tensor, point: torch.Tensor,
             obs: torch.Tensor) -> torch.Tensor:
    """1D reprojection residual, camera [4, ...], point [2, ...],
    obs [1, ...] -> [1, ...]."""
    theta = camera[0]
    t = camera[1:3]
    f = camera[3]
    R = geo.rotation2d_to_matrix(theta)
    p = geo.mm(R, point[:, None])[:, 0] + t
    return f * p[0:1] / p[1:2] - obs


@dataclasses.dataclass
class SyntheticPlanar:
    """Ground truth + perturbed init for a synthetic planar scene."""

    cameras_gt: np.ndarray
    points_gt: np.ndarray
    cameras0: np.ndarray
    points0: np.ndarray
    obs: np.ndarray
    cam_idx: np.ndarray
    pt_idx: np.ndarray


def make_synthetic_planar(
    num_cameras: int = 6,
    num_points: int = 40,
    obs_per_point: int = 3,
    noise: float = 0.1,
    param_noise: float = 2e-2,
    seed: int = 0,
    dtype=np.float64,
) -> SyntheticPlanar:
    """Points in a strip ahead of +y-looking cameras along the x axis
    (the JAX package's generator, the same draws from the same seed).
    The observations come from the model itself (the residual at obs 0),
    evaluated in float64 on the CPU."""
    r = np.random.default_rng(seed)
    obs_per_point = min(obs_per_point, num_cameras)
    points_gt = np.stack(
        [r.uniform(-2, 2, num_points), r.uniform(4, 8, num_points)], axis=1)
    cameras_gt = np.zeros((num_cameras, 4))
    cameras_gt[:, 0] = r.normal(scale=0.05, size=num_cameras)  # heading
    cameras_gt[:, 1] = np.linspace(-1, 1, num_cameras)  # tx along a rail
    cameras_gt[:, 2] = r.normal(scale=0.05, size=num_cameras)  # ty
    cameras_gt[:, 3] = 300.0 + r.normal(scale=3.0, size=num_cameras)

    base = r.integers(0, num_cameras, size=(num_points, 1))
    stride = 1 + r.integers(0, max(num_cameras // max(obs_per_point, 1), 1),
                            size=(num_points, 1))
    cam_idx = ((base + np.arange(obs_per_point)[None, :] * stride)
               % num_cameras).reshape(-1)
    pt_idx = np.repeat(np.arange(num_points), obs_per_point)

    with torch.no_grad():
        proj = residual(
            torch.from_numpy(np.ascontiguousarray(cameras_gt[cam_idx].T)),
            torch.from_numpy(np.ascontiguousarray(points_gt[pt_idx].T)),
            torch.zeros((1, cam_idx.shape[0]), dtype=torch.float64)
        ).numpy().T
    obs = proj + r.normal(scale=noise, size=proj.shape)

    order = np.argsort(cam_idx, kind="stable")
    cameras0 = cameras_gt + r.normal(
        scale=param_noise, size=cameras_gt.shape) * np.array(
            [1.0, 1.0, 1.0, 50.0])
    points0 = points_gt + r.normal(scale=param_noise, size=points_gt.shape)
    return SyntheticPlanar(
        cameras_gt=cameras_gt.astype(dtype),
        points_gt=points_gt.astype(dtype),
        cameras0=cameras0.astype(dtype),
        points0=points0.astype(dtype),
        obs=obs[order].astype(dtype),
        cam_idx=cam_idx[order].astype(np.int32),
        pt_idx=pt_idx[order].astype(np.int32),
    )

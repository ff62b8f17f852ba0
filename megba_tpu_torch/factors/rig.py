"""Multi-camera rig BA: N physical cameras sharing one body extrinsic.

Counterpart of `megba_tpu/factors/rig.py`.  Each capture has ONE
optimisable body pose, and every physical camera k on the rig is a FIXED
mount extrinsic composed on top of it; the mount rides the edge's
observation vector as a per-edge constant, so a rig problem has K edges
per (body, point) pair (`unique_edges=False`).

Block layout:
  camera (7) = [body angle-axis (3), body translation (3), focal f]
  point  (3)
  obs    (8) = [u, v, mount angle-axis (3), mount translation (3)]

Projection chain (BAL minus convention): X_body = R(w_b) X + t_b;
X_cam = R(w_m) X_body + t_m; p = -X_cam[:2] / X_cam[2]; r = f p - [u, v].
On the card its blocks run kernels 1-3 at (od, d) = (2, 7) and (2, 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from megba_tpu_torch.factors.registry import FactorSpec, FactorTriage
from megba_tpu_torch.ops import geo

CAMERA_DIM = 7
POINT_DIM = 3
OBS_DIM = 8


def rig_residual(camera: torch.Tensor, point: torch.Tensor,
                 obs: torch.Tensor) -> torch.Tensor:
    """2-row reprojection residual of rig edges, camera [7, ...],
    point [3, ...], obs [8, ...] -> [2, ...]."""
    w_b, t_b, f = camera[0:3], camera[3:6], camera[6]
    uv, w_m, t_m = obs[0:2], obs[2:5], obs[5:8]
    X_body = geo.angle_axis_rotate_point(w_b, point) + t_b
    X_cam = geo.angle_axis_rotate_point(w_m, X_body) + t_m
    p = -X_cam[0:2] / X_cam[2]
    return f * p - uv


def _rig_project_depth(cam_blocks: np.ndarray, pt_blocks: np.ndarray,
                       obs: np.ndarray):
    """Host twin of `rig_residual`'s projection, + the physical camera's
    depth (the mount in obs composes as on the device)."""
    from megba_tpu_torch.io.synthetic import rotate_batch

    X_body = rotate_batch(cam_blocks[:, 0:3], pt_blocks) + cam_blocks[:, 3:6]
    X_cam = rotate_batch(obs[:, 2:5], X_body) + obs[:, 5:8]
    with np.errstate(divide="ignore", invalid="ignore"):
        p = -X_cam[:, 0:2] / X_cam[:, 2:3]
        uv = cam_blocks[:, 6:7] * p
    return uv, X_cam[:, 2]


def _rig_centers(cameras: np.ndarray) -> np.ndarray:
    """Body-frame centers C = -R_b^T t_b, standing in for the physical
    cameras (within a mount baseline of it)."""
    from megba_tpu_torch.io.synthetic import camera_centers

    return camera_centers(cameras)


SPEC = FactorSpec(
    name="rig",
    cam_dim=CAMERA_DIM,
    pt_dim=POINT_DIM,
    obs_dim=OBS_DIM,
    residual_dim=2,
    residual_fn=rig_residual,
    unique_edges=False,  # K edges per (body, point): one per rig camera
    triage=FactorTriage(project_depth=_rig_project_depth, uv_cols=(0, 2),
                        camera_centers=_rig_centers),
    description="multi-camera rig BA: shared body pose [aa(3), t(3), f], "
                "per-edge mount extrinsic in obs[2:8]",
)


@dataclasses.dataclass
class SyntheticRig:
    """Ground truth + perturbed init for a synthetic rig scene."""

    cameras_gt: np.ndarray  # [Nb, 7] body blocks
    points_gt: np.ndarray  # [Np, 3]
    cameras0: np.ndarray
    points0: np.ndarray
    obs: np.ndarray  # [nE, 8]
    cam_idx: np.ndarray  # [nE] int32 (body index)
    pt_idx: np.ndarray  # [nE] int32
    mounts: np.ndarray  # [K, 6] the rig's mount extrinsics


def make_synthetic_rig(
    num_bodies: int = 4,
    num_points: int = 24,
    rig_cameras: int = 2,
    obs_per_point: int = 2,
    pixel_noise: float = 0.3,
    param_noise: float = 2e-2,
    seed: int = 0,
    dtype: np.dtype = np.float64,
) -> SyntheticRig:
    """A K-camera rig observing a point cloud from `num_bodies` poses
    (the JAX package's generator: the same draws from the same seed);
    each observed (body, point) pair is seen by all `rig_cameras`
    mounts, and the observations come from the model itself."""
    r = np.random.default_rng(seed)
    obs_per_point = min(obs_per_point, num_bodies)

    points_gt = r.uniform(-1.0, 1.0, size=(num_points, 3))
    bodies_gt = np.zeros((num_bodies, 7))
    bodies_gt[:, 0:3] = r.normal(scale=0.05, size=(num_bodies, 3))
    bodies_gt[:, 3:5] = r.normal(scale=0.2, size=(num_bodies, 2))
    bodies_gt[:, 5] = -5.0 + r.normal(scale=0.2, size=num_bodies)
    bodies_gt[:, 6] = 400.0 + r.normal(scale=4.0, size=num_bodies)

    # Mount extrinsics: small rotations, ~0.3-unit baselines.
    mounts = np.zeros((rig_cameras, 6))
    mounts[:, 0:3] = r.normal(scale=0.03, size=(rig_cameras, 3))
    mounts[:, 3:6] = r.normal(scale=0.15, size=(rig_cameras, 3))

    base = r.integers(0, num_bodies, size=(num_points, 1))
    stride = 1 + r.integers(0, max(num_bodies // max(obs_per_point, 1), 1),
                            size=(num_points, 1))
    pair_cam = ((base + np.arange(obs_per_point)[None, :] * stride)
                % num_bodies).reshape(-1)
    pair_pt = np.repeat(np.arange(num_points), obs_per_point)
    missing = np.setdiff1d(np.arange(num_bodies), pair_cam)
    if missing.size:
        pair_cam = np.concatenate([pair_cam, missing])
        pair_pt = np.concatenate(
            [pair_pt, r.integers(0, num_points, size=missing.size)])

    # Fan each (body, point) pair out over the K rig cameras.
    k_ax = np.arange(rig_cameras)
    cam_idx = np.repeat(pair_cam, rig_cameras)
    pt_idx = np.repeat(pair_pt, rig_cameras)
    mount_rows = mounts[np.tile(k_ax, pair_cam.shape[0])]

    uv, _ = _rig_project_depth(
        bodies_gt[cam_idx], points_gt[pt_idx],
        np.concatenate([np.zeros((cam_idx.shape[0], 2)), mount_rows],
                       axis=1))
    obs = np.concatenate(
        [uv + r.normal(scale=pixel_noise, size=uv.shape), mount_rows],
        axis=1)

    order = np.argsort(cam_idx, kind="stable")
    cameras0 = bodies_gt + r.normal(
        scale=param_noise, size=bodies_gt.shape) * np.array(
            [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 20.0])
    points0 = points_gt + r.normal(scale=param_noise, size=points_gt.shape)
    return SyntheticRig(
        cameras_gt=bodies_gt.astype(dtype),
        points_gt=points_gt.astype(dtype),
        cameras0=cameras0.astype(dtype),
        points0=points0.astype(dtype),
        obs=obs[order].astype(dtype),
        cam_idx=cam_idx[order].astype(np.int32),
        pt_idx=pt_idx[order].astype(np.int32),
        mounts=mounts.astype(dtype),
    )

"""GPS/IMU-style unary SE(3) pose priors as a camera/point factor.

Counterpart of `megba_tpu/factors/priors.py`.  Each edge anchors ONE
camera-side pose block to a measured pose carried in the observation
vector.  The residual ignores the point block (`point_coupled=False`):
its point-side Jacobian is zero, every point gets an identity Hessian
block, and all edges share one dummy point, so on the card the point
side is one segment of nE slots and its kernels take the
block-per-segment launch (`SegPlan.per_thread` is False).

Block layout:
  camera (6) = [angle-axis (3), translation (3)]  (the pose)
  point  (3) = dummy (shared; never moves)
  obs    (6) = the prior pose [angle-axis (3), translation (3)]
  residual (6) = [log_SO3(R_p^T R), R_p^T (t - t_p)]

`robust_ok=False`: a prior is trusted information, and a downweighted
marginalization prior is corrupt.  `unique_edges=False`: several priors
on one pose are legitimate.  On the card: kernels 1-3 at (od, d) =
(6, 6) and (6, 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from megba_tpu_torch.factors.registry import FactorSpec
from megba_tpu_torch.ops import geo

CAMERA_DIM = 6
POINT_DIM = 3
OBS_DIM = 6
RESIDUAL_DIM = 6


def pose_prior_residual(camera: torch.Tensor, point: torch.Tensor,
                        obs: torch.Tensor) -> torch.Tensor:
    """6-row unary prior residual, camera [6, ...], obs [6, ...] ->
    [6, ...] (the point block is unused)."""
    del point  # unary factor: the point side contributes nothing
    R_p = geo.angle_axis_to_rotation_matrix(obs[0:3])
    R_c = geo.angle_axis_to_rotation_matrix(camera[0:3])
    E_R = geo.mm(R_p.transpose(0, 1), R_c)
    E_t = geo.mm(R_p.transpose(0, 1), (camera[3:6] - obs[3:6])[:, None])[:, 0]
    return torch.cat([geo.rotation_matrix_to_angle_axis(E_R), E_t])


SPEC = FactorSpec(
    name="pose_prior",
    cam_dim=CAMERA_DIM,
    pt_dim=POINT_DIM,
    obs_dim=OBS_DIM,
    residual_dim=RESIDUAL_DIM,
    residual_fn=pose_prior_residual,
    robust_ok=False,  # a downweighted marginalization prior is corrupt
    unique_edges=False,  # multi-sensor: several priors per pose
    point_coupled=False,
    description="unary SE(3) pose prior (GPS/IMU/marginalization): "
                "camera [aa(3), t(3)] anchored to obs [aa(3), t(3)]",
)


@dataclasses.dataclass
class SyntheticPriors:
    """A pose-estimation problem made purely of unary priors."""

    poses_gt: np.ndarray  # [N, 6]
    cameras0: np.ndarray  # perturbed initial poses
    points0: np.ndarray  # [1, 3] shared dummy point
    obs: np.ndarray  # [nE, 6] prior poses
    cam_idx: np.ndarray
    pt_idx: np.ndarray


def make_synthetic_priors(
    num_poses: int = 8,
    priors_per_pose: int = 1,
    prior_noise: float = 0.0,
    param_noise: float = 5e-2,
    seed: int = 0,
    dtype: np.dtype = np.float64,
) -> SyntheticPriors:
    """Poses on a circle, each anchored by `priors_per_pose` unary priors
    at (optionally noisy) ground truth (the JAX package's generator).
    With exact priors the optimum is the ground truth, at cost ~0."""
    r = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(num_poses) / num_poses
    poses_gt = np.zeros((num_poses, 6))
    poses_gt[:, 2] = th
    poses_gt[:, 3] = np.cos(th)
    poses_gt[:, 4] = np.sin(th)

    cam_idx = np.tile(np.arange(num_poses), priors_per_pose)
    prior = (poses_gt[cam_idx]
             + prior_noise * r.standard_normal((cam_idx.shape[0], 6)))
    cameras0 = poses_gt + param_noise * r.standard_normal(poses_gt.shape)

    order = np.argsort(cam_idx, kind="stable")
    return SyntheticPriors(
        poses_gt=poses_gt.astype(dtype),
        cameras0=cameras0.astype(dtype),
        points0=np.zeros((1, 3), dtype),
        obs=prior[order].astype(dtype),
        cam_idx=cam_idx[order].astype(np.int32),
        pt_idx=np.zeros(cam_idx.shape[0], np.int32),
    )

"""Scale-aware sim(3) pose-graph residual.

Counterpart of the residual half of `megba_tpu/factors/sim3.py`: one
log-scale dof per pose,

  pose (7) = [angle-axis (3), translation (3), log-scale l]
  T x = e^l R x + t

and the between residual on edge (i, j) with measurement m = T_i^{-1} T_j:

  T_rel = (R_i^T R_j,  e^{-l_i} R_i^T (t_j - t_i),  l_j - l_i)
  E     = T_m^{-1} T_rel
  r     = [log_SO3(E_R); E_t; E_l]            (7 rows)

with the host chart maps `compose_sim3` / `relative_sim3` and the
synthetic graph generator `make_synthetic_sim3_graph`.  The pose-graph
driver `models/pgo.solve_pgo(factor="sim3_between")` solves it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from megba_tpu_torch.core.host_se3 import compose, relative
from megba_tpu_torch.factors.registry import PoseFactorSpec
from megba_tpu_torch.ops import geo

SIM3_DIM = 7


def sim3_between_residual(pose_i: torch.Tensor, pose_j: torch.Tensor,
                          meas: torch.Tensor) -> torch.Tensor:
    """7-row sim(3) between-factor residual, poses and meas [7, ...]."""
    Ri = geo.angle_axis_to_rotation_matrix(pose_i[0:3])
    Rj = geo.angle_axis_to_rotation_matrix(pose_j[0:3])
    Rm = geo.angle_axis_to_rotation_matrix(meas[0:3])
    Ri_t, Rm_t = Ri.transpose(0, 1), Rm.transpose(0, 1)
    li, lj, lm = pose_i[6], pose_j[6], meas[6]
    R_rel = geo.mm(Ri_t, Rj)
    t_rel = torch.exp(-li) * geo.mm(
        Ri_t, (pose_j[3:6] - pose_i[3:6])[:, None])[:, 0]
    E_R = geo.mm(Rm_t, R_rel)
    E_t = torch.exp(-lm) * geo.mm(Rm_t, (t_rel - meas[3:6])[:, None])[:, 0]
    E_l = (lj - li) - lm
    return torch.cat(
        [geo.rotation_matrix_to_angle_axis(E_R), E_t, E_l[None]])


SPEC = PoseFactorSpec(
    name="sim3_between",
    pose_dim=SIM3_DIM,
    meas_dim=SIM3_DIM,
    residual_dim=SIM3_DIM,
    residual_fn=sim3_between_residual,
    description="scale-aware sim(3) PGO: pose [aa(3), t(3), log-scale], "
                "error [log_SO3, t, dlog-scale]",
    # The reference's refuse_ratio 1.0 fires on sim(3)'s first inner
    # iteration (mixed rot/trans/log-scale blocks make the preconditioned
    # residual non-monotone); the JAX package measured 16 as the band
    # that solves.  resolve_refuse_ratio applies it; an explicit caller
    # setting still wins.
    refuse_ratio=16.0,
)


def compose_sim3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """T_a o T_b over [..., 7] sim(3) charts."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    b6 = np.concatenate(
        [b[..., 0:3], np.exp(a[..., 6:7]) * b[..., 3:6]], axis=-1)
    se3 = compose(a[..., 0:6], b6)
    return np.concatenate([se3, a[..., 6:7] + b[..., 6:7]], axis=-1)


def relative_sim3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """T_a^{-1} T_b over [..., 7] sim(3) charts: the measurement of an
    (a, b) edge, at which `sim3_between_residual` is zero."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    se3 = relative(a[..., 0:6], b[..., 0:6])
    return np.concatenate(
        [se3[..., 0:3], np.exp(-a[..., 6:7]) * se3[..., 3:6],
         b[..., 6:7] - a[..., 6:7]], axis=-1)


@dataclasses.dataclass
class SyntheticSim3Graph:
    """Ground truth + scale-drifted odometry init for a loop-closed
    sim(3) graph."""

    poses_gt: np.ndarray  # [N, 7]
    poses0: np.ndarray
    edge_i: np.ndarray
    edge_j: np.ndarray
    meas: np.ndarray  # [nE, 7]


def make_synthetic_sim3_graph(
    num_poses: int = 24,
    loop_closures: int = 5,
    meas_noise: float = 0.0,
    drift_noise: float = 0.04,
    scale_drift: float = 0.02,
    seed: int = 0,
) -> SyntheticSim3Graph:
    """Circle trajectory with odometry + loop closures, monocular-style:
    the init integrates noisy odometry whose LOG-SCALE also drifts, so
    loop closures must correct rotation, translation AND scale.  The JAX
    package's generator: the same seed gives equal arrays."""
    rng = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(num_poses) / num_poses
    poses_gt = np.zeros((num_poses, SIM3_DIM))
    poses_gt[:, 2] = th
    poses_gt[:, 3] = np.cos(th)
    poses_gt[:, 4] = np.sin(th)
    poses_gt[:, 5] = 0.05 * np.sin(2 * th)
    # A gentle scale wave keeps the scale dof live even in noise-free
    # measurements.
    poses_gt[:, 6] = 0.1 * np.sin(th)

    ei = list(range(num_poses - 1))
    ej = list(range(1, num_poses))
    for _ in range(loop_closures):
        a = int(rng.integers(0, num_poses - 4))
        b = int(rng.integers(a + 2, num_poses))
        ei.append(a)
        ej.append(b)
    ei, ej = np.asarray(ei, np.int32), np.asarray(ej, np.int32)

    meas = (relative_sim3(poses_gt[ei], poses_gt[ej])
            + meas_noise * rng.standard_normal((len(ei), SIM3_DIM)))

    poses0 = poses_gt.copy()
    cur = poses_gt[0].copy()
    noise = rng.standard_normal((num_poses - 1, SIM3_DIM))
    noise[:, 0:6] *= drift_noise
    noise[:, 6] *= scale_drift
    for k in range(1, num_poses):
        cur = compose_sim3(cur, meas[k - 1] + noise[k - 1])
        poses0[k] = cur
    return SyntheticSim3Graph(
        poses_gt=poses_gt, poses0=poses0, edge_i=ei, edge_j=ej, meas=meas)

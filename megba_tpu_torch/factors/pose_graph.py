"""SE(3) between-factor PGO as a registered pose-graph factor.

Counterpart of `megba_tpu/factors/pose_graph.py`, with the residual of
`megba_tpu/models/pgo.py` (`between_residual`).  Its driver is
`models/pgo.solve_pgo` (the default factor there); the Schur pipeline
refuses it (`registry.require_schur`).

Model: pose = [angle_axis (3), translation (3)], T maps body -> world; a
measurement m on edge (i, j) is the expected relative pose
T_i^{-1} T_j, and the residual is the right-invariant error
E = T_m^{-1} (T_i^{-1} T_j), r = [log_SO3(E_R); E_t] (6 rows).
"""

from __future__ import annotations

import torch

from megba_tpu_torch.factors.registry import PoseFactorSpec
from megba_tpu_torch.ops import geo

POSE_DIM = 6


def between_residual(pose_i: torch.Tensor, pose_j: torch.Tensor,
                     meas: torch.Tensor) -> torch.Tensor:
    """6-row between-factor residual, poses and meas [6, ...]."""
    Ri = geo.angle_axis_to_rotation_matrix(pose_i[:3])
    Rj = geo.angle_axis_to_rotation_matrix(pose_j[:3])
    Rm = geo.angle_axis_to_rotation_matrix(meas[:3])
    Ri_t, Rm_t = Ri.transpose(0, 1), Rm.transpose(0, 1)
    # T_i^{-1} T_j = (Ri^T Rj, Ri^T (t_j - t_i))
    R_rel = geo.mm(Ri_t, Rj)
    t_rel = geo.mm(Ri_t, (pose_j[3:] - pose_i[3:])[:, None])[:, 0]
    # E = T_m^{-1} (T_i^{-1} T_j)
    E_R = geo.mm(Rm_t, R_rel)
    E_t = geo.mm(Rm_t, (t_rel - meas[3:])[:, None])[:, 0]
    return torch.cat([geo.rotation_matrix_to_angle_axis(E_R), E_t])


SPEC = PoseFactorSpec(
    name="se3_between",
    pose_dim=POSE_DIM,
    meas_dim=POSE_DIM,
    residual_dim=POSE_DIM,
    residual_fn=between_residual,
    description="SE(3) between-factor PGO: pose [aa(3), t(3)], "
                "right-invariant error [log_SO3, t]",
)

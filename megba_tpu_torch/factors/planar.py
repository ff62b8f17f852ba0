"""The planar SE(2) family as a registered factor spec (counterpart of
`megba_tpu/factors/planar.py`).  No triage hooks: the 1-D image-line
projection has no cheirality half-space in the BAL sense."""

from __future__ import annotations

from megba_tpu_torch.factors.registry import FactorSpec
from megba_tpu_torch.models.planar import (CAMERA_DIM, OBS_DIM, POINT_DIM,
                                           residual)

SPEC = FactorSpec(
    name="planar",
    cam_dim=CAMERA_DIM,
    pt_dim=POINT_DIM,
    obs_dim=OBS_DIM,
    residual_dim=1,
    residual_fn=residual,
    description="planar (2D) BA: camera [theta, tx, ty, f], point (2,), "
                "obs = 1-D image coordinate",
)

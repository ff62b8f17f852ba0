"""The BAL pinhole family as a registered factor spec.

Counterpart of `megba_tpu/factors/bal.py`: the spec's `residual_fn` is
`ops.residuals.bal_residual`, so `engine_for("bal", mode)` is the engine
`make_residual_jacobian_fn(mode=mode)` returns for the autodiff modes;
its `analytical_fn` is the closed form with its value-only residual,
which the LM loop costs the trial points with.  The triage hooks wrap
the host projection of io/synthetic.py.
"""

from __future__ import annotations

import numpy as np

from megba_tpu_torch.factors.registry import FactorSpec, FactorTriage
from megba_tpu_torch.ops.residuals import (
    ResidualJacobianFn,
    bal_residual,
    bal_residual_analytical_fm,
    bal_residual_jacobian_analytical_fm,
)

CAMERA_DIM = 9
POINT_DIM = 3
OBS_DIM = 2


def _project_depth(cam_blocks: np.ndarray, pt_blocks: np.ndarray,
                   obs: np.ndarray):
    """Edge-gathered BAL projection + camera-frame depth (host NumPy)."""
    from megba_tpu_torch.io.synthetic import project_batch_depth

    del obs  # the BAL projection needs no per-edge constants
    return project_batch_depth(cam_blocks, pt_blocks)


def _camera_centers(cameras: np.ndarray) -> np.ndarray:
    """C = -R^T t (the parallax check's viewing-ray origin)."""
    from megba_tpu_torch.io.synthetic import camera_centers

    return camera_centers(cameras)


SPEC = FactorSpec(
    name="bal",
    cam_dim=CAMERA_DIM,
    pt_dim=POINT_DIM,
    obs_dim=OBS_DIM,
    residual_dim=2,
    residual_fn=bal_residual,
    analytical_fn=ResidualJacobianFn(bal_residual_jacobian_analytical_fm,
                                     bal_residual_analytical_fm),
    triage=FactorTriage(project_depth=_project_depth, uv_cols=(0, 2),
                        camera_centers=_camera_centers),
    description="BAL pinhole reprojection: camera [angle-axis(3), t(3), "
                "f, k1, k2], point (3,), obs = pixel (2,)",
)

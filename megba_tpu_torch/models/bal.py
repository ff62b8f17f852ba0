"""The BAL 3D bundle adjustment model family (flagship).

Camera block (9): angle-axis rotation (3), translation (3), focal, k1,
k2.  Point block (3).  Observation (2).  The names of
`megba_tpu/models/bal.py`; `residual_jacobian_analytical` is the
feature-major closed form of this package.
"""

from megba_tpu_torch.ops.residuals import (
    bal_residual as residual,
    bal_residual_jacobian_analytical_fm as residual_jacobian_analytical,
)

CAMERA_DIM = 9
POINT_DIM = 3
OBS_DIM = 2

__all__ = [
    "CAMERA_DIM",
    "OBS_DIM",
    "POINT_DIM",
    "residual",
    "residual_jacobian_analytical",
]

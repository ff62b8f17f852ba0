"""Model families.

`bal`: the flagship 3D Bundle-Adjustment-in-the-Large model (9-dof
cameras, 3D points, 2D reprojections).  `planar`: 2D bundle adjustment
(SE(2) pose + focal, 2D points, a 1D image line), the same solver at
other block widths.  Each is a residual function (+ optional closed-form
Jacobian).  The JAX package's third family, the pose-graph driver
`pgo`, is not ported yet (ROADMAP Queue 1.7); its residual families are
registered in `factors` (`se3_between`, `sim3_between`).
"""

from megba_tpu_torch.models import bal, planar

__all__ = ["bal", "planar"]

"""Model families.

`bal`: the flagship 3D Bundle-Adjustment-in-the-Large model (9-dof
cameras, 3D points, 2D reprojections).  `planar`: 2D bundle adjustment
(SE(2) pose + focal, 2D points, a 1D image line), the same solver at
other block widths.  Each is a residual function (+ optional closed-form
Jacobian).  `pgo`: the pose-graph driver (`solve_pgo`) over the
registered pose-graph families (`se3_between`, `sim3_between`), with
unary priors (`with_priors`), the spanning-tree bootstrap and the
synthetic loop-closure graph.
"""

from megba_tpu_torch.models import bal, pgo, planar

__all__ = ["bal", "pgo", "planar"]

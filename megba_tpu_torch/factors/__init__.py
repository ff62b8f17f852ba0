"""Pluggable factor registry: the residual families of the solver.

Counterpart of `megba_tpu/factors/__init__.py`.  Importing this package
registers the built-in families, in the JAX package's order:

Schur (camera/point) families, solved by `solve.flat_solve(factor=)`
and `problem.BaseProblem`:

  - ``bal``            BAL pinhole (9/3/2): the flagship
  - ``planar``         SE(2) planar BA (4/2/1)
  - ``rig``            multi-camera rig, shared body extrinsic (7/3/8)
  - ``pinhole_radial`` full-intrinsics radial pinhole (12/3/2)
  - ``pose_prior``     GPS/IMU/marginalization unary SE(3) prior (6/3/6)

Pose-graph families, solved by `models.pgo.solve_pgo(factor=)` (the
Schur pipeline refuses them):

  - ``se3_between``    SE(3) between-factor PGO (6-dof)
  - ``sim3_between``   scale-aware sim(3) PGO (7-dof)

A custom family: write a feature-major residual function, wrap it in a
`FactorSpec`, call `register_factor`.
"""

from megba_tpu_torch.factors.engine import engine_for
from megba_tpu_torch.factors.registry import (
    DuplicateFactorError,
    FactorError,
    FactorSpec,
    FactorTriage,
    PoseFactorSpec,
    UnknownFactorError,
    get_factor,
    list_factors,
    register_factor,
    unregister_factor,
    validate_factor_arrays,
)

# Built-in registrations (import order = the table above).
from megba_tpu_torch.factors import bal as _bal
from megba_tpu_torch.factors import planar as _planar
from megba_tpu_torch.factors import rig as _rig
from megba_tpu_torch.factors import radial as _radial
from megba_tpu_torch.factors import priors as _priors
from megba_tpu_torch.factors import pose_graph as _pose_graph
from megba_tpu_torch.factors import sim3 as _sim3

for _spec in (_bal.SPEC, _planar.SPEC, _rig.SPEC, _radial.SPEC,
              _priors.SPEC, _pose_graph.SPEC, _sim3.SPEC):
    # Idempotent: a reloaded package must not trip its own refusal.
    register_factor(_spec, allow_override=True)

__all__ = [
    "DuplicateFactorError",
    "FactorError",
    "FactorSpec",
    "FactorTriage",
    "PoseFactorSpec",
    "UnknownFactorError",
    "engine_for",
    "get_factor",
    "list_factors",
    "register_factor",
    "unregister_factor",
    "validate_factor_arrays",
]

"""Registry-keyed engine resolution.

Counterpart of `megba_tpu/factors/engine.py`.  One factor configuration
maps to one engine object: `engine_for` goes through the memoised
`ops.residuals.make_residual_jacobian_fn`, and drops `analytical_fn`
from the engine key unless the mode is ANALYTICAL, so that
`engine_for("bal", AUTODIFF)` is the very object
`make_residual_jacobian_fn()` returns.
"""

from __future__ import annotations

from typing import Union

from megba_tpu_torch.common import JacobianMode
from megba_tpu_torch.factors.registry import (
    FactorError,
    FactorSpec,
    get_factor,
    require_schur,
)
from megba_tpu_torch.ops.residuals import make_residual_jacobian_fn


def engine_for(factor: Union[str, FactorSpec],
               mode: JacobianMode = JacobianMode.AUTODIFF):
    """The residual + Jacobian engine of a registered factor (a name or a
    spec).  Raises `UnknownFactorError` / `FactorError` for unknown
    names, pose-graph factors (they have no camera/point engine) and
    ANALYTICAL on a factor without a closed form.  Memoised: one
    (spec, mode), one engine object."""
    spec = require_schur(get_factor(factor), "engine_for")
    if mode != JacobianMode.ANALYTICAL:
        return make_residual_jacobian_fn(spec.residual_fn, mode, None)
    if spec.analytical_fn is None:
        raise FactorError(
            f"factor {spec.name!r} has no analytical Jacobian; use "
            "JacobianMode.AUTODIFF / AUTODIFF_FORWARD, or register "
            "the spec with analytical_fn")
    return make_residual_jacobian_fn(spec.residual_fn, mode,
                                     spec.analytical_fn)

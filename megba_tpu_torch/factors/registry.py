"""Factor registry: declarative specs for every residual family.

Counterpart of `megba_tpu/factors/registry.py`.  A residual family is
data: a frozen spec naming the parameter-block widths, the residual
dimension, the per-edge residual function, the optional closed-form
Jacobian and the host-side triage hooks.  `solve.flat_solve(...,
factor=)` resolves the engine through it (`factors.engine.engine_for`)
and validates the arrays against it.

Two spec kinds cover the solver's two drivers: `FactorSpec` for the
camera/point (Schur) pipeline and `PoseFactorSpec` for the pose-graph
driver (two same-kind blocks, `models/pgo.solve_pgo`), whose specs
`require_schur` refuses at the Schur pipeline's door.  Both kinds are frozen and hashable: a spec is a cache
key.

The residual functions of this package act on the leading (feature) axis
of their arguments (ops/residuals.py): camera [cam_dim, ...], point
[pt_dim, ...], obs [obs_dim, ...] -> r [residual_dim, ...].
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union


class FactorError(ValueError):
    """Base class for registry errors (typed, caller-matchable)."""


class UnknownFactorError(FactorError):
    """A factor name no registered spec answers to."""

    def __init__(self, name: str, known: List[str]):
        self.name = name
        self.known = list(known)
        super().__init__(
            f"unknown factor {name!r}; registered factors: "
            f"{', '.join(known) if known else '(none)'}")


class DuplicateFactorError(FactorError):
    """`register_factor` refused to overwrite an existing name: silent
    re-registration would swap the engine behind every cache keyed on the
    old spec; pass `allow_override=True` only in tests."""

    def __init__(self, name: str):
        self.name = name
        super().__init__(
            f"factor {name!r} is already registered; re-registering "
            "would orphan every engine/program cached under the old "
            "spec (pass allow_override=True only if you mean it)")


@dataclasses.dataclass(frozen=True)
class FactorTriage:
    """Host-side geometric hooks (pure NumPy) of a projective factor.

    `project_depth(cam_blocks [nE, cd], pt_blocks [nE, pd], obs [nE, od])
    -> (uv [nE, 2], depth [nE])` projects each edge's point through its
    camera (obs rides along: the rig's mount extrinsic lives there);
    `uv_cols` names the obs columns of the measured pixel;
    `camera_centers(cameras [Nc, cd]) -> [Nc, 3]` is optional.
    """

    project_depth: Callable  # (cams, pts, obs) -> (uv, depth)
    uv_cols: Tuple[int, int] = (0, 2)  # obs[:, lo:hi] = measured pixel
    camera_centers: Optional[Callable] = None  # (cameras) -> [Nc, 3]


@dataclasses.dataclass(frozen=True)
class FactorSpec:
    """One camera/point (Schur-pipeline) residual family.

    `residual_fn(camera [cam_dim, ...], point [pt_dim, ...], obs
    [obs_dim, ...]) -> r [residual_dim, ...]`; `analytical_fn`, when
    present, is the feature-major closed form ((cam, pt, obs) -> (r, Jc,
    Jp) in row layout) that `JacobianMode.ANALYTICAL` selects.  obs is
    the per-edge constant vector, independent of residual_dim, the row
    count of r (`sqrt_info` is [residual_dim, residual_dim] per edge).

    `robust_ok=False` refuses robust losses at solve time;
    `unique_edges=False` marks repeated (cam_idx, pt_idx) pairs as
    legitimate (rig mounts, repeated priors); `point_coupled=False`
    declares that the residual ignores the point block (a unary camera
    factor: the point side assembles to identity Hessian blocks).
    `refuse_ratio` is the family's PCG refuse_ratio default (None: the
    SolverOption class default).
    """

    name: str
    cam_dim: int
    pt_dim: int
    obs_dim: int
    residual_dim: int
    residual_fn: Callable
    analytical_fn: Optional[Callable] = None
    robust_ok: bool = True
    unique_edges: bool = True
    point_coupled: bool = True
    triage: Optional[FactorTriage] = None
    description: str = ""
    refuse_ratio: Optional[float] = None

    kind = "schur"

    def __post_init__(self) -> None:
        for f in ("cam_dim", "pt_dim", "obs_dim", "residual_dim"):
            if getattr(self, f) < 1:
                raise FactorError(
                    f"factor {self.name!r}: {f} must be >= 1, "
                    f"got {getattr(self, f)}")


@dataclasses.dataclass(frozen=True)
class PoseFactorSpec:
    """One pose-graph (two same-kind blocks) residual family:
    `residual_fn(pose_i [pose_dim, ...], pose_j [pose_dim, ...], meas
    [meas_dim, ...]) -> r [residual_dim, ...]`."""

    name: str
    pose_dim: int
    meas_dim: int
    residual_dim: int
    residual_fn: Callable
    description: str = ""
    # The family's PCG refuse_ratio default (the sim(3) family declares
    # 16: the reference's 1.0 stalls its first inner iteration).
    refuse_ratio: Optional[float] = None

    kind = "pose_graph"

    def __post_init__(self) -> None:
        for f in ("pose_dim", "meas_dim", "residual_dim"):
            if getattr(self, f) < 1:
                raise FactorError(
                    f"factor {self.name!r}: {f} must be >= 1, "
                    f"got {getattr(self, f)}")


AnySpec = Union[FactorSpec, PoseFactorSpec]

_REGISTRY: Dict[str, AnySpec] = {}


def register_factor(spec: AnySpec, allow_override: bool = False) -> AnySpec:
    """Register a factor spec under its name; returns the spec.  Refuses
    duplicates (`DuplicateFactorError`) unless `allow_override=True`."""
    if not isinstance(spec, (FactorSpec, PoseFactorSpec)):
        raise FactorError(
            f"register_factor wants a FactorSpec or PoseFactorSpec, "
            f"got {type(spec).__name__}")
    if spec.name in _REGISTRY and not allow_override:
        raise DuplicateFactorError(spec.name)
    _REGISTRY[spec.name] = spec
    return spec


def unregister_factor(name: str) -> None:
    """Remove a registration (test helper; pairs with allow_override)."""
    _REGISTRY.pop(name, None)


def get_factor(name_or_spec: Union[str, AnySpec]) -> AnySpec:
    """Resolve a factor by name (`UnknownFactorError` on a miss); specs
    pass through unchanged, so call sites accept either."""
    if isinstance(name_or_spec, (FactorSpec, PoseFactorSpec)):
        return name_or_spec
    spec = _REGISTRY.get(name_or_spec)
    if spec is None:
        raise UnknownFactorError(str(name_or_spec), sorted(_REGISTRY))
    return spec


def list_factors() -> Dict[str, AnySpec]:
    """Snapshot of the registry (name -> spec), in registration order."""
    return dict(_REGISTRY)


def require_schur(spec: AnySpec, where: str) -> FactorSpec:
    """Typed refusal when a pose-graph factor reaches the Schur pipeline
    (its blocks are of one kind): point the caller at `solve_pgo`."""
    if spec.kind != "schur":
        raise FactorError(
            f"{where}: factor {spec.name!r} is a pose-graph family "
            "(two same-kind blocks); solve it with "
            "megba_tpu_torch.models.pgo.solve_pgo(factor=...), not the "
            "camera/point Schur pipeline")
    return spec  # type: ignore[return-value]


def require_pose_graph(spec: AnySpec, where: str) -> PoseFactorSpec:
    """Typed refusal when a Schur factor reaches the pose-graph driver."""
    if spec.kind != "pose_graph":
        raise FactorError(
            f"{where}: factor {spec.name!r} is a camera/point (Schur) "
            "family; solve it with megba_tpu_torch.solve.flat_solve("
            "factor=...), not the pose-graph driver")
    return spec  # type: ignore[return-value]


def resolve_refuse_ratio(spec: AnySpec, solver_option) -> float:
    """The effective PCG refuse_ratio of a solve of `spec`: the factor's
    declared default applies exactly when the caller left
    `SolverOption.refuse_ratio` at its class default (the reference's
    1.0); an explicit value always wins.  A factor with no declared
    default changes nothing."""
    declared = getattr(spec, "refuse_ratio", None)
    if declared is None:
        return solver_option.refuse_ratio
    from megba_tpu_torch.common import SolverOption

    default_value = next(f.default for f in dataclasses.fields(SolverOption)
                         if f.name == "refuse_ratio")
    if solver_option.refuse_ratio == default_value:
        return float(declared)
    return solver_option.refuse_ratio


def apply_factor_solver_defaults(spec: AnySpec, option):
    """Fold a factor's solver defaults into a ProblemOption: the same
    object when nothing resolves differently, else a replaced copy."""
    rr = resolve_refuse_ratio(spec, option.solver_option)
    if rr == option.solver_option.refuse_ratio:
        return option
    return dataclasses.replace(
        option, solver_option=dataclasses.replace(
            option.solver_option, refuse_ratio=rr))


def validate_factor_arrays(spec: FactorSpec, cameras, points, obs,
                           where: str = "flat_solve") -> None:
    """Typed width check: the arrays' feature widths (edge-major, [N, w])
    must match the spec; the error names the factor and the axis."""
    got = (int(cameras.shape[1]), int(points.shape[1]), int(obs.shape[1]))
    want = (spec.cam_dim, spec.pt_dim, spec.obs_dim)
    if got != want:
        axes = ("cameras", "points", "obs")
        bad = ", ".join(
            f"{axes[k]} width {got[k]} (factor wants {want[k]})"
            for k in range(3) if got[k] != want[k])
        raise FactorError(
            f"{where}: arrays do not match factor {spec.name!r}: {bad}")

"""Common enums, option structs and device resolution.

The PyTorch counterpart of `megba_tpu/common.py`: the same enums with the
same member values, `SolveStatus` with the same integer codes, and the
option dataclasses with the same field names and defaults, so a
configuration written for one package reads the same in the other.

One thing differs on purpose: `Device` names the torch backends this
package runs on (CUDA, CPU), and `ProblemOption.device` defaults to
`Device.CUDA`.  An entry point's own `device=` argument, when given,
wins over it.

`validate_options` raises the JAX package's `ValueError`s for the
option combinations it refuses; every option value the JAX package
accepts is implemented here (the last, `metrics`, arms the metrics plane
of observability/).  The lane-batched fleet solve runs them all too, and
raises for TWO_LEVEL / MULTILEVEL the `ValueError` the JAX package's
vmapped bucket program raises (`algo/lanes.check_lane_option`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union

import numpy as np
import torch


class Device(enum.Enum):
    """Execution backend: the torch device type a solve runs on."""

    CPU = "cpu"
    CUDA = "cuda"


class AlgoKind(enum.Enum):
    BASE_ALGO = 0
    LM = 1


class LinearSystemKind(enum.Enum):
    BASE_LINEAR_SYSTEM = 0
    SCHUR = 1


class ComputeKind(enum.Enum):
    """EXPLICIT stores W_e = Jc_e^T Jp_e per edge; IMPLICIT recomputes the
    Schur matvec from the stored Jacobians every PCG iteration."""

    EXPLICIT = 0
    IMPLICIT = 1


class SolverKind(enum.Enum):
    BASE_SOLVER = 0
    PCG = 1


class JacobianMode(enum.Enum):
    """How per-edge Jacobians are produced (ops/residuals.py): reverse-mode
    autodiff, the closed form, or forward-mode autodiff."""

    AUTODIFF = 0
    ANALYTICAL = 1
    AUTODIFF_FORWARD = 2


class PrecondKind(enum.Enum):
    """Preconditioner operator family for the Schur PCG (JACOBI and
    NEUMANN are ported)."""

    JACOBI = 0
    NEUMANN = 1
    TWO_LEVEL = 2
    MULTILEVEL = 3


class EdgeOrder(enum.Enum):
    NATURAL = 0
    COOBS = 1


class PreconditionerKind(enum.Enum):
    """Block diagonal the preconditioner inverts: the damped camera
    blocks (HPP) or the true Schur block diagonal (SCHUR_DIAG)."""

    HPP = 0
    SCHUR_DIAG = 1


class RobustKind(enum.Enum):
    """Robust loss kind (ops/robust.py)."""

    NONE = 0
    HUBER = 1
    CAUCHY = 2


class SolveStatus(enum.IntEnum):
    """Termination status of one LM solve (codes equal the JAX package's)."""

    MAX_ITER = 0  # iteration budget exhausted with progress made
    CONVERGED = 1  # a convergence criterion fired (step size / gradient)
    STALLED = 2  # budget exhausted with ZERO accepted steps
    RECOVERED = 3  # finished after >= 1 contained fault recovery
    FATAL_NONFINITE = 4  # bailed out: max_recoveries consecutive failures


def status_name(code) -> str:
    """Human-readable name of a SolveStatus code (tolerates raw ints)."""
    try:
        return SolveStatus(int(code)).name.lower()
    except ValueError:
        return f"unknown({int(code)})"


# The statuses a fleet service should not hand back as they are: STALLED
# (no accepted step) and FATAL_NONFINITE (the guards gave up).  The
# escalation ladder (serving/resilience.py) re-solves them.
RETRYABLE_STATUSES = frozenset(
    {SolveStatus.STALLED, SolveStatus.FATAL_NONFINITE})


def status_retryable(code, final_cost=None,
                     statuses=RETRYABLE_STATUSES) -> bool:
    """Should a fleet-level retry ladder re-solve this outcome?  True for
    a status in `statuses`, for an unknown code, and for any solve whose
    final cost is not finite whatever its code (with guards off a
    poisoned carry can end MAX_ITER or CONVERGED around a NaN cost)."""
    try:
        retry = SolveStatus(int(code)) in statuses
    except ValueError:
        retry = True
    if final_cost is not None and not np.isfinite(float(final_cost)):
        return True
    return retry


@dataclasses.dataclass(frozen=True)
class RobustOption:
    guards: bool = False
    max_recoveries: int = 3
    damping_inflation: float = 4.0
    pcg_max_restarts: int = 2


@dataclasses.dataclass(frozen=True)
class SolverOption:
    """Inner (PCG) solver options.  `tol` is an absolute threshold on the
    preconditioned residual energy <r, M^-1 r>; `tol_relative=True` makes
    it a fraction of the right-hand side's energy."""

    solver_kind: SolverKind = SolverKind.PCG
    max_iter: int = 100
    tol: float = 1e-1
    refuse_ratio: float = 1.0
    tol_relative: bool = False
    preconditioner: PreconditionerKind = PreconditionerKind.HPP
    forcing: bool = False
    eta_min: float = 1e-6
    warm_start: bool = False
    precond: PrecondKind = PrecondKind.JACOBI
    neumann_order: int = 2
    coarse_clusters: int = 0
    coarsen_factor: float = 4.0
    max_levels: int = 3
    smooth_omega: float = 0.0
    mesh_2d: bool = False
    cam_blocks: int = 0
    edge_order: EdgeOrder = EdgeOrder.NATURAL
    bf16: bool = False
    bf16_collectives: bool = False
    fused_kernels: bool = False


@dataclasses.dataclass(frozen=True)
class AlgoOption:
    """Outer (LM) loop options."""

    algo_kind: AlgoKind = AlgoKind.LM
    max_iter: int = 20
    initial_region: float = 1e3
    epsilon1: float = 1.0
    epsilon2: float = 1e-10


@dataclasses.dataclass(frozen=True)
class ProblemOption:
    """Problem-level options.  `dtype` is a numpy float dtype (float32 or
    float64); `device` is the default device of the entry points (with
    `world_size` N > 1, CUDA takes the first N visible cards and CPU
    puts N shards on the CPU)."""

    use_schur: bool = True
    device: Device = Device.CUDA
    world_size: int = 1
    # Shapes key every plan cache independently, so keying these would
    # only fragment the caches — key-exempt (analysis/identity.py).
    N: int = -1  # megba: key-exempt(N)
    n_item: int = -1  # megba: key-exempt(n_item)
    dtype: np.dtype = np.float64
    algo_kind: AlgoKind = AlgoKind.LM
    linear_system_kind: LinearSystemKind = LinearSystemKind.SCHUR
    compute_kind: ComputeKind = ComputeKind.IMPLICIT
    jacobian_mode: JacobianMode = JacobianMode.AUTODIFF
    solver_option: SolverOption = dataclasses.field(default_factory=SolverOption)
    algo_option: AlgoOption = dataclasses.field(default_factory=AlgoOption)
    robust_option: RobustOption = dataclasses.field(default_factory=RobustOption)
    mixed_precision_pcg: bool = False
    robust_kind: RobustKind = RobustKind.NONE
    robust_delta: float = 1.0
    telemetry: Optional[str] = None
    metrics: bool = False

    def __post_init__(self) -> None:
        if self.world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {self.world_size}")
        if self.robust_kind != RobustKind.NONE and not self.robust_delta > 0:
            raise ValueError(
                f"robust_delta must be > 0, got {self.robust_delta}")


@dataclasses.dataclass
class AlgoStatus:
    """Mutable LM status (the reference's common.h:55-60)."""

    region: float = 1e3
    recover_diag: bool = False


# The ProblemOption fields that are host-side sinks, cleared off an option
# before it reaches a cache key, a program key or a warm-up manifest.
OBSERVABILITY_FIELDS = ("telemetry", "metrics")


def strip_observability(option: ProblemOption) -> ProblemOption:
    """The option with its observability sinks (`OBSERVABILITY_FIELDS`)
    cleared; `option` itself when none is set."""
    if option.telemetry is not None or option.metrics:
        return dataclasses.replace(option, telemetry=None, metrics=False)
    return option


DTYPE_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def validate_options(option: ProblemOption) -> None:
    """Check the option kinds and combinations with the JAX package's
    ValueErrors.  The port implements every option value the JAX package
    accepts, so nothing else is refused."""
    so = option.solver_option
    ro = option.robust_option
    if option.algo_kind != AlgoKind.LM or option.algo_option.algo_kind != AlgoKind.LM:
        raise ValueError("only AlgoKind.LM is supported")
    if option.use_schur and option.linear_system_kind != LinearSystemKind.SCHUR:
        raise ValueError("use_schur=True requires LinearSystemKind.SCHUR")
    if so.solver_kind != SolverKind.PCG:
        raise ValueError("only SolverKind.PCG is supported")
    if not so.eta_min > 0:
        raise ValueError(f"eta_min must be > 0, got {so.eta_min}")
    if so.forcing and so.eta_min > so.tol:
        raise ValueError(
            "forcing=True clamps eta_k to [eta_min, tol]; need "
            f"eta_min <= tol, got eta_min={so.eta_min} > tol={so.tol}")
    if so.precond == PrecondKind.NEUMANN and so.neumann_order < 1:
        raise ValueError(
            f"neumann_order must be >= 1, got {so.neumann_order}")
    if so.coarse_clusters < 0:
        raise ValueError(
            f"coarse_clusters must be >= 0 (0 = auto sqrt(Nc)), got "
            f"{so.coarse_clusters}")
    if not so.coarsen_factor > 1.0:
        raise ValueError(
            f"coarsen_factor must be > 1 (each level must shrink), got "
            f"{so.coarsen_factor}")
    # The per-level fallback bit-field shares one int32 with the 16-bit
    # block count (solver/precond.py): coarse levels ride bits 16..30.
    if not 2 <= so.max_levels <= 15:
        raise ValueError(
            f"max_levels must be in [2, 15] (fine level included; the "
            f"per-level fallback bit-field carries at most 15 coarse "
            f"levels), got {so.max_levels}")
    if not 0.0 <= so.smooth_omega < 2.0:
        raise ValueError(
            f"smooth_omega must be in [0, 2) (0 = plain aggregation), "
            f"got {so.smooth_omega}")
    if so.smooth_omega and so.precond not in (PrecondKind.TWO_LEVEL,
                                              PrecondKind.MULTILEVEL):
        raise ValueError(
            "smooth_omega smooths the camera-graph coarse space; it "
            "requires precond=TWO_LEVEL or MULTILEVEL, got "
            f"{so.precond.name}")
    if so.cam_blocks < 0:
        raise ValueError(
            f"cam_blocks must be >= 0 (0 = auto factorisation), got "
            f"{so.cam_blocks}")
    if so.mesh_2d:
        if not option.use_schur:
            raise ValueError(
                "mesh_2d is only implemented for the Schur solver "
                "(use_schur=True); the plain full-system path has no "
                "camera-tiled matvec")
        cb = so.cam_blocks
        if cb > 0 and (cb > option.world_size
                       or option.world_size % cb != 0):
            raise ValueError(
                f"mesh_2d needs world_size = edge_shards x cam_blocks: "
                f"cam_blocks={cb} does not divide "
                f"world_size={option.world_size} (pick a divisor, or 0 "
                "for the automatic square-ish factorisation)")
    if np.dtype(option.dtype) not in DTYPE_TO_TORCH:
        raise ValueError(f"unsupported dtype {option.dtype}")
    if not isinstance(option.device, Device):
        raise ValueError(f"device must be a Device, got {option.device!r}")
    for name, kind in (("compute_kind", ComputeKind),
                       ("jacobian_mode", JacobianMode),
                       ("robust_kind", RobustKind)):
        if not isinstance(getattr(option, name), kind):
            raise ValueError(f"{name} must be a {kind.__name__}, got "
                             f"{getattr(option, name)!r}")
    if not option.use_schur and so.precond != PrecondKind.JACOBI:
        raise ValueError(
            "precond=NEUMANN/TWO_LEVEL/MULTILEVEL is only implemented for "
            "the Schur solver (use_schur=True); the plain full-system "
            "solver's exact block diagonal IS its preconditioner")
    if ro.max_recoveries < 1:
        raise ValueError(
            f"max_recoveries must be >= 1, got {ro.max_recoveries}")
    if not ro.damping_inflation > 1.0:
        raise ValueError(
            f"damping_inflation must be > 1, got {ro.damping_inflation}")
    if ro.pcg_max_restarts < 0:
        raise ValueError(
            f"pcg_max_restarts must be >= 0, got {ro.pcg_max_restarts}")
    if so.fused_kernels and not option.use_schur:
        raise ValueError(
            "SolverOption.fused_kernels fuses the Schur coupling matvec and "
            "M^-1 apply (use_schur=True); the plain full-system path has no "
            "edge pipeline to fuse")
    _validate_precision(option)


def _validate_precision(option: ProblemOption) -> None:
    """The precision-ladder ValueErrors of the JAX package's
    validate_options, in its order."""
    so = option.solver_option
    if not option.use_schur and option.mixed_precision_pcg:
        raise ValueError(
            "mixed_precision_pcg is only implemented for the Schur solver "
            "(use_schur=True)")
    if so.bf16:
        if not option.use_schur:
            raise ValueError(
                "SolverOption.bf16 is only implemented for the Schur solver "
                "(use_schur=True); the plain full-system path has no "
                "equilibrated coupling operands to halve")
        if np.dtype(option.dtype) != np.float32:
            raise ValueError(
                "SolverOption.bf16 runs the float32 pipeline with bf16 "
                "coupling storage; a float64 problem asking for bf16 "
                "operands would discard the precision it asked for — got "
                f"dtype={np.dtype(option.dtype).name} (solve f64 without "
                "bf16, or cast the problem to f32)")
        if option.mixed_precision_pcg:
            raise ValueError(
                "SolverOption.bf16 and ProblemOption.mixed_precision_pcg are "
                "different rungs of the same precision ladder (bf16 "
                "multiplies in bf16 with f32 accumulation; mixed upcasts the "
                "stored rows before multiplying) — pick one")
    if so.bf16_collectives and not so.bf16:
        raise ValueError(
            "bf16_collectives compresses the in-body collective payloads "
            "of the bf16 matvec pipeline; it requires SolverOption."
            "bf16=True (the storage rung) — enabling it alone would halve "
            "wire traffic of products that never went bf16")


def resolve_device(device: Union[None, str, torch.device],
                   option: Optional[ProblemOption] = None) -> torch.device:
    """The torch device an entry point runs on.

    `device` wins when given; otherwise `option.device` (default CUDA).
    A CUDA device with no card present raises: the port never quietly
    carries on on the CPU.
    """
    if device is None:
        device = (option.device if option is not None else Device.CUDA).value
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "megba_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

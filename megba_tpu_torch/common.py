"""Common enums, option structs and device resolution.

The PyTorch counterpart of `megba_tpu/common.py`: the same enums with the
same member values, `SolveStatus` with the same integer codes, and the
option dataclasses with the same field names and defaults, so a
configuration written for one package reads the same in the other.

Two things differ on purpose:

- `Device` names the torch backends this package runs on (CUDA, CPU);
  `ProblemOption.device` defaults to `Device.CUDA`.  An entry point's own
  `device=` argument, when given, wins over it.
- `validate_options` refuses every option value the port does not
  implement yet with a `NotImplementedError` that names the option, so a
  configuration is never silently run as something else.
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
    """How per-edge Jacobians are produced (only ANALYTICAL is ported)."""

    AUTODIFF = 0
    ANALYTICAL = 1
    AUTODIFF_FORWARD = 2


class PrecondKind(enum.Enum):
    """Preconditioner operator family for the Schur PCG (only JACOBI is
    ported)."""

    JACOBI = 0
    NEUMANN = 1
    TWO_LEVEL = 2
    MULTILEVEL = 3


class EdgeOrder(enum.Enum):
    NATURAL = 0
    COOBS = 1


class PreconditionerKind(enum.Enum):
    """Block diagonal the preconditioner inverts (only HPP is ported)."""

    HPP = 0
    SCHUR_DIAG = 1


class RobustKind(enum.Enum):
    """Robust loss kind (only NONE is ported)."""

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
    float64); `device` is the default device of the entry points."""

    use_schur: bool = True
    device: Device = Device.CUDA
    world_size: int = 1
    N: int = -1
    n_item: int = -1
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


DTYPE_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def _unported(name: str, value) -> NotImplementedError:
    return NotImplementedError(
        f"{name}={value!r} is not ported to megba_tpu_torch yet; the port "
        "runs the LM + Schur PCG path (IMPLICIT, or EXPLICIT with or "
        "without fused kernels) with ANALYTICAL Jacobians, block-Jacobi "
        "(HPP) preconditioning and no guards")


def validate_options(option: ProblemOption) -> None:
    """Check the option kinds, then refuse every value this port does
    not implement (typed NotImplementedError naming the option)."""
    so = option.solver_option
    if option.algo_kind != AlgoKind.LM or option.algo_option.algo_kind != AlgoKind.LM:
        raise ValueError("only AlgoKind.LM is supported")
    if option.use_schur and option.linear_system_kind != LinearSystemKind.SCHUR:
        raise ValueError("use_schur=True requires LinearSystemKind.SCHUR")
    if so.solver_kind != SolverKind.PCG:
        raise ValueError("only SolverKind.PCG is supported")
    if np.dtype(option.dtype) not in DTYPE_TO_TORCH:
        raise ValueError(f"unsupported dtype {option.dtype}")
    if not isinstance(option.device, Device):
        raise ValueError(f"device must be a Device, got {option.device!r}")
    if not isinstance(option.compute_kind, ComputeKind):
        raise ValueError(
            f"compute_kind must be a ComputeKind, got {option.compute_kind!r}")
    if so.fused_kernels and not option.use_schur:
        raise ValueError(
            "SolverOption.fused_kernels fuses the Schur coupling matvec and "
            "M^-1 apply (use_schur=True); the plain full-system path has no "
            "edge pipeline to fuse")
    unported = [
        ("use_schur", option.use_schur, True),
        ("world_size", option.world_size, 1),
        ("jacobian_mode", option.jacobian_mode, JacobianMode.ANALYTICAL),
        ("mixed_precision_pcg", option.mixed_precision_pcg, False),
        ("robust_kind", option.robust_kind, RobustKind.NONE),
        ("robust_option.guards", option.robust_option.guards, False),
        ("solver_option.precond", so.precond, PrecondKind.JACOBI),
        ("solver_option.preconditioner", so.preconditioner,
         PreconditionerKind.HPP),
        ("solver_option.forcing", so.forcing, False),
        ("solver_option.warm_start", so.warm_start, False),
        ("solver_option.mesh_2d", so.mesh_2d, False),
        ("solver_option.edge_order", so.edge_order, EdgeOrder.NATURAL),
        ("solver_option.bf16", so.bf16, False),
        ("solver_option.bf16_collectives", so.bf16_collectives, False),
        ("telemetry", option.telemetry, None),
        ("metrics", option.metrics, False),
    ]
    for name, value, supported in unported:
        if value != supported:
            raise _unported(name, value)
    if so.fused_kernels and option.compute_kind == ComputeKind.IMPLICIT:
        raise NotImplementedError(
            "solver_option.fused_kernels=True with compute_kind=IMPLICIT is "
            "not ported to megba_tpu_torch yet: it needs the fused implicit "
            "coupling kernel (_fused_j_kernel of megba_tpu/ops/fused.py); "
            "use compute_kind=EXPLICIT or fused_kernels=False")


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

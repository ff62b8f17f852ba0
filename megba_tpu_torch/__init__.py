"""megba_tpu_torch — the PyTorch/CUDA port of megba_tpu.

Bundle adjustment by Levenberg-Marquardt with an implicit Schur-complement
PCG, running on an NVIDIA GPU through hand-written CUDA kernels
(`csrc/`), with plain PyTorch versions of each kernel for the CPU.  It
imports torch and numpy, never jax, and nothing of `megba_tpu`, whose
solver it reproduces (the tests hold the two against each other).

Entry points (`flat_solve`, `solve_bal`) run on CUDA unless asked for the
CPU with `device="cpu"`.  Jacobians come from reverse- or forward-mode
`torch.func` or the closed form (`make_residual_jacobian_fn`), with
optional Huber / Cauchy losses (`rho_and_weight`, `robustify`);
`Jet` / `seed_jets` are JetVector-style forward-mode dual numbers.
`flat_solve(..., factor=...)` solves any registered camera/point
residual family (`factors`: bal, planar, rig, pinhole_radial,
pose_prior; `register_factor` adds one), and `BaseProblem` with
`CameraVertex` / `PointVertex` / `BaseEdge` is the g2o-style object API
over it.  `solve_pgo` solves SE(3) and sim(3) pose graphs (the
registered `se3_between` / `sim3_between` families, models/pgo.py),
`solve_g2o` a `.g2o` file (io/g2o.py), and `BaseProblem` with
`PoseVertex` / `BetweenEdge` routes a pose graph to `solve_pgo`.
`RobustOption(guards=True)` contains faults, and `flat_solve(...,
fault_plan=...)` seeds them (`FaultPlan`, `make_nan_burst`,
`make_point_indefinite_burst`).  `ProblemOption(world_size=N)` solves
over N shards (`parallel/mesh.py`), the 1-D edge-sharded mesh or the 2-D
camera x edge mesh (`SolverOption(mesh_2d=True)`), given N devices that
may repeat one (`flat_solve(..., device=["cuda:0"] * N)`).
`solve_checkpointed` runs `flat_solve` in chunks of LM iterations with an
atomic, checksummed snapshot after each (the JAX package's schema-v3
format) and resumes from one transparently, after a kill too;
`solve_pgo_checkpointed` does the same for `solve_pgo`.
`flat_solve(..., triage=TriagePolicy(...))` checks a problem on the host
before any device work; its `TriageAction` REJECT raises
`ProblemRejected`, REPAIR freezes, masks, anchors and downweights, WARN
solves it as submitted.  `ProblemOption(telemetry=path)` appends one
JSONL `SolveReport` per solve (`python -m
megba_tpu_torch.observability.summarize path` renders them).
`solve_many(problems)` solves a fleet of independent problems
(`FleetProblem`), one lane-batched LM per shape bucket, and `FleetQueue`
serves them asynchronously with deadlines, escalation, admission control
and circuit breakers (`serving/`).  Several processes solve one problem
together after `parallel.multihost.initialize_multihost` joins them in a
gloo process group: `flat_solve` / `solve_pgo` at `world_size` N then
shard over every process's devices, bitwise the one-process world-N
solve, and `solve_checkpointed(..., elastic=...)` with
`robustness.elastic.resume_elastic` survives losing a process.
"""

from megba_tpu_torch.common import (
    AlgoKind,
    AlgoOption,
    ComputeKind,
    Device,
    EdgeOrder,
    JacobianMode,
    LinearSystemKind,
    PrecondKind,
    PreconditionerKind,
    ProblemOption,
    RobustKind,
    RobustOption,
    SolverKind,
    SolverOption,
    SolveStatus,
    status_name,
)
from megba_tpu_torch.core.types import BALData, BAState
from megba_tpu_torch.factors import (
    FactorError,
    FactorSpec,
    engine_for,
    get_factor,
    list_factors,
    register_factor,
)
from megba_tpu_torch.io.bal import BALFile, load_bal, loads_bal, save_bal
from megba_tpu_torch.io.synthetic import make_synthetic_bal
from megba_tpu_torch.ops.jet import Jet, seed_jets
from megba_tpu_torch.ops.residuals import (
    bal_residual,
    build_residual_jacobian_fn,
    make_residual_fn,
    make_residual_jacobian_fn,
)
from megba_tpu_torch.ops.robust import rho_and_weight, robustify
from megba_tpu_torch.problem import (
    BaseEdge,
    BaseProblem,
    BaseVertex,
    BetweenEdge,
    CameraVertex,
    PointVertex,
    PoseVertex,
    VertexKind,
)
from megba_tpu_torch.algo.checkpointed import (
    solve_checkpointed,
    solve_pgo_checkpointed,
)
from megba_tpu_torch.robustness.faults import (
    FaultPlan,
    make_nan_burst,
    make_point_indefinite_burst,
)
from megba_tpu_torch.robustness.triage import (
    ProblemRejected,
    TriageAction,
    TriagePolicy,
)
from megba_tpu_torch.serving import (
    EscalationPolicy,
    FleetProblem,
    FleetQueue,
    FleetResult,
    solve_many,
)
from megba_tpu_torch.solve import flat_solve, solve_bal


def solve_pgo(*args, **kwargs):
    """Solve a pose graph: see models/pgo.py."""
    from megba_tpu_torch.models.pgo import solve_pgo as _solve_pgo

    return _solve_pgo(*args, **kwargs)


def solve_g2o(*args, **kwargs):
    """Read and solve a .g2o pose-graph file: see io/g2o.py."""
    from megba_tpu_torch.io.g2o import solve_g2o as _solve_g2o

    return _solve_g2o(*args, **kwargs)

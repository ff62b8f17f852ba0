"""Fault containment and recovery.

- Seeded fault injection for the guarded solve (faults.py): a
  `FaultPlan` poisons chosen edges / point blocks at chosen LM
  iterations, for `RobustOption(guards=True)` to contain; the fleet
  service lowers and stacks plans per lane, and `DispatchChaos` fails or
  delays its dispatches.
- The host kill-resume harness (harness.py): SIGKILLs a checkpointed
  solve's worker process once its first snapshot lands, then resumes it.
- Pre-flight triage (triage.py): host-side structural and geometric
  checks of a problem before any device work, with a REJECT / REPAIR /
  WARN policy (`flat_solve(..., triage=TriagePolicy(...))`).
- Network fault injection (netfaults.py): `ChaosTcpProxy`, a seeded
  in-process TCP proxy (drop, delay, truncate, reorder, partition) for
  the federation transport.
- Elastic multi-process solves (elastic.py): `HeartbeatBoard` and
  `RankState` (the heartbeat files, which the federation's pipe workers
  beat too), `ElasticMonitor` / `ElasticConfig` (a rank's liveness and
  bounded dispatches; `WorkerLost`, `CollectiveTimeout`) and
  `resume_elastic` (tear down the process group, re-lower the same
  problem on this process's devices and continue from the latest
  snapshot).
"""

from megba_tpu_torch.robustness.elastic import (
    CollectiveTimeout,
    CollectiveWatchdog,
    ElasticConfig,
    ElasticError,
    ElasticMonitor,
    HeartbeatBoard,
    RankState,
    WorkerLost,
    resume_elastic,
)
from megba_tpu_torch.robustness.faults import (
    DispatchChaos,
    FaultPlan,
    InjectedDispatchError,
    lower_fault_plan,
    make_nan_burst,
    make_point_indefinite_burst,
    stack_fault_plans,
    with_offset,
)
from megba_tpu_torch.robustness.harness import (
    WorldKillOutcome,
    python_worker,
    run_to_completion,
    run_until_snapshot_then_kill,
    run_world_until_snapshot_then_kill,
)
from megba_tpu_torch.robustness.netfaults import ChaosTcpProxy, NetFaultPlan
from megba_tpu_torch.robustness.triage import (
    CheckKind,
    Finding,
    HealthReport,
    ProblemRejected,
    TriageAction,
    TriageOutcome,
    TriagePolicy,
    TriageRepair,
    check_problem,
    connected_components,
    huber_weight,
    plan_repair,
    triage_problem,
)

__all__ = [
    "ChaosTcpProxy",
    "CheckKind",
    "CollectiveTimeout",
    "CollectiveWatchdog",
    "DispatchChaos",
    "ElasticConfig",
    "ElasticError",
    "ElasticMonitor",
    "FaultPlan",
    "Finding",
    "HealthReport",
    "HeartbeatBoard",
    "InjectedDispatchError",
    "NetFaultPlan",
    "ProblemRejected",
    "RankState",
    "TriageAction",
    "TriageOutcome",
    "TriagePolicy",
    "TriageRepair",
    "WorkerLost",
    "WorldKillOutcome",
    "check_problem",
    "connected_components",
    "huber_weight",
    "lower_fault_plan",
    "make_nan_burst",
    "make_point_indefinite_burst",
    "plan_repair",
    "python_worker",
    "resume_elastic",
    "run_to_completion",
    "run_until_snapshot_then_kill",
    "run_world_until_snapshot_then_kill",
    "stack_fault_plans",
    "triage_problem",
    "with_offset",
]

"""Fault containment and recovery.

- Seeded fault injection for the guarded solve (faults.py): a
  `FaultPlan` poisons chosen edges / point blocks at chosen LM
  iterations, for `RobustOption(guards=True)` to contain.
- The host kill-resume harness (harness.py): SIGKILLs a checkpointed
  solve's worker process once its first snapshot lands, then resumes it.
- Pre-flight triage (triage.py): host-side structural and geometric
  checks of a problem before any device work, with a REJECT / REPAIR /
  WARN policy (`flat_solve(..., triage=TriagePolicy(...))`).
"""

from megba_tpu_torch.robustness.faults import (
    FaultPlan,
    make_nan_burst,
    make_point_indefinite_burst,
    with_offset,
)
from megba_tpu_torch.robustness.harness import (
    python_worker,
    run_to_completion,
    run_until_snapshot_then_kill,
)
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
    "CheckKind",
    "FaultPlan",
    "Finding",
    "HealthReport",
    "ProblemRejected",
    "TriageAction",
    "TriageOutcome",
    "TriagePolicy",
    "TriageRepair",
    "check_problem",
    "connected_components",
    "huber_weight",
    "make_nan_burst",
    "make_point_indefinite_burst",
    "plan_repair",
    "python_worker",
    "run_to_completion",
    "run_until_snapshot_then_kill",
    "triage_problem",
    "with_offset",
]

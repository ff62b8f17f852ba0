"""Serving layer: the port as a many-problem solver service.

Counterpart of `megba_tpu/serving/`:

- shape_class.py: canonical padded buckets on a power-of-two ladder, the
  JAX package's, so both packages bucket a problem alike;
- batcher.py: `solve_many`, one lane-batched LM (algo/lanes.py) per
  bucket, per-problem status and trace, bitwise independent of the
  batch-mates;
- compile_pool.py: the bucket programs, their warm-up and the JSON
  warm-up manifests;
- queue.py: `FleetQueue`, async submission with Future handles and
  deadline-driven batch flushes;
- resilience.py: deadlines, the retry-with-escalation ladder, admission
  control and the per-bucket circuit breaker;
- stats.py: `FleetStats`, the service's counters.

Not ported yet: the serialized artifacts, the federation tier, its
transport and its worker (`artifacts.py`, `federation.py`,
`transport.py`, `worker.py`).
"""

from megba_tpu_torch.serving.batcher import (
    FleetProblem,
    FleetResult,
    solve_many,
)
from megba_tpu_torch.serving.compile_pool import CompilePool, ManifestMismatch
from megba_tpu_torch.serving.queue import FleetQueue
from megba_tpu_torch.serving.resilience import (
    BreakerPolicy,
    BreakerState,
    BucketTripped,
    CircuitBreaker,
    DeadlineExceeded,
    EscalationPolicy,
    QueueRejected,
    RejectPolicy,
)
from megba_tpu_torch.serving.shape_class import (
    BucketLadder,
    PaddedProblem,
    ShapeClass,
    classify,
    pad_to_class,
)
from megba_tpu_torch.serving.stats import FleetStats

__all__ = [
    "BreakerPolicy",
    "BreakerState",
    "BucketLadder",
    "BucketTripped",
    "CircuitBreaker",
    "CompilePool",
    "DeadlineExceeded",
    "EscalationPolicy",
    "FleetProblem",
    "FleetQueue",
    "FleetResult",
    "FleetStats",
    "ManifestMismatch",
    "PaddedProblem",
    "QueueRejected",
    "RejectPolicy",
    "ShapeClass",
    "classify",
    "pad_to_class",
    "solve_many",
]

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
- stats.py: `FleetStats`, the service's counters;
- artifacts.py: `ArtifactStore`, each bucket's built kernel libraries on
  disk, so a fresh replica reaches its first solve without nvcc; stale
  or corrupt artifacts warn and fall back to a build that refreshes
  them;
- federation.py: `FleetRouter`, N worker processes each running this
  whole stack, problems sharded by shape class, idle workers stealing
  hot buckets they have warm, lost workers' problems rerouted;
- transport.py: the framed RPC under it (magic, length, blake2b digest
  and a pickle, over pipes or TCP), typed `FrameError`s, the
  register / ack handshake, `ReconnectPolicy` and the worker's
  `DedupCache`;
- worker.py: `WorkerRuntime` and the
  `python -m megba_tpu_torch.serving.worker --connect|--bind` CLI.
"""

from megba_tpu_torch.serving.artifacts import (
    ArtifactKey,
    ArtifactStore,
    ArtifactWarning,
)
from megba_tpu_torch.serving.batcher import (
    FleetProblem,
    FleetResult,
    solve_many,
)
from megba_tpu_torch.serving.compile_pool import CompilePool, ManifestMismatch
from megba_tpu_torch.serving.federation import (
    ColdDispatchWarning,
    FederationStats,
    FleetRouter,
    RoutingTable,
    WorkerLostError,
)
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
from megba_tpu_torch.serving.transport import (
    DedupCache,
    FrameDigestError,
    FrameError,
    FrameLengthError,
    FrameMagicError,
    FrameTruncatedError,
    HandshakeError,
    PipeTransport,
    ReconnectPolicy,
    TcpTransport,
)
from megba_tpu_torch.serving.worker import WorkerRuntime

__all__ = [
    "ArtifactKey",
    "ArtifactStore",
    "ArtifactWarning",
    "BreakerPolicy",
    "BreakerState",
    "BucketLadder",
    "BucketTripped",
    "CircuitBreaker",
    "ColdDispatchWarning",
    "CompilePool",
    "DeadlineExceeded",
    "DedupCache",
    "EscalationPolicy",
    "FederationStats",
    "FleetProblem",
    "FleetQueue",
    "FleetResult",
    "FleetRouter",
    "FleetStats",
    "FrameDigestError",
    "FrameError",
    "FrameLengthError",
    "FrameMagicError",
    "FrameTruncatedError",
    "HandshakeError",
    "ManifestMismatch",
    "PaddedProblem",
    "PipeTransport",
    "QueueRejected",
    "ReconnectPolicy",
    "RejectPolicy",
    "RoutingTable",
    "ShapeClass",
    "TcpTransport",
    "WorkerLostError",
    "WorkerRuntime",
    "classify",
    "pad_to_class",
    "solve_many",
]

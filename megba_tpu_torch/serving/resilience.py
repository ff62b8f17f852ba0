"""Fleet resilience: deadlines, escalation ladders, circuit breakers.

Counterpart of `megba_tpu/serving/resilience.py`: the host-side state
machines of the fleet service's policy layer, kept apart from the
dispatcher thread (serving/queue.py enforces them) so they are
unit-testable with injected clocks.

- **Deadlines** (`FleetQueue.submit(..., deadline_s=...)`): an expired
  problem is shed before dispatch (its Future raises `DeadlineExceeded`);
  a result that completes late is delivered flagged
  `FleetResult.deadline_missed`.
- **Retry with escalation** (`EscalationPolicy`): a bounded ladder of
  per-rung option transforms for unusable outcomes (`STALLED`,
  `FATAL_NONFINITE`, a non-finite cost) and dispatch errors.  Rung 1
  arms the guards and divides the initial trust region by
  `damping_deflation` (an operand of the bucket program), rung 2 takes
  conservative solver settings, rung 3 re-solves in f64.  Each rung's
  options are one bucket program of the compile pool.  The backoff
  between attempts is jittered deterministically from (policy seed,
  problem sequence number, attempt).
- **Admission control** (`RejectPolicy`): `max_pending` bounds the
  queue; RAISE fails fast with `QueueRejected`, BLOCK waits up to
  `block_timeout_s` for room.
- **Per-bucket circuit breaker** (`CircuitBreaker`): `trip_after`
  consecutive dispatch failures (exceptions, not solve statuses) open a
  bucket: submits fail fast with `BucketTripped`; after `cooldown_s` one
  half-open probe batch decides.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, FrozenSet, Optional

import numpy as np

from megba_tpu_torch.common import (
    PrecondKind,
    PreconditionerKind,
    ProblemOption,
    RETRYABLE_STATUSES,
    status_retryable,
)


class DeadlineExceeded(Exception):
    """The problem's deadline expired before dispatch; it was shed."""


class QueueRejected(Exception):
    """Admission control refused the submit (queue at max_pending)."""


class BucketTripped(Exception):
    """The bucket's circuit breaker is open; submit failed fast.

    `reason` carries the failure that tripped it (the breaker's memory
    of WHY, so callers see the root cause, not just 'tripped')."""

    def __init__(self, bucket: str, reason: str) -> None:
        super().__init__(f"bucket {bucket} is tripped: {reason}")
        self.bucket = bucket
        self.reason = reason


class RejectPolicy(enum.Enum):
    """What `FleetQueue.submit` does when the queue is at max_pending.

    RAISE = fail fast (`QueueRejected`) — the caller owns backpressure.
    BLOCK = wait up to `block_timeout_s` for capacity, then reject —
    backpressure propagates to the submitting thread.
    """

    RAISE = 0
    BLOCK = 1


@dataclasses.dataclass(frozen=True)
class EscalationPolicy:
    """The bounded retry ladder for unusable solve outcomes.

    `max_rungs` bounds the ladder (rungs 0..max_rungs-1; 4 covers the
    full transform set below, smaller values truncate it).  A solve is
    escalated when `should_retry` fires on its outcome — or, with
    `retry_dispatch_errors`, when its dispatch raised — and a rung
    remains.  Backoff before attempt k is
    `backoff_base_s * backoff_factor**(k-1)`, jittered by a
    DETERMINISTIC factor in [1-jitter, 1+jitter] seeded from
    (`seed`, problem sequence, attempt): retries de-synchronise (no
    thundering re-dispatch herd) yet replay exactly under a fixed seed.

    Rung transforms (cumulative — each rung keeps the previous rungs'
    hardening):

    | rung | change |
    |---|---|
    | 0 | as submitted |
    | 1 | `RobustOption(guards=True)` + initial trust region divided by `damping_deflation` (an operand) |
    | 2 | conservative solver: `precond=JACOBI`, `preconditioner=HPP`, no forcing / warm-start / mixed precision, fused kernels off, 2x PCG budget |
    | 3 | f64 re-solve (dtype=float64): a new shape class, its own bucket program |
    """

    max_rungs: int = 4
    retry_statuses: FrozenSet = RETRYABLE_STATUSES
    retry_dispatch_errors: bool = True
    backoff_base_s: float = 0.02
    backoff_factor: float = 2.0
    backoff_jitter: float = 0.5
    damping_deflation: float = 16.0
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_rungs < 1:
            raise ValueError(f"max_rungs must be >= 1, got {self.max_rungs}")
        if self.backoff_base_s < 0:
            raise ValueError("backoff_base_s must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1")
        if not 0.0 <= self.backoff_jitter < 1.0:
            raise ValueError(
                f"backoff_jitter must be in [0, 1), got "
                f"{self.backoff_jitter}")
        if not self.damping_deflation >= 1.0:
            raise ValueError("damping_deflation must be >= 1")

    # -- outcome classification -----------------------------------------
    def should_retry(self, status, final_cost=None) -> bool:
        """Is this solve outcome worth a rung up the ladder?  Delegates
        to `common.status_retryable` with this policy's status set, so
        the one predicate cannot drift between the library helper and
        the ladder."""
        return status_retryable(status, final_cost,
                                statuses=self.retry_statuses)

    # -- per-rung option transforms -------------------------------------
    def option_for_rung(self, base: ProblemOption,
                        rung: int) -> ProblemOption:
        """The ProblemOption attempt `rung` solves under (cumulative)."""
        if not 0 <= rung < self.max_rungs:
            raise ValueError(
                f"rung must be in [0, {self.max_rungs}), got {rung}")
        option = base
        if rung >= 1:
            option = dataclasses.replace(
                option, robust_option=dataclasses.replace(
                    option.robust_option, guards=True))
        if rung >= 2:
            # Conservative rung: every precision shortcut off (the mixed
            # rung, the bf16 rung and its collective compression) and
            # the fused kernels.
            option = dataclasses.replace(
                option, mixed_precision_pcg=False,
                solver_option=dataclasses.replace(
                    option.solver_option,
                    precond=PrecondKind.JACOBI,
                    preconditioner=PreconditionerKind.HPP,
                    forcing=False, warm_start=False,
                    bf16=False, bf16_collectives=False,
                    fused_kernels=False,
                    max_iter=2 * option.solver_option.max_iter))
        if rung >= 3:
            option = dataclasses.replace(option, dtype=np.float64)
        return option

    def initial_region_for_rung(self, base: ProblemOption,
                                rung: int) -> Optional[float]:
        """Rung >= 1 inflates initial damping (trust region divided by
        `damping_deflation`), an operand of the bucket program.  None =
        the option's own default (rung 0)."""
        if rung < 1:
            return None
        return float(base.algo_option.initial_region
                     / self.damping_deflation)

    # -- backoff ---------------------------------------------------------
    def backoff_s(self, seq: int, attempt: int) -> float:
        """Deterministic-jittered backoff before attempt `attempt`
        (>= 1) of problem `seq` (its submission sequence number)."""
        if attempt < 1:
            raise ValueError(f"attempt must be >= 1, got {attempt}")
        base = self.backoff_base_s * self.backoff_factor ** (attempt - 1)
        if self.backoff_jitter == 0.0 or base == 0.0:
            return base
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(seq), int(attempt)]))
        factor = 1.0 + self.backoff_jitter * (2.0 * float(rng.random()) - 1.0)
        return base * factor


@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    """Circuit-breaker tuning: trip threshold + half-open cooldown."""

    trip_after: int = 3
    cooldown_s: float = 1.0

    def __post_init__(self) -> None:
        if self.trip_after < 1:
            raise ValueError(f"trip_after must be >= 1, got "
                             f"{self.trip_after}")
        if self.cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")


class BreakerState(enum.Enum):
    CLOSED = 0  # serving normally
    OPEN = 1  # tripped: submits fail fast until cooldown elapses
    HALF_OPEN = 2  # one probe batch in flight; its outcome decides


@dataclasses.dataclass
class _BucketBreaker:
    state: BreakerState = BreakerState.CLOSED
    consecutive_failures: int = 0
    opened_at: float = 0.0
    reason: str = ""


class CircuitBreaker:
    """Per-bucket breaker registry (bucket key -> state machine).

    NOT thread-safe by itself: the queue calls every method under its
    own lock (one shared mutex keeps breaker state, pending buckets and
    stats counters mutually consistent — breaker state is deliberately
    keyed SEPARATELY from `FleetQueue._pending`, which prunes empty
    buckets, while trip history must survive an empty queue).

    Callbacks: `on_event(event, bucket, reason)` fires on every
    transition (`trip`, `probe`, `recover`, `fast_fail`) so the queue
    can mirror transitions into FleetStats/PhaseTimer telemetry without
    this module importing either.
    """

    def __init__(self, policy: Optional[BreakerPolicy] = None,
                 on_event=None) -> None:
        self.policy = policy or BreakerPolicy()
        self._on_event = on_event
        self._buckets: Dict[str, _BucketBreaker] = {}

    def _emit(self, event: str, bucket: str, reason: str = "") -> None:
        if self._on_event is not None:
            self._on_event(event, bucket, reason)

    def _get(self, bucket: str) -> _BucketBreaker:
        b = self._buckets.get(bucket)
        if b is None:
            b = self._buckets[bucket] = _BucketBreaker()
        return b

    def state(self, bucket: str) -> BreakerState:
        return self._get(bucket).state

    # -- submit side -----------------------------------------------------
    def check_submit(self, bucket: str, now: Optional[float] = None) -> None:
        """Raise `BucketTripped` when the bucket is open and still
        cooling down (the fail-fast contract); a bucket past cooldown
        accepts submits — they will ride the half-open probe."""
        b = self._get(bucket)
        if b.state is not BreakerState.OPEN:
            return
        now = time.monotonic() if now is None else now
        if now - b.opened_at < self.policy.cooldown_s:
            self._emit("fast_fail", bucket, b.reason)
            raise BucketTripped(bucket, b.reason)

    # -- dispatch side ---------------------------------------------------
    def admit(self, bucket: str, now: Optional[float] = None) -> bool:
        """May the dispatcher send a batch to this bucket now?

        CLOSED: yes.  OPEN within cooldown: no.  OPEN past cooldown:
        yes — the breaker moves to HALF_OPEN and this batch is the
        probe.  HALF_OPEN: no (one probe at a time)."""
        b = self._get(bucket)
        if b.state is BreakerState.CLOSED:
            return True
        if b.state is BreakerState.HALF_OPEN:
            return False
        now = time.monotonic() if now is None else now
        if now - b.opened_at >= self.policy.cooldown_s:
            b.state = BreakerState.HALF_OPEN
            self._emit("probe", bucket, b.reason)
            return True
        return False

    def reopen_at(self, bucket: str) -> Optional[float]:
        """Monotonic time the bucket becomes probe-able (None when it
        isn't OPEN) — the dispatcher's sleep bound."""
        b = self._get(bucket)
        if b.state is not BreakerState.OPEN:
            return None
        return b.opened_at + self.policy.cooldown_s

    def record_success(self, bucket: str) -> None:
        b = self._get(bucket)
        if b.state is BreakerState.HALF_OPEN:
            self._emit("recover", bucket, b.reason)
        b.state = BreakerState.CLOSED
        b.consecutive_failures = 0
        b.reason = ""

    def record_failure(self, bucket: str, reason: str,
                       now: Optional[float] = None) -> None:
        b = self._get(bucket)
        b.consecutive_failures += 1
        b.reason = reason
        # A failed half-open probe re-opens immediately; a closed bucket
        # trips once the consecutive-failure streak reaches the policy
        # threshold.
        if (b.state is BreakerState.HALF_OPEN
                or b.consecutive_failures >= self.policy.trip_after):
            b.state = BreakerState.OPEN
            b.opened_at = time.monotonic() if now is None else now
            self._emit("trip", bucket, reason)

"""Async dispatch queue: submit problems, get Future-style handles.

Counterpart of `megba_tpu/serving/queue.py`.  `FleetQueue.submit`
enqueues one problem and returns a `concurrent.futures.Future` resolving
to its `FleetResult`; a dispatcher thread groups pending problems by
shape class and flushes a bucket when it holds `max_batch` problems or
its oldest problem has waited `max_wait_s`.  Every solve runs on the
dispatcher thread (one lane-batched solve at a time, on one device);
submitters touch host queues only.  A failed batch propagates its
exception to every future of the batch and the queue keeps serving.

The resilience layer (serving/resilience.py): per-problem deadlines
(shed before dispatch with `DeadlineExceeded`, or delivered flagged
`deadline_missed`), retry with escalation (`escalation=EscalationPolicy`,
with deterministic-jittered backoff; the result carries `attempts`,
`rung` and `history`), admission control (`max_pending`,
`RejectPolicy.RAISE` / `BLOCK`) and a per-bucket circuit breaker.
`chaos` (robustness.faults.DispatchChaos) injects deterministic dispatch
failures and delays.  `submit(triage=)` health-checks a problem on the
submitter's thread first (robustness/triage.py).  With `MEGBA_FLIGHT`
armed, breaker events, sheds, escalation retries and dispatch failures
land in the flight ring (observability/flight.py).

`FleetQueue` is a context manager, `close()` drains what is pending and
is idempotent, and `flush()` dispatches everything now (batch waits,
backoff and breaker cooldowns ignored; deadlines still shed) and blocks
until every taken problem has resolved.  `device` (None: CUDA unless
the option says CPU) is the device every batch solves on.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional, Tuple

from megba_tpu_torch import observability as _obs
from megba_tpu_torch.common import ProblemOption, resolve_device
from megba_tpu_torch.serving.batcher import (
    FleetProblem,
    _check_option,
    _solve_bucket,
    _strip_telemetry,
)
from megba_tpu_torch.serving.compile_pool import CompilePool
from megba_tpu_torch.serving.resilience import (
    BreakerPolicy,
    CircuitBreaker,
    DeadlineExceeded,
    EscalationPolicy,
    QueueRejected,
    RejectPolicy,
)
from megba_tpu_torch.serving.shape_class import BucketLadder, ShapeClass, classify
from megba_tpu_torch.serving.stats import FleetStats
from megba_tpu_torch.utils.timing import PhaseTimer


@dataclasses.dataclass(eq=False)  # identity semantics: items hold arrays
class _Pending:
    problem: FleetProblem
    future: Future
    enqueued: float  # monotonic seconds
    seq: int  # submission sequence number (deterministic backoff seed)
    deadline: Optional[float] = None  # absolute monotonic; None = no deadline
    rung: int = 0  # current escalation rung
    attempts: int = 0  # dispatch attempts so far
    not_before: float = 0.0  # backoff release time (monotonic)
    history: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


class FleetQueue:
    """Deadline-batched async front door for `solve_many`-style solves.

    Knobs: `max_batch` caps a bucket's flush size (also the occupancy
    trigger); `max_wait_s` bounds how long a lone problem waits for
    batch-mates.  `ladder`/`pool`/`stats` default to fresh instances —
    a production service passes a warmed pool so the dispatch path
    never compiles.

    Resilience knobs (serving/resilience.py): `escalation` arms the
    retry ladder (None = unusable outcomes and dispatch errors go
    straight to the caller, the pre-resilience contract); `breaker`
    tunes the per-bucket circuit breaker; `max_pending` +
    `reject_policy` + `block_timeout_s` bound admission; `chaos`
    (robustness.faults.DispatchChaos) injects deterministic dispatch
    failures / delays for tests and the CI chaos smoke.
    """

    def __init__(
        self,
        option: Optional[ProblemOption] = None,
        *,
        max_batch: int = 16,
        max_wait_s: float = 0.02,
        ladder: Optional[BucketLadder] = None,
        pool: Optional[CompilePool] = None,
        stats: Optional[FleetStats] = None,
        timer: Optional[PhaseTimer] = None,
        escalation: Optional[EscalationPolicy] = None,
        breaker: Optional[BreakerPolicy] = None,
        max_pending: Optional[int] = None,
        reject_policy: RejectPolicy = RejectPolicy.RAISE,
        block_timeout_s: float = 5.0,
        chaos=None,
        device=None,
    ) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1 or None, got {max_pending}")
        if block_timeout_s < 0:
            raise ValueError(
                f"block_timeout_s must be >= 0, got {block_timeout_s}")
        option = option or ProblemOption()
        _check_option(option)
        self._option, self._telemetry, self._report_option = (
            _strip_telemetry(option))
        self.device = resolve_device(device, self._option)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.ladder = ladder or BucketLadder()
        self.stats = stats or FleetStats()
        self.pool = pool or CompilePool(stats=self.stats)
        self.timer = PhaseTimer() if timer is None else timer
        self.escalation = escalation
        self.max_pending = max_pending
        self.reject_policy = reject_policy
        self.block_timeout_s = block_timeout_s
        self._chaos = chaos
        self.breaker = CircuitBreaker(
            breaker or BreakerPolicy(), on_event=self._breaker_event)
        if escalation is not None:
            # Fail configuration errors at construction, not mid-retry:
            # every rung's option transform must validate.
            for rung in range(escalation.max_rungs):
                _check_option(escalation.option_for_rung(self._option, rung))

        self._lock = threading.Condition()
        # (shape class, feature dims, factor, escalation rung) ->
        # pending items.  Rung is part of the key because each rung
        # solves under its own option (its own compiled program);
        # factor is part of the key because each residual family is its
        # own engine — a bucket is one family by construction.  Empty
        # buckets are PRUNED when their last item is taken — breaker
        # state lives in `self.breaker`, keyed separately, so trip
        # history survives an empty queue.
        self._pending: Dict[
            Tuple[ShapeClass, Tuple[int, int, int], str, int],
            List[_Pending]] = {}
        self._inflight = 0  # megba: guarded-by(_lock); taken, unresolved
        self._npending = 0  # megba: guarded-by(_lock); O(1) pending gauge
        self._seq = 0  # megba: guarded-by(_lock)
        self._closing = False  # megba: guarded-by(_lock)
        # Active flush() count, not a bool: concurrent flushes must not
        # clobber each other's drain mode (the first to finish would
        # otherwise strand the second behind backoff/breaker waits).
        self._force = 0  # megba: guarded-by(_lock)
        self._thread = threading.Thread(
            target=self._run, name="megba-fleet-dispatch", daemon=True)
        self._thread.start()

    # -- resilience plumbing ---------------------------------------------
    def _breaker_event(self, event: str, bucket: str, reason: str) -> None:
        self.stats.record_breaker(event)
        self.timer.count_event(f"breaker_{event}")
        flight = _obs.flight_recorder()
        if flight is not None:
            flight.record("breaker", event=event, bucket=bucket,
                          reason=reason)

    def _rung_option(self, rung: int) -> ProblemOption:
        if rung == 0 or self.escalation is None:
            return self._option
        return self.escalation.option_for_rung(self._option, rung)

    def _rung_report_option(self, rung: int) -> ProblemOption:
        """The config a rung's telemetry reports claim: the RUNG's
        transforms applied to the caller's (telemetry-carrying) option —
        a rung-2 report must say guards=True/JACOBI, not the rung-0
        config the problem was submitted under."""
        if rung == 0 or self.escalation is None:
            return self._report_option
        return self.escalation.option_for_rung(self._report_option, rung)

    def _triage_problem(self, problem: FleetProblem, policy,
                        spec) -> FleetProblem:
        """Run pre-flight triage on one submission (host-side, on the
        submitter's thread).  Raises `ProblemRejected` under REJECT;
        returns the (possibly repaired) problem otherwise, with the
        HealthReport dict attached so it rides FleetResult/telemetry."""
        from megba_tpu_torch.robustness.triage import TriageAction, triage_problem

        # The problem's own mask/fixed operands ride into the checks so
        # triage sees the graph the solver will (see check_problem);
        # the (already dim-validated) factor spec dispatches the
        # geometric hooks — a non-projective family skips
        # cheirality/parallax entirely.
        outcome = triage_problem(problem.cameras, problem.points,
                                 problem.obs, problem.cam_idx,
                                 problem.pt_idx, policy,
                                 edge_mask=problem.edge_mask,
                                 cam_fixed=problem.cam_fixed,
                                 pt_fixed=problem.pt_fixed,
                                 factor=spec)
        health = outcome.report.to_dict()
        rep = outcome.repair
        if rep is None or rep.is_noop:
            if outcome.report.degenerate:
                # WARN on a degenerate problem: flagged, not touched.
                self.stats.record_triage("warned")
                self.timer.count_event("triage_warn")
            return dataclasses.replace(problem, health=health)
        assert outcome.action == TriageAction.REPAIR
        self.stats.record_triage("repaired", rep.counters())
        self.timer.count_event("triage_repair")
        for name, n in rep.counters().items():
            if n:
                self.timer.count_event(f"triage_{name}", n)
        cameras, points, obs = rep.merged_arrays(
            problem.cameras, problem.points, problem.obs)
        em, cf, pf = rep.merge_operands(
            problem.edge_mask, problem.cam_fixed, problem.pt_fixed)
        return dataclasses.replace(
            problem, cameras=cameras, points=points, obs=obs,
            edge_mask=em, cam_fixed=cf, pt_fixed=pf, health=health)

    def _key_for(
        self, problem: FleetProblem, rung: int,
    ) -> Tuple[ShapeClass, Tuple[int, int, int], str, int]:
        opt = self._rung_option(rung)
        n_cam, n_pt, n_edge = problem.dims()
        sc = classify(n_cam, n_pt, n_edge, opt.dtype, self.ladder)
        dims = (int(problem.cameras.shape[1]),
                int(problem.points.shape[1]), int(problem.obs.shape[1]))
        return (sc, dims, problem.factor, rung)

    def _depth_locked(self) -> int:
        """Pending problems that still want service: client-cancelled
        items don't hold admission capacity (the dispatcher drops them
        at its next pass)."""
        return sum(1 for items in self._pending.values()
                   for it in items if not it.future.cancelled())

    # -- submission ------------------------------------------------------
    def submit(self, problem: FleetProblem,
               deadline_s: Optional[float] = None,
               triage=None) -> "Future":
        """Enqueue one problem; the Future resolves to its FleetResult
        (or raises what its batch raised / `DeadlineExceeded` when it
        was shed / `QueueRejected` / `BucketTripped` /
        `ProblemRejected` when triage refused it).

        `deadline_s` is relative to NOW: once it expires the problem is
        shed before dispatch; a result completing after it is delivered
        flagged `deadline_missed`.

        `triage` (robustness.triage.TriagePolicy) arms CONTENT
        admission control next to `max_pending`'s capacity admission:
        the problem is health-checked on the submitter's thread (host
        NumPy, milliseconds) BEFORE it touches the queue.  Under
        REJECT a degenerate problem's Future resolves immediately with
        `ProblemRejected` (full HealthReport attached) — it never
        holds queue capacity, never enters the escalation ladder, and
        costs ZERO device time.  Under REPAIR the repaired problem
        (masks + sanitised arrays as pure operands) is enqueued in its
        place; under WARN the report is attached and the problem rides
        unchanged.  Without `triage`, the shared ingestion gate
        (io/bal.validate_problem) still refuses non-finite/duplicate
        poison by raising at this boundary.
        """
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
        from megba_tpu_torch.serving.batcher import (
            _problem_spec,
            _validate_problem,
        )

        # Factor resolution + block-dim check FIRST: an unknown name or
        # wrong-width array must fail typed here, before the triage
        # hooks (which index the spec's columns) could trip on it.
        spec = _problem_spec(problem)
        if triage is not None:
            from megba_tpu_torch.robustness.triage import ProblemRejected

            try:
                problem = self._triage_problem(problem, triage, spec)
            except ProblemRejected as exc:
                # Content rejection resolves the Future FAST: no queue
                # capacity held, no escalation ladder, zero dispatch.
                self.stats.record_triage("rejected")
                self.timer.count_event("triage_reject")
                f: Future = Future()
                f.set_exception(exc)
                return f
        # The shared ingestion gate still runs after triage when the
        # policy's structural pass (which subsumes the duplicate check)
        # was disabled — _validate_problem skips itself otherwise.  The
        # option rides along for the robust-eligibility refusal (a
        # robust kernel on a robust_ok=False family fails typed here,
        # exactly like flat_solve's boundary).
        _validate_problem(problem, option=self._option)
        key = self._key_for(problem, rung=0)
        now = time.monotonic()
        item = _Pending(
            problem=problem, future=Future(), enqueued=now, seq=-1,
            deadline=None if deadline_s is None else now + deadline_s)
        with self._lock:
            if self._closing:
                raise RuntimeError("FleetQueue is closed")
            # Breaker fast-fail: a tripped bucket refuses work instantly
            # instead of queueing problems that will sit out a cooldown.
            self.breaker.check_submit(str(key[0]), now)
            # Admission decisions use the authoritative scan — a
            # lazily-discovered client cancel() must free capacity, and
            # max_pending bounds the scan on the services that care.
            # The peak gauge rides the O(1) _npending counter instead,
            # so an UNBOUNDED queue never pays per-submit scans.
            if (self.max_pending is not None
                    and self._depth_locked() >= self.max_pending):
                if self.reject_policy is RejectPolicy.RAISE:
                    self.stats.record_reject()
                    raise QueueRejected(
                        f"queue at max_pending={self.max_pending}")
                wait_until = time.monotonic() + self.block_timeout_s
                while (self._depth_locked() >= self.max_pending
                       and not self._closing):
                    remaining = wait_until - time.monotonic()
                    if remaining <= 0:
                        self.stats.record_reject()
                        raise QueueRejected(
                            f"queue at max_pending={self.max_pending} "
                            f"for {self.block_timeout_s}s")
                    self._lock.wait(timeout=remaining)
                if self._closing:
                    raise RuntimeError("FleetQueue is closed")
            item.seq = self._seq
            self._seq += 1
            self._pending.setdefault(key, []).append(item)
            self._npending += 1
            self.stats.record_depth(self._npending)
            self._lock.notify_all()
        return item.future

    def flush(self) -> None:
        """Dispatch everything pending NOW (batch-wait deadlines,
        backoff and breaker cooldowns ignored — per-problem deadlines
        still shed: an expired problem resolves `DeadlineExceeded`, a
        force-dispatch would not make its answer wanted again) and
        block until every taken problem has RESOLVED — drained
        notification, not a poll.  `_force` is reset in a `finally` so
        an exception mid-flush (timeout signal, KeyboardInterrupt) can
        never wedge later deadline flushes."""
        with self._lock:
            self._force += 1
            self._lock.notify_all()
            try:
                while any(self._pending.values()) or self._inflight > 0:
                    self._lock.wait()
            finally:
                self._force -= 1
                self._lock.notify_all()

    def close(self) -> None:
        """Drain pending work, then stop the dispatcher thread.
        Idempotent: repeat calls re-join the (finished) thread."""
        with self._lock:
            self._closing = True
            self._lock.notify_all()
        self._thread.join()

    def __enter__(self) -> "FleetQueue":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- dispatcher ------------------------------------------------------
    @staticmethod
    def _resolve(future: Future, result=None, exc=None) -> None:
        """Resolve a future, tolerating a client-side cancel() racing
        the check (set_* on a just-cancelled future raises
        InvalidStateError, which must never kill the dispatcher)."""
        try:
            if future.cancelled():
                return
            if exc is not None:
                future.set_exception(exc)
            else:
                future.set_result(result)
        except InvalidStateError:  # the client's cancel won the race
            pass

    def _shed_expired_locked(self, now: float) -> List[_Pending]:
        """Remove deadline-expired items from every bucket (their
        futures are failed OUTSIDE the lock by the caller).  Items
        whose future was cancelled client-side are dropped too — a
        cancel before dispatch costs zero device time."""
        shed: List[_Pending] = []
        kept = 0
        for key in list(self._pending):
            items = self._pending[key]
            keep = []
            for it in items:
                if it.future.cancelled():
                    continue
                if it.deadline is not None and now >= it.deadline:
                    shed.append(it)
                else:
                    keep.append(it)
            if len(keep) == len(items):
                # Nothing removed: keep the existing list (no per-wakeup
                # reallocation churn on a deep deadline-free queue; the
                # wakeup is O(pending items) regardless — _ripe_buckets
                # walks them too — and admission control is the tool
                # that bounds it).
                kept += len(items)
            elif keep:
                self._pending[key] = keep
                kept += len(keep)
            else:
                del self._pending[key]
        self._npending = kept
        return shed

    def _ripe_buckets(self, now: float, drain: bool):
        """Buckets due for flush + the sleep until the next event
        (bucket deadline, problem deadline, backoff release, breaker
        cooldown expiry — whichever comes first)."""
        ripe = []
        wake: Optional[float] = None

        def note(t: Optional[float]) -> None:
            nonlocal wake
            if t is not None and t > now and (wake is None or t < wake):
                wake = t

        for key, items in self._pending.items():
            if not items:
                continue
            for it in items:
                note(it.deadline)  # shed promptly, not at next flush
                if it.not_before > now:
                    note(it.not_before)
            eligible = [it for it in items
                        if drain or it.not_before <= now]
            if not eligible:
                continue
            oldest = min(it.enqueued for it in eligible)
            due = (drain or len(eligible) >= self.max_batch
                   or now >= oldest + self.max_wait_s)
            if not due:
                note(oldest + self.max_wait_s)
                continue
            # Breaker gate LAST: `admit` flips OPEN->HALF_OPEN (probe)
            # as a side effect, so only consult it for a batch that
            # would otherwise dispatch right now.  Drain (flush/close)
            # bypasses it: drained futures must resolve.
            if not drain and not self.breaker.admit(str(key[0]), now):
                note(self.breaker.reopen_at(str(key[0])))
                continue
            ripe.append(key)
        timeout = None if wake is None else max(wake - now, 0.0)
        return ripe, timeout

    def _run(self) -> None:
        while True:
            with self._lock:
                now = time.monotonic()
                shed = self._shed_expired_locked(now)
                if shed:
                    self.stats.record_shed(len(shed))
                    self.timer.count_event("deadline_shed", len(shed))
                    flight = _obs.flight_recorder()
                    if flight is not None:
                        flight.record(
                            "queue_shed", count=len(shed),
                            names=[it.problem.name for it in shed[:8]])
                    # Shed items count as in-flight until their futures
                    # carry DeadlineExceeded (set outside the lock):
                    # flush() must not observe "drained" while a shed
                    # future is still unresolved.
                    self._inflight += 1
                drain = self._closing or self._force
                ripe, timeout = self._ripe_buckets(now, drain)
                batches = []
                for key in ripe:
                    items = self._pending[key]
                    eligible = [it for it in items
                                if drain or it.not_before <= now]
                    take = eligible[:self.max_batch]
                    rest = [it for it in items if it not in take]
                    if rest:
                        self._pending[key] = rest
                    else:
                        del self._pending[key]  # prune: no empty buckets
                    self._npending -= len(take)
                    self._inflight += 1
                    batches.append((key, take))
                stop = (not batches and not shed and self._closing
                        and not any(self._pending.values()))
                self._lock.notify_all()
                if stop:
                    return
                if not batches and not shed:
                    self._lock.wait(timeout=timeout)
                    continue
            if shed:
                for it in shed:
                    self._resolve(it.future, exc=DeadlineExceeded(
                        f"problem {it.problem.name!r} shed before "
                        f"dispatch (deadline expired; rung {it.rung}, "
                        f"{it.attempts} attempts)"))
                with self._lock:
                    self._inflight -= 1
                    self._lock.notify_all()
            for key, taken in batches:
                try:
                    self._dispatch(key, taken)
                except Exception as exc:  # never kill the dispatcher
                    for it in taken:
                        if not it.future.done():
                            self._resolve(it.future, exc=exc)
                finally:
                    with self._lock:
                        self._inflight -= 1
                        self._lock.notify_all()

    def _requeue_locked(self, item: _Pending) -> None:
        """Push one item back onto the ladder at the next rung with
        deterministic-jittered backoff (see EscalationPolicy)."""
        item.rung += 1
        backoff = self.escalation.backoff_s(item.seq, item.attempts)
        item.not_before = time.monotonic() + backoff
        key = self._key_for(item.problem, item.rung)
        self._pending.setdefault(key, []).append(item)
        self._npending += 1
        self.stats.record_retry(item.rung)
        self.timer.count_event("fleet_retry")
        flight = _obs.flight_recorder()
        if flight is not None:
            flight.record("escalation_retry", name=item.problem.name,
                          rung=item.rung, attempts=item.attempts)

    def _dispatch(self, key, taken: List[_Pending]) -> None:
        sc, _dims, factor, rung = key
        bucket = str(sc)
        option = self._rung_option(rung)
        initial_region = (None if self.escalation is None else
                          self.escalation.initial_region_for_rung(
                              self._option, rung))
        for it in taken:
            it.attempts += 1
        items = [(i, p.problem) for i, p in enumerate(taken)]
        # Per-factor engine, resolved per dispatch (memoised: one
        # factor+mode = one engine object process-wide, so this costs a
        # dict hit, and a mixed-factor queue can never cross-batch).
        from megba_tpu_torch.factors import engine_for

        engine = engine_for(factor, option.jacobian_mode)
        t_dispatch = time.monotonic()
        for it in taken:
            # Submit-to-dispatch wait (first attempt only: a retry's
            # wait would double-count its earlier dispatch).
            if it.attempts == 1:
                self.stats.record_wait(bucket, t_dispatch - it.enqueued)
        try:
            if self._chaos is not None:
                self._chaos.before_dispatch(bucket)
            solved = _solve_bucket(
                items, sc, option, engine, self.ladder,
                self.pool, self.stats, self.timer, self._telemetry,
                self._rung_report_option(rung),
                initial_region=initial_region,
                rung=rung, attempts=rung + 1, factor=factor,
                device=self.device)
        except Exception as exc:  # fan out or escalate, keep serving
            self._on_dispatch_failure(bucket, taken, exc)
            return
        with self._lock:
            self.breaker.record_success(bucket)
        now = time.monotonic()
        retries: List[_Pending] = []
        for lane_i, fr in solved:
            it = taken[lane_i]
            fr.latency_s = now - it.enqueued
            fr.history = list(it.history)
            expired = it.deadline is not None and now >= it.deadline
            if (self.escalation is not None and not expired
                    and it.rung + 1 < self.escalation.max_rungs
                    and self.escalation.should_retry(fr.status, fr.cost)):
                it.history.append({
                    "rung": it.rung, "status": int(fr.status),
                    "status_name": fr.status_name, "error": None})
                retries.append(it)
                continue
            if expired:
                fr.deadline_missed = True
                self.stats.record_deadline_miss()
                self.timer.count_event("deadline_miss")
            self._resolve(it.future, result=fr)
        if retries:
            with self._lock:
                for it in retries:
                    self._requeue_locked(it)
                self._lock.notify_all()

    def _on_dispatch_failure(self, bucket: str, taken: List[_Pending],
                             exc: Exception) -> None:
        flight = _obs.flight_recorder()
        if flight is not None:
            flight.record("dispatch_failure", bucket=bucket,
                          problems=len(taken), error=repr(exc))
        with self._lock:
            self.breaker.record_failure(bucket, repr(exc))
        now = time.monotonic()
        retries: List[_Pending] = []
        for it in taken:
            expired = it.deadline is not None and now >= it.deadline
            if (self.escalation is not None
                    and self.escalation.retry_dispatch_errors
                    and it.rung + 1 < self.escalation.max_rungs
                    and not expired):
                it.history.append({"rung": it.rung, "status": None,
                                   "status_name": None, "error": repr(exc)})
                retries.append(it)
            else:
                if expired:
                    # The dispatch error is the diagnostic the caller
                    # needs, but the expired deadline must not vanish
                    # from the counters (it was dispatched in time, so
                    # it is a miss, not a shed).
                    self.stats.record_deadline_miss()
                    self.timer.count_event("deadline_miss")
                self._resolve(it.future, exc=exc)
        if retries:
            with self._lock:
                for it in retries:
                    self._requeue_locked(it)
                self._lock.notify_all()

"""Federation tier: one router, N worker processes, a fleet of fleets.

Counterpart of `megba_tpu/serving/federation.py`.  `solve_many` /
`FleetQueue` serve one process; a `FleetRouter` fronts N worker
processes, each running the port's single-host serving stack (the
compile pool and `solve_many` over the lane-batched LM,
algo/lanes.py) behind a framed pickle RPC (serving/transport.py) over
its stdin/stdout pipes (`transport="pipe"`) or TCP (`transport="tcp"`).
Workers are fresh interpreters started with `subprocess.Popen`, never
forked: the router may hold a CUDA context.  A worker imports the
package found on its `PYTHONPATH` (the router's own unless `worker_env`
names another) and runs on the device and dtype of the option the
config frame carries: the card unless the option asks for the CPU.

Three connected mechanisms:

- **Shape-class routing, occupancy-aware.**  Problems shard across
  workers by shape class: all problems of one bucket flow to one worker
  until stolen or rerouted, so per-worker lane fill stays high.  A new
  class lands on a worker that already has it warm, then on the
  least-loaded worker (`RoutingTable`, a pure host policy class).

- **Work stealing for hot buckets.**  An idle worker pulls queued
  problems of buckets it has warm from the deepest backlog of a busy
  peer, before it would build anything new.  Stealing moves work, never
  assignments.

- **Host-loss rerouting.**  A dead worker is a dispatch exception plus
  a requeue: liveness is `robustness.elastic.HeartbeatBoard` (pipe
  workers beat heartbeat files; the router watches the counters on its
  own clock) plus pipe EOF and process exit; a loss is a typed
  `WorkerLostError`, and the lost worker's in-flight and queued problems
  re-route to survivors, bounded by `max_reroutes`, with `worker_lost` /
  `rerouted` counters — never silently, never wedging `flush()`.

Cold start is the third leg (serving/artifacts.py): workers warm from a
manifest and a store of built kernel libraries, so a fresh replica
reaches its first solve without running nvcc (its hello reports the
builds it paid, `cold_start.nvcc_builds`, and its first solve's,
`first_solve.traces`).

The workers' bucket programs are the single-host ones and a lane's bits
do not depend on its batch-mates, so a federated fleet's results are
bitwise the `solve_many` results of the same problems however routing,
stealing, rerouting or resends scattered them.

Over TCP the router binds a listening socket, workers dial in (or the
router dials bind-mode workers via `connect=`) and register through a
token / version / fingerprint handshake.  A dropped TCP connection is
not a worker loss: the handle enters a reconnect window
(`ReconnectPolicy`, deterministic seeded jitter) during which the
worker's buckets detour to warm peers; in-flight requests are resent by
sequence id (the worker's reply cache dedups), and only the window's
exhaustion or the process's death becomes the `WorkerLostError`
reroute path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import uuid
import warnings
import zlib
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from megba_tpu_torch import observability as _obs
from megba_tpu_torch.serving.resilience import DeadlineExceeded
from megba_tpu_torch.serving.transport import (
    FrameError,
    HandshakeError,
    PipeTransport,
    ReconnectPolicy,
    TcpTransport,
    is_heartbeat,
    parse_address,
    refusal_frame,
    ack_frame,
    verify_register,
)
from megba_tpu_torch.utils.timing import monotonic_s, wall_unix


class ColdDispatchWarning(UserWarning):
    """A dispatch targeted a worker with no ready program for its
    (bucket, lanes, rung) key — a compile-on-dispatch latency cliff the
    artifact manifest should have covered.  Warned ONCE per missing
    key; every occurrence counts (`fed_cold_dispatch`)."""


class WorkerLostError(RuntimeError):
    """A federation worker died (or stopped beating) with work on it.

    `worker_id` names the worker, `reason` what was observed (pipe EOF,
    process exit code, heartbeat staleness).  Problems that exhaust
    `max_reroutes` across successive losses fail with this error — the
    caller sees WHY, never a hang.
    """

    def __init__(self, worker_id: str, reason: str) -> None:
        self.worker_id = worker_id
        self.reason = reason
        super().__init__(f"federation worker {worker_id!r} lost: {reason}")


# ---------------------------------------------------------------------------
# Connection supervision primitives
# ---------------------------------------------------------------------------


class _ConnSuspect(Exception):
    """Internal: the connection looks dead (heartbeat silence) but the
    worker may be fine behind it — enter the reconnect window rather
    than the loss path."""


class _NeverTransport:
    """Placeholder transport for a TCP handle awaiting its first
    registration: every operation reports 'not connected', which the
    reconnect machinery treats like any other dropped link."""

    def send(self, obj: Any) -> None:
        raise BrokenPipeError("worker not yet connected")

    def recv(self, timeout_s: Optional[float] = None,
             poll: Optional[Callable[[], None]] = None) -> Any:
        raise FrameError("worker not yet connected")

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Routing policy (pure host state, unit-testable without processes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WorkerView:
    """What the routing policy may know about one worker.

    `alive` is the terminal flag (process dead / reconnect budget
    exhausted — buckets re-home); `connected` is the transient one (the
    TCP link dropped but the worker may return inside its reconnect
    window — buckets DETOUR to warm peers, the assignment survives)."""

    worker_id: str
    warm: set  # bucket strs with a ready (artifact/compiled) program
    alive: bool = True
    connected: bool = True
    assigned: set = dataclasses.field(default_factory=set)  # bucket strs
    routed: int = 0  # problems ever routed here (load tiebreak)


class RoutingTable:
    """Shape-class → worker assignment with warm-first affinity.

    Policy, in order: (1) sticky — a bucket keeps its worker while that
    worker lives (occupancy: one home per bucket fills lanes instead of
    splitting them); (2) warm-first — a NEW bucket goes to a live
    worker that already holds its program (artifact-installed libraries
    make this common after one export cycle); (3) least-loaded — fewest
    assigned buckets, then fewest routed problems, then worker id (a
    deterministic tiebreak so tests and reruns route identically).

    `steal_candidate` picks what an idle worker should pull: the
    DEEPEST backlog among buckets homed on other live workers that the
    thief has WARM — it never volunteers a bucket it would have to
    compile for (that would trade queueing delay for compile delay).

    Pure host state over caller-supplied views; the router drives it
    under its own lock.
    """

    def __init__(self) -> None:
        self.assignment: Dict[str, str] = {}  # bucket str -> worker id

    def route(self, bucket: str,
              workers: Dict[str, WorkerView]) -> Optional[str]:
        homed = self.assignment.get(bucket)
        if homed is not None and workers[homed].alive:
            if workers[homed].connected:
                return homed
            # Home is inside its reconnect window: DETOUR this pick to
            # a connected peer that already holds the program, without
            # re-homing — the assignment survives the flap, but work
            # keeps flowing (routable-away).  No warm peer: wait for
            # the home to return rather than compile elsewhere.
            detour = [w for w in workers.values()
                      if w.alive and w.connected and bucket in w.warm]
            if detour:
                best = min(detour, key=lambda w: (len(w.assigned),
                                                  w.routed, w.worker_id))
                return best.worker_id
            return homed
        alive = [w for w in workers.values()
                 if w.alive and w.connected]
        if not alive:
            # Every survivor is mid-reconnect: fall back to any live
            # worker so routing still lands somewhere (the dispatch
            # will ride that handle's reconnect window).
            alive = [w for w in workers.values() if w.alive]
        if not alive:
            return None
        warm = [w for w in alive if bucket in w.warm]
        pool = warm or alive
        best = min(pool, key=lambda w: (len(w.assigned), w.routed,
                                        w.worker_id))
        self.assignment[bucket] = best.worker_id
        best.assigned.add(bucket)
        return best.worker_id

    def steal_candidate(self, thief: str, workers: Dict[str, WorkerView],
                        depths: Dict[str, int]) -> Optional[str]:
        """Bucket the idle `thief` should pull work from, or None."""
        view = workers[thief]
        candidates = [
            (depth, bucket) for bucket, depth in depths.items()
            if depth > 0 and bucket in view.warm
            and self.assignment.get(bucket) not in (None, thief)
            and workers[self.assignment[bucket]].alive
        ]
        if not candidates:
            return None
        _, bucket = max(candidates, key=lambda c: (c[0], c[1]))
        return bucket

    def reassign_lost(self, lost: str,
                      workers: Dict[str, WorkerView]) -> List[str]:
        """Forget every bucket homed on `lost`; they re-route on next
        pick.  Returns the orphaned bucket names."""
        orphaned = [b for b, w in self.assignment.items() if w == lost]
        for b in orphaned:
            del self.assignment[b]
        if lost in workers:
            workers[lost].assigned.clear()
        return orphaned


# ---------------------------------------------------------------------------
# Federation stats
# ---------------------------------------------------------------------------


class FederationStats:
    """Router-level counters: where problems ran, what moved, what died.

    The per-worker `FleetStats` still live inside each worker (their
    dispatch telemetry embeds them); this object is the ROUTER's view —
    the one `summarize --aggregate`'s federation block renders."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.router = uuid.uuid4().hex[:12]
        self.problems = 0  # guarded by _lock; resolved via router
        self.problems_by_worker: Dict[str, int] = {}  # guarded by _lock
        self.steals = 0  # guarded by _lock; one per pulled batch
        self.stolen_problems = 0  # guarded by _lock
        self.reroutes = 0  # guarded by _lock; requeued off a loss
        self.reroute_failures = 0  # guarded by _lock; max_reroutes hit
        self.escalations = 0  # guarded by _lock; ladder consults past max_reroutes
        self.cold_dispatches = 0  # guarded by _lock; dispatches with no warm program on target
        self.workers_lost = 0  # guarded by _lock
        self.sheds = 0  # guarded by _lock; shed before dispatch
        self.deadline_misses = 0  # guarded by _lock; delivered late
        self.cold_start: Dict[str, Dict[str, Any]] = {}  # guarded by _lock; worker -> hello
        self.first_solve: Dict[str, Dict[str, Any]] = {}  # guarded by _lock
        self.lost_workers: List[str] = []  # guarded by _lock

    def record_batch(self, worker_id: str, n: int, stolen: bool) -> None:
        with self._lock:
            self.problems += n
            self.problems_by_worker[worker_id] = (
                self.problems_by_worker.get(worker_id, 0) + n)
            if stolen:
                self.steals += 1
                self.stolen_problems += n

    def record_reroute(self, n: int) -> None:
        with self._lock:
            self.reroutes += n

    def record_reroute_failure(self, n: int = 1) -> None:
        with self._lock:
            self.reroute_failures += n

    def record_escalation(self, n: int = 1) -> None:
        with self._lock:
            self.escalations += n

    def record_cold_dispatch(self, n: int = 1) -> None:
        with self._lock:
            self.cold_dispatches += n

    def record_worker_lost(self, worker_id: str) -> None:
        with self._lock:
            self.workers_lost += 1
            self.lost_workers.append(worker_id)

    def record_shed(self, n: int = 1) -> None:
        with self._lock:
            self.sheds += n

    def record_deadline_miss(self, n: int = 1) -> None:
        with self._lock:
            self.deadline_misses += n

    def record_cold_start(self, worker_id: str,
                          info: Dict[str, Any]) -> None:
        with self._lock:
            self.cold_start[worker_id] = dict(info)

    def record_first_solve(self, worker_id: str,
                           info: Dict[str, Any]) -> None:
        with self._lock:
            self.first_solve[worker_id] = dict(info)

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "router": self.router,
                "problems": self.problems,
                "problems_by_worker": dict(self.problems_by_worker),
                "steals": self.steals,
                "stolen_problems": self.stolen_problems,
                "reroutes": self.reroutes,
                "reroute_failures": self.reroute_failures,
                "escalations": self.escalations,
                "cold_dispatches": self.cold_dispatches,
                "workers_lost": self.workers_lost,
                "lost_workers": list(self.lost_workers),
                "sheds": self.sheds,
                "deadline_misses": self.deadline_misses,
                "cold_start": {k: dict(v)
                               for k, v in self.cold_start.items()},
                "first_solve": {k: dict(v)
                                for k, v in self.first_solve.items()},
            }

    def report(self) -> str:
        d = self.as_dict()
        per = " / ".join(
            f"{w}:{n}" for w, n in sorted(d["problems_by_worker"].items()))
        lines = [
            f"federation: {d['problems']} problems ({per or 'none'}), "
            f"{d['steals']} steals ({d['stolen_problems']} problems), "
            f"{d['reroutes']} rerouted, {d['workers_lost']} workers lost"]
        for w, cs in sorted(d["cold_start"].items()):
            fs = d["first_solve"].get(w) or {}
            lines.append(
                f"  {w}: cold start {cs.get('mode', '?')} "
                f"{cs.get('warm_s', float('nan')):.3f}s "
                f"({cs.get('artifact_loads', 0)} loaded / "
                f"{cs.get('artifact_compiles', 0)} compiled)"
                + (f", first solve {fs.get('traces')} traces"
                   if fs else ""))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Router-side worker handle
# ---------------------------------------------------------------------------


class WorkerHandle:
    """One spawned worker: process + channel + router-side bookkeeping.

    `request` is strictly lockstep at the FRAME level (the worker's
    serve loop answers one request at a time, in arrival order) but no
    lock is ever held across the blocking reply read: sends are
    serialized under `_req_lock` and stamped with a ticket, and replies
    are read in ticket order under the `_turn` condition — the reader
    whose turn it is owns the pipe with every lock released, so an
    out-of-band `metrics` pull never stalls a lock behind a whole solve
    RPC.  Every request carries a sequence id; the reader skims heartbeat frames
    and drops stale duplicate replies, matching on its own seq.  Every
    death signal — pipe EOF, process exit, heartbeat DEAD — converts
    into a typed `WorkerLostError`, and the FIRST observed death is
    recorded so every later waiter fails FAST instead of re-spending a
    full watchdog budget on a connection already known dead."""

    def __init__(self, worker_id: str, proc: Optional[subprocess.Popen],
                 chan, log_path: str,
                 liveness: Optional[Callable[[], Optional[str]]] = None,
                 ) -> None:
        self.worker_id = worker_id
        self.proc = proc
        self.chan = chan
        self.log_path = log_path
        self.liveness = liveness
        # `warm`/`alive` are confined to this worker's serve thread once
        # it starts (spawn-time writes order-before via Thread.start;
        # close() reads only after joining it).  Cross-thread consumers
        # go through FleetRouter's locked `_views` mirror instead — see
        # metrics_snapshot().
        self.warm: set = set()
        self.alive = True
        self.pid = proc.pid if proc is not None else None
        self.rank = 0  # heartbeat-board rank, set by the router at spawn
        # First observed death reason: write-once latch (benign racing
        # writers would record equivalent reasons); readers fail fast
        # without waiting on a channel that can never answer.
        self._death: Optional[str] = None
        self.last_rx = monotonic_s()  # any frame (incl. heartbeats)
        # Serializes SENDS (the channel is strictly lockstep, so two
        # concurrent writers would interleave frames) and hands out
        # reply tickets; never held across a read.
        self._req_lock = threading.Lock()
        self._next_send = 0  # guarded by _req_lock
        self._seq = 0  # guarded by _req_lock; request sequence ids
        # Orders reply reads: replies arrive in send order (the worker
        # serve loop is single-threaded FIFO), so ticket n reads the
        # n-th reply — exclusivity without holding anything during the
        # blocking recv.
        self._turn = threading.Condition()
        self._next_recv = 0  # guarded by _turn

    def _record_death(self, reason: str) -> None:
        if self._death is None:
            self._death = reason

    def _check_death(self) -> None:
        death = self._death
        if death is not None:
            raise WorkerLostError(self.worker_id,
                                  f"{death} (fail-fast: recorded death)")

    def _poll(self) -> None:
        if self.proc is not None:
            rc = self.proc.poll()
            if rc is not None:
                raise WorkerLostError(self.worker_id,
                                      f"process exited rc={rc}")
        if self.liveness is not None:
            reason = self.liveness()
            if reason:
                raise WorkerLostError(self.worker_id, reason)

    def request(self, msg: Dict[str, Any],
                timeout_s: Optional[float] = None) -> Dict[str, Any]:
        self._check_death()
        try:
            with self._req_lock:
                seq = self._seq
                self._seq += 1
                msg = dict(msg)
                msg["seq"] = seq
                self.chan.send(msg)
                ticket = self._next_send
                self._next_send += 1
            with self._turn:
                while self._next_recv != ticket:
                    self._turn.wait()
            try:
                # Our turn: ticket order makes this thread the sole
                # reader, with no lock held across the blocking recv.
                self._check_death()
                return self._recv_reply(seq, timeout_s)
            finally:
                # Always pass the turn — even on a broken pipe the next
                # ticket holder must wake (its fail-fast check or its
                # own recv then raises).
                with self._turn:
                    self._next_recv += 1
                    self._turn.notify_all()
        except WorkerLostError as exc:
            self._record_death(exc.reason)
            raise
        except (FrameError, BrokenPipeError, OSError) as exc:
            rc = self.proc.poll() if self.proc is not None else None
            reason = (f"rpc stream broke ({type(exc).__name__}: {exc}); "
                      f"process rc={rc}")
            self._record_death(reason)
            raise WorkerLostError(self.worker_id, reason) from exc

    def _recv_reply(self, seq: int,
                    timeout_s: Optional[float]) -> Dict[str, Any]:
        """Read frames until this request's reply: heartbeats update
        liveness and are skimmed; a reply with an older seq is a stale
        duplicate (post-reconnect resend race) and is dropped."""
        deadline = None if timeout_s is None else (
            monotonic_s() + timeout_s)
        while True:
            remaining = None if deadline is None else max(
                deadline - monotonic_s(), 0.0)
            frame = self.chan.recv(timeout_s=remaining, poll=self._poll)
            self.last_rx = monotonic_s()
            if is_heartbeat(frame):
                continue
            fseq = frame.get("seq") if isinstance(frame, dict) else None
            if fseq is not None and fseq != seq:
                continue
            return frame

    def log_tail(self, max_bytes: int = 8192) -> str:
        try:
            with open(self.log_path, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                size = fh.tell()
                fh.seek(max(size - max_bytes, 0))
                return fh.read().decode(errors="replace")
        except OSError:
            return "<no worker log>"

    def terminate(self) -> None:
        self.alive = False
        self.chan.close()
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass


class TcpWorkerHandle(WorkerHandle):
    """A worker reached over TCP: the channel can DROP without the
    worker dying.

    On a connection failure the reader does not raise `WorkerLostError`
    — it enters the reconnect window: wait (on the router's own clock)
    for the accept/dial machinery to `adopt` a fresh transport, then
    RESEND its request with the SAME sequence id.  The worker's reply
    cache makes the resend idempotent: work it already did is answered
    from cache, never re-executed.  Only window exhaustion or process
    death converts to the typed loss path."""

    def __init__(self, worker_id: str, chan, *,
                 proc: Optional[subprocess.Popen] = None,
                 log_path: str = "",
                 reconnect: Optional[ReconnectPolicy] = None,
                 conn_dead_after_s: float = 5.0,
                 on_event: Optional[Callable[..., None]] = None) -> None:
        super().__init__(worker_id, proc, chan, log_path, liveness=None)
        self.reconnect = reconnect or ReconnectPolicy()
        self.conn_dead_after_s = float(conn_dead_after_s)
        self.incarnation = 0
        self._on_event = on_event
        # Transport generation: bumped by adopt(); readers stranded on
        # a dead connection wait here for the replacement.
        self._tlock = threading.Condition()
        self._epoch = 0  # guarded by _tlock

    def _emit(self, event: str, **fields: Any) -> None:
        if self._on_event is not None:
            self._on_event(event, worker=self.worker_id, **fields)

    def adopt(self, transport, incarnation: int) -> None:
        """Install a freshly-registered connection (accept/dial thread)
        and wake every reader waiting out the reconnect window."""
        with self._tlock:
            old = self.chan
            self.chan = transport
            self.incarnation = int(incarnation)
            self._epoch += 1
            epoch = self._epoch
            self.last_rx = monotonic_s()
            self._tlock.notify_all()
        try:
            old.close()
        except OSError:
            pass
        # Epoch 1 is the worker's FIRST registration — that is a
        # connect, not a reconnect (the metric must count recoveries).
        self._emit("reconnect" if epoch > 1 else "connect",
                   incarnation=int(incarnation))

    def _poll(self) -> None:
        if self.proc is not None:
            rc = self.proc.poll()
            if rc is not None:
                raise WorkerLostError(self.worker_id,
                                      f"process exited rc={rc}")
        if (self.conn_dead_after_s > 0
                and monotonic_s() - self.last_rx > self.conn_dead_after_s):
            raise _ConnSuspect(
                f"no frames or heartbeats for {self.conn_dead_after_s:.1f}s")

    def request(self, msg: Dict[str, Any],
                timeout_s: Optional[float] = None) -> Dict[str, Any]:
        self._check_death()
        try:
            with self._req_lock:
                seq = self._seq
                self._seq += 1
                msg = dict(msg)
                msg["seq"] = seq
                with self._tlock:
                    sent_epoch = self._epoch
                try:
                    self.chan.send(msg)
                except OSError:
                    # Connection already down: take the ticket anyway;
                    # the reader resends once a transport is adopted.
                    sent_epoch -= 1
                ticket = self._next_send
                self._next_send += 1
            with self._turn:
                while self._next_recv != ticket:
                    self._turn.wait()
            try:
                self._check_death()
                return self._reply_with_reconnect(
                    msg, seq, sent_epoch, timeout_s)
            finally:
                with self._turn:
                    self._next_recv += 1
                    self._turn.notify_all()
        except WorkerLostError as exc:
            self._record_death(exc.reason)
            raise

    def _reply_with_reconnect(self, msg: Dict[str, Any], seq: int,
                              sent_epoch: int,
                              timeout_s: Optional[float],
                              ) -> Dict[str, Any]:
        deadline = None if timeout_s is None else (
            monotonic_s() + timeout_s)
        # The staleness clock starts when we BEGIN listening: nobody
        # drains heartbeats while the handle is idle, so a healthy
        # worker's beats sit unread in the socket buffer and last_rx
        # goes stale — an idle gap must not read as silence.
        self.last_rx = max(self.last_rx, monotonic_s())
        while True:
            self._check_death()
            with self._tlock:
                cur_epoch = self._epoch
                chan = self.chan
            if cur_epoch > sent_epoch:
                # Reconnected since this request went out: resend with
                # the same seq (idempotent — the worker's dedup cache
                # answers anything it already executed from cache).
                try:
                    chan.send(msg)
                except OSError:
                    self._await_reconnect(cur_epoch, deadline)
                    continue
                sent_epoch = cur_epoch
                self._emit("resend", seq=seq, op=msg.get("op"))
            remaining = None if deadline is None else max(
                deadline - monotonic_s(), 0.0)
            try:
                frame = chan.recv(timeout_s=remaining, poll=self._poll)
            except _ConnSuspect as exc:
                self._emit("conn_lost", reason=str(exc))
                self._await_reconnect(cur_epoch, deadline)
                continue
            except TimeoutError:
                raise  # the watchdog budget: the serve loop types it
            except (FrameError, OSError) as exc:
                self._emit("conn_lost",
                           reason=f"{type(exc).__name__}: {exc}")
                self._await_reconnect(cur_epoch, deadline)
                continue
            self.last_rx = monotonic_s()
            if is_heartbeat(frame):
                continue
            fseq = frame.get("seq") if isinstance(frame, dict) else None
            if fseq is not None and fseq != seq:
                continue  # stale duplicate from before the reconnect
            return frame

    def _await_reconnect(self, seen_epoch: int,
                         watchdog_deadline: Optional[float]) -> None:
        """Wait out the reconnect window on the router's own clock:
        returns once a NEWER transport than `seen_epoch` is adopted;
        raises typed on window exhaustion, process death, or watchdog
        expiry.  The Condition wait releases the lock (the sanctioned
        blocking-under-lock shape)."""
        window_end = monotonic_s() + self.reconnect.window_s
        with self._tlock:
            while self._epoch <= seen_epoch:
                self._check_death()
                if self.proc is not None:
                    rc = self.proc.poll()
                    if rc is not None:
                        raise WorkerLostError(
                            self.worker_id,
                            f"process exited rc={rc} during the "
                            "reconnect window")
                now = monotonic_s()
                if watchdog_deadline is not None and now >= watchdog_deadline:
                    raise TimeoutError(
                        "watchdog budget expired inside the reconnect "
                        "window")
                if now >= window_end:
                    raise WorkerLostError(
                        self.worker_id,
                        "reconnect window exhausted "
                        f"({self.reconnect.window_s:.1f}s without "
                        "re-registration)")
                self._tlock.wait(timeout=0.05)

    def terminate(self) -> None:
        self._record_death("terminated by router")
        with self._tlock:
            self._tlock.notify_all()  # readers fail fast, not time out
        super().terminate()


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------


def _worker_environ(worker_env: Dict[str, str]) -> Dict[str, str]:
    """The workers' environment: this process's, with the directory of
    the router's own package first on PYTHONPATH, then `worker_env` (a
    `PYTHONPATH` there names the package the workers import).  Device
    and dtype travel in the config frame's option, not here."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    env.update(worker_env)
    return env


@dataclasses.dataclass(eq=False)
class _Routed:
    problem: Any  # FleetProblem
    future: Future
    bucket: str  # shape-class str (routing granularity)
    key: Tuple  # (ShapeClass, dims) — batching granularity
    enqueued: float
    deadline: Optional[float] = None
    reroutes: int = 0
    seq: int = 0  # submission sequence (escalation backoff seed)
    escalated: bool = False  # ladder consulted once past max_reroutes
    not_before: Optional[float] = None  # escalation backoff gate


class FleetRouter:
    """Front door of the federation tier: submit → Future, N workers.

    Mirrors `FleetQueue`'s surface (submit/flush/close/context-manager,
    Future-per-problem) one level up: submissions shard across worker
    PROCESSES by shape class, idle workers steal hot buckets they have
    warm, and a dead worker's problems re-route to survivors (bounded
    by `max_reroutes`) with typed counters.  `artifacts` + `manifest`
    give workers the millisecond cold start (serving/artifacts.py);
    without them workers compile on first warm like any fresh service.

    `workers=` injects pre-built worker handles (anything with
    `worker_id`/`warm`/`alive`/`request`/`terminate`) — the unit tests
    drive the full routing/steal/reroute machinery through in-process
    stubs with zero subprocesses and zero compiles.
    """

    def __init__(
        self,
        option=None,
        *,
        n_workers: int = 2,
        max_batch: int = 16,
        ladder=None,
        artifacts: Optional[str] = None,
        manifest: Optional[str] = None,
        strict_manifest: bool = False,
        stats: Optional[FederationStats] = None,
        timer=None,
        steal: bool = True,
        max_reroutes: int = 2,
        heartbeat_dir: Optional[str] = None,
        dead_after_s: float = 5.0,
        warm_timeout_s: float = 1800.0,
        watchdog_s: float = 1800.0,
        telemetry: Optional[str] = None,
        worker_env: Optional[Dict[str, str]] = None,
        pin_cpus: bool = False,
        workers: Optional[Sequence[Any]] = None,
        transport: str = "pipe",
        bind: Optional[str] = None,
        advertise: Optional[str] = None,
        connect: Sequence[str] = (),
        token: Optional[str] = None,
        reconnect: Optional[ReconnectPolicy] = None,
        conn_dead_after_s: float = 5.0,
        hb_interval_s: float = 0.25,
        accept_new: bool = False,
        escalation=None,
    ) -> None:
        from megba_tpu_torch.common import ProblemOption
        from megba_tpu_torch.serving.batcher import _check_option
        from megba_tpu_torch.serving.shape_class import BucketLadder
        from megba_tpu_torch.utils.timing import PhaseTimer

        option = option or ProblemOption()
        _check_option(option)
        if transport not in ("pipe", "tcp"):
            raise ValueError(
                f"transport must be 'pipe' or 'tcp', got {transport!r}")
        if transport == "pipe" and (bind or advertise or connect
                                    or accept_new):
            raise ValueError(
                "bind/advertise/connect/accept_new require "
                "transport='tcp'")
        allow_zero = transport == "tcp" and (connect or accept_new)
        if n_workers < 1 and workers is None and not allow_zero:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        if max_reroutes < 0:
            raise ValueError(
                f"max_reroutes must be >= 0, got {max_reroutes}")
        self.option = option
        self.ladder = ladder or BucketLadder()
        self.max_batch = int(max_batch)
        self.steal = bool(steal)
        self.max_reroutes = int(max_reroutes)
        self.watchdog_s = float(watchdog_s)
        self.warm_timeout_s = float(warm_timeout_s)
        self.stats = stats or FederationStats()
        self.timer = PhaseTimer() if timer is None else timer
        self.telemetry = telemetry
        self.transport = transport
        self.escalation = escalation
        self.reconnect = reconnect or ReconnectPolicy()
        self._token = token
        self._conn_dead_after_s = float(conn_dead_after_s)
        self._hb_interval_s = float(hb_interval_s)
        self._accept_new = bool(accept_new)
        self.address: Optional[str] = None  # tcp: the bound host:port
        self._lsock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._dial_threads: List[threading.Thread] = []
        self._env_fp: Dict[str, str] = {}
        self._artifacts = artifacts
        self._manifest = manifest
        self._strict_manifest = bool(strict_manifest)
        self._slices: Dict[str, Any] = {}  # wid -> cpu affinity slice

        self._lock = threading.Condition()
        self._nsubmitted = 0  # guarded by _lock
        self._cold_warned: set = set()  # guarded by _lock; warned (bucket, lanes, rung)
        self._hello: Dict[str, Dict[str, Any]] = {}  # guarded by _lock; tcp registration rendezvous
        self._closing_accept = False  # guarded by _lock
        self._redial: Dict[str, threading.Event] = {}  # guarded by _lock; dial addr -> wake event
        self._wid_addr: Dict[str, str] = {}  # guarded by _lock; wid -> dialed addr
        self._pending: Dict[Tuple, List[_Routed]] = {}  # guarded by _lock
        self._npending = 0  # guarded by _lock
        self._closed = False  # guarded by _lock
        self.pinned = False  # did worker CPU pinning actually apply?
        self._own_hb_dir: Optional[str] = None
        # Deadline-carrying items currently pending: the shed scan is
        # O(pending) under the router lock on every serve-thread wakeup,
        # so it only runs while this is nonzero (deadline-free fleets —
        # the common case — pay nothing).
        self._ndeadline = 0  # guarded by _lock
        self._inflight = 0  # guarded by _lock
        self._closing = False  # guarded by _lock
        self._table = RoutingTable()  # guarded by _lock
        self._views: Dict[str, WorkerView] = {}  # guarded by _lock
        # Serializes HeartbeatBoard.observe across serve threads: the
        # board's observation maps are thread-confined state, and every
        # worker's liveness closure may poll concurrently.
        self._hb_lock = threading.Lock()
        self._board = None  # set once in _spawn_workers, pre-thread-start

        if workers is not None:
            self.workers: Dict[str, Any] = {w.worker_id: w for w in workers}
        elif transport == "tcp":
            self.workers = self._spawn_workers_tcp(
                n_workers, warm_timeout_s, worker_env or {}, pin_cpus,
                bind, advertise, connect)
        else:
            self.workers = self._spawn_workers(
                n_workers, artifacts, manifest, strict_manifest,
                heartbeat_dir, dead_after_s, warm_timeout_s,
                worker_env or {}, pin_cpus)
        with self._lock:
            for w in self.workers.values():
                if w.worker_id not in self._views:  # tcp path pre-filled
                    self._views[w.worker_id] = WorkerView(
                        worker_id=w.worker_id, warm=set(w.warm),
                        alive=w.alive)
            self._threads = [
                threading.Thread(target=self._serve, args=(w,),
                                 name=f"megba-fed-{w.worker_id}",
                                 daemon=True)
                for w in self.workers.values()
            ]
        for t in self._threads:
            t.start()

    # -- spawning --------------------------------------------------------
    def _spawn_workers(self, n, artifacts, manifest, strict_manifest,
                       heartbeat_dir, dead_after_s, warm_timeout_s,
                       worker_env, pin_cpus=False) -> Dict[str, WorkerHandle]:
        from megba_tpu_torch.robustness.elastic import HeartbeatBoard, RankState

        env = _worker_environ(worker_env)

        slices = self._compute_cpu_slices(n, pin_cpus)

        if heartbeat_dir is None:
            heartbeat_dir = tempfile.mkdtemp(prefix="megba_fed_hb_")
            self._own_hb_dir = heartbeat_dir  # removed on close()
        world = n + 1  # rank 0 = the router (observer only)
        self._board = HeartbeatBoard(
            heartbeat_dir, 0, world, dead_after_s=dead_after_s)
        self._dead_state = RankState.DEAD

        handles: Dict[str, WorkerHandle] = {}
        pending: List[Tuple[WorkerHandle, Any]] = []
        try:
            for i in range(n):
                wid = f"w{i}"
                log = tempfile.NamedTemporaryFile(
                    prefix=f"megba_fed_{wid}_", suffix=".log",
                    delete=False)
                # -c entry rather than -m: runpy would re-execute the
                # module it had already imported via the package
                # __init__; -P keeps the working directory off sys.path,
                # so the package comes from PYTHONPATH.
                proc = subprocess.Popen(
                    [sys.executable, "-P", "-c",
                     "import sys; "
                     "from megba_tpu_torch.serving.worker import "
                     "pipe_worker_main; sys.exit(pipe_worker_main())"],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=log, env=env)
                log.close()
                chan = PipeTransport(proc.stdout, proc.stdin)
                rank = i + 1
                # Heartbeat liveness is armed AFTER the hello: a worker
                # spends its first seconds importing torch before it can
                # beat, and the board's join grace (dead_after_s) is
                # sized for steady-state loss detection, not interpreter
                # startup on a loaded host.  Until then, pipe EOF and
                # process exit (checked every recv slice) cover real
                # startup deaths.
                handle = WorkerHandle(wid, proc, chan, log.name,
                                      liveness=None)
                handle.rank = rank
                chan.send({
                    "op": "config", "worker_id": wid,
                    "option": self.option, "ladder": self.ladder,
                    "artifacts": artifacts, "manifest": manifest,
                    "strict_manifest": strict_manifest,
                    "heartbeat": {"dir": heartbeat_dir, "rank": rank,
                                  "world": world},
                    "cpu_affinity": slices[i],
                    "telemetry": (None if self.telemetry is None
                                  else f"{self.telemetry}.{wid}"),
                })
                pending.append((handle, None))
                handles[wid] = handle
            for handle, _ in pending:
                try:
                    hello = handle.chan.recv(timeout_s=warm_timeout_s,
                                             poll=handle._poll)
                except (FrameError, WorkerLostError, TimeoutError) as exc:
                    raise RuntimeError(
                        f"federation worker {handle.worker_id} failed to "
                        f"come up: {exc}\n--- worker log ---\n"
                        f"{handle.log_tail()}") from exc
                if not hello.get("ok"):
                    raise RuntimeError(
                        f"federation worker {handle.worker_id} refused "
                        f"config: {hello.get('error')}\n--- worker log "
                        f"---\n{handle.log_tail()}")
                handle.warm = set(hello.get("warm", ()))
                handle.liveness = self._liveness_for(handle.rank,
                                                    handle.worker_id)
                self.stats.record_cold_start(
                    handle.worker_id, hello.get("cold_start", {}))
        except Exception:
            for handle in handles.values():
                handle.terminate()
            raise
        return handles

    def _compute_cpu_slices(self, n: int, pin_cpus) -> List[Any]:
        # `pin_cpus`: split the host's cores into contiguous slices, one
        # per worker — each worker's thread pools then own its slice
        # instead of all workers thrashing one shared set (the
        # data-parallel deployment shape, one host's cores = one
        # worker's world).  True = cores // n each; an int = exactly
        # that many cores per worker (an equal-resource scaling sweep
        # pins 1 and n workers to the same per-worker slice).
        slices: List[Optional[List[int]]] = [None] * n
        if pin_cpus and n:
            try:
                cores = sorted(os.sched_getaffinity(0))
            except (AttributeError, OSError):
                cores = []
            per = (int(pin_cpus) if pin_cpus is not True
                   else (len(cores) // n if cores else 0))
            if per >= 1 and len(cores) >= per * n:
                slices = [cores[i * per:(i + 1) * per] for i in range(n)]
            else:
                warnings.warn(
                    f"pin_cpus={pin_cpus!r} needs {per or 1} core(s) x "
                    f"{n} workers but only {len(cores)} are available; "
                    "workers run UNPINNED (a benchmark reading "
                    "equal-resource scaling from this run would be "
                    "comparing asymmetric configurations)", stacklevel=4)
        self.pinned = slices[0] is not None if slices else False
        return slices

    # -- TCP fabric ------------------------------------------------------
    def _spawn_workers_tcp(self, n, warm_timeout_s, worker_env, pin_cpus,
                           bind, advertise, connect) -> Dict[str, Any]:
        """Bind the fleet socket, spawn n workers that dial (back) in,
        start the accept/dial supervision threads, and block until
        every spawned worker has registered and said hello."""
        from megba_tpu_torch.serving.artifacts import current_environment

        env = _worker_environ(worker_env)
        if self._token:
            env["MEGBA_FED_TOKEN"] = self._token
        self._env_fp = current_environment()

        slices = self._compute_cpu_slices(n, pin_cpus)
        host, port = parse_address(bind or "127.0.0.1:0")
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((host, port))
        lsock.listen(64)
        lsock.settimeout(0.2)  # accept slices re-check the closing flag
        self._lsock = lsock
        bound = lsock.getsockname()
        self.address = f"{bound[0]}:{bound[1]}"
        # `advertise` is what the spawned workers DIAL — normally the
        # bound address, but a chaos proxy (robustness/netfaults.py) or
        # a NAT sits between in tests and real deployments.
        dial_addr = advertise or self.address

        handles: Dict[str, Any] = {}
        self.workers = handles  # accept thread resolves handles here
        expected: List[str] = []
        for i in range(n):
            wid = f"w{i}"
            self._slices[wid] = slices[i]
            log = tempfile.NamedTemporaryFile(
                prefix=f"megba_fed_{wid}_", suffix=".log", delete=False)
            # -c entry rather than -m (see _spawn_workers), -P for the
            # package of PYTHONPATH.
            proc = subprocess.Popen(
                [sys.executable, "-P", "-c",
                 "import sys; from megba_tpu_torch.serving.worker import "
                 "main; sys.exit(main(sys.argv[1:]))",
                 "--connect", dial_addr, "--worker-id", wid,
                 "--hb-interval", str(self._hb_interval_s),
                 "--reconnect-attempts", str(self.reconnect.max_attempts),
                 "--reconnect-base", str(self.reconnect.base_s),
                 "--reconnect-cap", str(self.reconnect.cap_s),
                 "--reconnect-window", str(self.reconnect.window_s),
                 "--reconnect-jitter", str(self.reconnect.jitter),
                 "--reconnect-seed", str(self.reconnect.seed)],
                stdin=subprocess.DEVNULL, stdout=log,
                stderr=subprocess.STDOUT, env=env)
            log.close()
            handle = TcpWorkerHandle(
                wid, _NeverTransport(), proc=proc, log_path=log.name,
                reconnect=self.reconnect,
                conn_dead_after_s=self._conn_dead_after_s,
                on_event=self._transport_event)
            handle.rank = i + 1
            with self._lock:
                handles[wid] = handle
                # Disconnected until the register+hello lands.
                self._views[wid] = WorkerView(
                    worker_id=wid, warm=set(), alive=True,
                    connected=False)
            expected.append(wid)

        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="megba-fed-accept")
        self._accept_thread.start()
        for addr in connect:
            t = threading.Thread(target=self._dial_loop,
                                 args=(str(addr),), daemon=True,
                                 name=f"megba-fed-dial-{addr}")
            t.start()
            self._dial_threads.append(t)

        # Rendezvous: the accept thread fills _hello as registrations
        # complete; fail fast on worker death, typed on timeout.
        fail_msg: Optional[str] = None
        deadline = monotonic_s() + warm_timeout_s
        with self._lock:
            while fail_msg is None:
                missing = [w for w in expected if w not in self._hello]
                bad = [(w, h) for w, h in self._hello.items()
                       if not h.get("ok")]
                if bad:
                    wid, h = bad[0]
                    fail_msg = (
                        f"federation worker {wid} refused config: "
                        f"{h.get('error')}\n--- worker log ---\n"
                        f"{handles[wid].log_tail()}")
                    break
                if not missing:
                    break
                for wid in missing:
                    proc = handles[wid].proc
                    if proc is not None and proc.poll() is not None:
                        fail_msg = (
                            f"federation worker {wid} exited "
                            f"rc={proc.returncode} before registering"
                            f"\n--- worker log ---\n"
                            f"{handles[wid].log_tail()}")
                        break
                if fail_msg is None and monotonic_s() > deadline:
                    fail_msg = (
                        f"federation workers {missing} failed to "
                        f"register within {warm_timeout_s:.0f}s")
                if fail_msg is None:
                    self._lock.wait(timeout=0.2)
        if fail_msg is not None:
            self._teardown_tcp()
            raise RuntimeError(fail_msg)
        return handles

    def _config_for(self, wid: str) -> Dict[str, Any]:
        return {
            "op": "config", "worker_id": wid,
            "option": self.option, "ladder": self.ladder,
            "artifacts": self._artifacts, "manifest": self._manifest,
            "strict_manifest": self._strict_manifest,
            "cpu_affinity": self._slices.get(wid),
            "telemetry": (None if self.telemetry is None
                          else f"{self.telemetry}.{wid}"),
        }

    def _accept_loop(self) -> None:
        while True:
            with self._lock:
                if self._closing_accept:
                    return
            try:
                sock, _peer = self._lsock.accept()
            except TimeoutError:
                continue
            except OSError:
                return  # listener closed: router shutting down
            self._register_connection(sock)

    def _register_connection(self, sock) -> Optional[str]:
        """Run the register handshake on one fresh connection; on
        success adopt the transport into the worker's handle (waking
        any reader stuck in its reconnect window).  Returns the worker
        id, or None when the connection was refused/dropped."""
        t = TcpTransport(sock)
        reg: Any = None
        try:
            reg = t.recv(timeout_s=10.0)
            wid = verify_register(reg, self._token, self._env_fp)
        except HandshakeError as exc:
            self._transport_event(
                "handshake_refused",
                worker=str((reg or {}).get("worker_id", "?")
                           if isinstance(reg, dict) else "?"),
                field=exc.field)
            with contextlib.suppress(OSError):
                t.send(refusal_frame(exc))
            t.close()
            return None
        except (FrameError, TimeoutError, OSError):
            t.close()
            return None

        with self._lock:
            handle = self.workers.get(wid)
            view = self._views.get(wid)
            was_alive = bool(view.alive) if view is not None else False
        if handle is None and not self._accept_new:
            exc = HandshakeError("worker_id", wid,
                                 "a registered worker id")
            with contextlib.suppress(OSError):
                t.send(refusal_frame(exc))
            t.close()
            return None

        fresh = handle is None or not was_alive
        needs_config = fresh or bool(reg.get("needs_config", True))
        try:
            if needs_config:
                t.send(ack_frame("config", self._token, wid,
                                 config=self._config_for(wid)))
            else:
                t.send(ack_frame("resume", self._token, wid))
            hello = t.recv(timeout_s=self.warm_timeout_s)
        except (FrameError, TimeoutError, OSError):
            t.close()
            return None
        if not isinstance(hello, dict) or not hello.get("ok"):
            with self._lock:
                self._hello[wid] = (hello if isinstance(hello, dict)
                                    else {"ok": False,
                                          "error": repr(hello)})
                self._lock.notify_all()
            t.close()
            return None

        if fresh and (handle is None or not was_alive):
            # Unknown id (accept_new) or a worker previously declared
            # LOST re-registering after a restart: the old handle's
            # death latch is permanent, so it gets a replacement (and a
            # fresh serve thread below).
            handle = TcpWorkerHandle(
                wid, _NeverTransport(), proc=None,
                reconnect=self.reconnect,
                conn_dead_after_s=self._conn_dead_after_s,
                on_event=self._transport_event)
        warm = set(hello.get("warm", ()))
        handle.warm = set(warm)
        handle.adopt(t, int(reg.get("incarnation", 0)))
        serve_thread: Optional[threading.Thread] = None
        with self._lock:
            self.workers[wid] = handle
            view = self._views.get(wid)
            if view is None or not view.alive:
                self._views[wid] = WorkerView(
                    worker_id=wid, warm=set(warm), alive=True,
                    connected=True)
                if view is not None:
                    self._transport_event("revived", worker=wid)
                serve_thread = threading.Thread(
                    target=self._serve, args=(handle,),
                    name=f"megba-fed-{wid}", daemon=True)
                self._threads.append(serve_thread)
            else:
                view.connected = True
                view.warm = set(warm)
            self._hello[wid] = hello
            self._lock.notify_all()
        if hello.get("cold_start"):
            self.stats.record_cold_start(wid, hello["cold_start"])
        if serve_thread is not None:
            serve_thread.start()
        return wid

    def _dial_loop(self, addr: str) -> None:
        """Router-initiated connections for bind-mode workers: dial,
        hand the socket to the register flow, then sleep until the
        connection drops (conn_lost wakes us) and redial under the
        reconnect policy's deterministic backoff."""
        key = zlib.crc32(addr.encode())
        attempt = 0
        ev = threading.Event()
        while True:
            with self._lock:
                if self._closing_accept:
                    return
                self._redial[addr] = ev
            try:
                sock = socket.create_connection(parse_address(addr),
                                                timeout=5.0)
                sock.settimeout(None)
            except OSError:
                attempt += 1
                if attempt > self.reconnect.max_attempts:
                    self._transport_event("dial_exhausted", worker=addr)
                    return
                time.sleep(self.reconnect.backoff_s(key, attempt))
                continue
            wid = self._register_connection(sock)
            if wid is None:
                attempt += 1
                if attempt > self.reconnect.max_attempts:
                    self._transport_event("dial_exhausted", worker=addr)
                    return
                time.sleep(self.reconnect.backoff_s(key, attempt))
                continue
            attempt = 0
            with self._lock:
                self._wid_addr[wid] = addr
            ev.clear()
            ev.wait()  # conn_lost (or close) wakes the redial

    def _transport_event(self, event: str, worker: str = "?",
                         **fields: Any) -> None:
        """Every transport event lands in all three observability
        planes (metrics counter, zero-duration span, flight record) +
        the phase timer; conn_lost additionally flips the routing view
        to detour mode and wakes the redial thread."""
        self.timer.count_event(f"transport_{event}")
        registry = _obs.metrics_registry()
        if registry is not None:
            registry.counter(
                f"megba_transport_{event}_total",
                f"Federation transport events: {event}").inc(
                    worker=worker)
        recorder = _obs.span_recorder()
        if recorder is not None:
            with recorder.span(f"transport_{event}", worker=worker,
                               **fields):
                pass
        flight = _obs.flight_recorder()
        if flight is not None:
            flight.record(f"transport_{event}", worker=worker, **fields)
        if event == "conn_lost":
            ev = None
            with self._lock:
                view = self._views.get(worker)
                if view is not None:
                    view.connected = False
                ev = self._redial.get(self._wid_addr.get(worker, ""))
                self._lock.notify_all()
            if ev is not None:
                ev.set()

    def _teardown_tcp(self) -> None:
        with self._lock:
            self._closing_accept = True
            events = list(self._redial.values())
            self._lock.notify_all()
        for ev in events:
            ev.set()
        if self._lsock is not None:
            with contextlib.suppress(OSError):
                self._lsock.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        for w in list(self.workers.values()):
            w.terminate()

    def _liveness_for(self, rank: int, wid: str):
        def check() -> Optional[str]:
            if self._board is None:
                return None
            with self._hb_lock:
                states = self._board.observe()
                stale = self._board.staleness(rank)
            if states.get(rank) is self._dead_state:
                return (f"heartbeat dead (rank {rank} silent "
                        f"{stale:.2f}s)")
            return None

        return check

    # -- submission ------------------------------------------------------
    def _key_for(self, problem) -> Tuple:
        from megba_tpu_torch.serving.shape_class import classify

        n_cam, n_pt, n_edge = problem.dims()
        sc = classify(n_cam, n_pt, n_edge, self.option.dtype, self.ladder)
        # The factor name rides the dims element (same 2-tuple shape the
        # routing/steal sites unpack): a routed batch must be one
        # residual family, exactly like the local queue's bucket key.
        dims = (int(problem.cameras.shape[1]),
                int(problem.points.shape[1]), int(problem.obs.shape[1]),
                str(getattr(problem, "factor", "bal")))
        return (sc, dims)

    def submit(self, problem, deadline_s: Optional[float] = None) -> Future:
        """Enqueue one problem; the Future resolves to its FleetResult
        (or raises `WorkerLostError` after `max_reroutes` losses /
        `DeadlineExceeded` when shed / whatever its worker's solve
        raised)."""
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
        key = self._key_for(problem)
        now = time.monotonic()
        item = _Routed(
            problem=problem, future=Future(), bucket=str(key[0]), key=key,
            enqueued=now,
            deadline=None if deadline_s is None else now + deadline_s)
        with self._lock:
            if self._closing:
                raise RuntimeError("FleetRouter is closed")
            if not any(v.alive for v in self._views.values()):
                raise WorkerLostError("*", "no surviving workers")
            item.seq = self._nsubmitted
            self._nsubmitted += 1
            self._pending.setdefault(key, []).append(item)
            self._npending += 1
            if item.deadline is not None:
                self._ndeadline += 1
            self._lock.notify_all()
        return item.future

    def submit_many(self, problems: Sequence[Any],
                    deadline_s: Optional[float] = None) -> List[Future]:
        """Enqueue a whole fleet ATOMICALLY (one lock acquisition): no
        worker can pick a partial bucket mid-submission, so batch
        composition — and therefore the (bucket, lanes) programs hit —
        is deterministic for a given fleet.  A replica whose artifacts
        were exported from a `solve_many` pass over the same fleet then
        dispatches it entirely from the store (the nvcc-free cold-start
        contract); per-problem `submit` keeps the latency-shaped
        streaming semantics instead."""
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
        now = time.monotonic()
        items = []
        for problem in problems:
            key = self._key_for(problem)
            items.append(_Routed(
                problem=problem, future=Future(), bucket=str(key[0]),
                key=key, enqueued=now,
                deadline=None if deadline_s is None else now + deadline_s))
        with self._lock:
            if self._closing:
                raise RuntimeError("FleetRouter is closed")
            if not any(v.alive for v in self._views.values()):
                raise WorkerLostError("*", "no surviving workers")
            for item in items:
                item.seq = self._nsubmitted
                self._nsubmitted += 1
                self._pending.setdefault(item.key, []).append(item)
            self._npending += len(items)
            self._ndeadline += sum(
                1 for item in items if item.deadline is not None)
            self._lock.notify_all()
        return [item.future for item in items]

    def flush(self) -> None:
        """Block until every submitted problem has RESOLVED (result,
        reroute-exhaustion error, shed, or solve error).  Worker losses
        during the wait re-route work and keep the flush honest: it
        returns only when nothing is pending OR in flight."""
        with self._lock:
            while self._npending > 0 or self._inflight > 0:
                self._lock.wait()

    def close(self) -> None:
        """Drain, stop serve threads, shut workers down, emit the
        federation telemetry report.  Idempotent: a second close (e.g.
        context-manager exit after an explicit close) is a no-op — in
        particular it must not append a duplicate federation report
        line to the telemetry sink."""
        with self._lock:
            already = self._closed
            self._closing = True
            self._closed = True
            self._lock.notify_all()
        if already:
            return
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join()
        for w in list(self.workers.values()):
            if w.alive:
                try:
                    w.request({"op": "shutdown"}, timeout_s=30.0)
                    proc = getattr(w, "proc", None)
                    if proc is not None:  # let the clean exit land
                        proc.wait(timeout=10)
                except (WorkerLostError, TimeoutError,
                        subprocess.TimeoutExpired):
                    pass
            w.terminate()
            # Clean-exit worker logs are noise; keep a log only when
            # the worker died abnormally (its tail is the forensics
            # WorkerLostError already quoted).
            rc = getattr(getattr(w, "proc", None), "returncode", None)
            log_path = getattr(w, "log_path", None)
            if log_path and rc == 0:
                try:
                    os.unlink(log_path)
                except OSError:
                    pass
        if self._lsock is not None:
            # TCP fabric: stop accepting/redialing AFTER the shutdown
            # handshakes above (they ride the live connections), then
            # reap the supervision threads.
            with self._lock:
                self._closing_accept = True
                redial_events = list(self._redial.values())
                self._lock.notify_all()
            for ev in redial_events:
                ev.set()
            with contextlib.suppress(OSError):
                self._lsock.close()
            if self._accept_thread is not None:
                self._accept_thread.join(timeout=5.0)
            for t in self._dial_threads:
                t.join(timeout=5.0)
        if self._own_hb_dir is not None:
            import shutil

            shutil.rmtree(self._own_hb_dir, ignore_errors=True)
        if self.telemetry:
            append_federation_report(self.option, self.stats, self.timer,
                                     self.telemetry)

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- observability harvesting ----------------------------------------
    def metrics_snapshot(self) -> Optional[Dict[str, Any]]:
        """Fleet-wide merged metrics snapshot, or None when the plane
        is off (`MEGBA_METRICS` unset everywhere).

        Pulls each live worker's registry snapshot over the RPC channel
        (a new lockstep `metrics` op, serialized against the serve
        thread by the handle's request lock) and merges it with the
        router's own — counters/histograms sum, gauges too (depth-style
        gauges are per-process, so the sum reads as fleet totals).  The
        merge iterates sorted names and sorted label keys, so repeated
        pulls on an idle fleet are bitwise identical — the stable seam
        a self-tuning router can diff between policy
        adjustments.  Workers that died, or stubs that do not speak the
        op, are skipped rather than failed: harvesting is forensic and
        must never take the fleet down.
        """
        snaps: List[Dict[str, Any]] = []
        registry = _obs.metrics_registry()
        if registry is not None:
            snaps.append(registry.snapshot())
        # Liveness comes from the locked `_views` mirror, not the
        # handles' `alive` flags: a serve thread declaring a loss writes
        # the flag concurrently with this pull, and the router lock is
        # the only ordering the two threads share (guarded-by contract).
        # A disconnected (reconnect-window) worker is skipped too: a
        # metrics pull over a dead link would burn the 60s budget.
        with self._lock:
            live = [w for w in self.workers.values()
                    if self._views[w.worker_id].alive
                    and self._views[w.worker_id].connected]
        for w in live:
            try:
                reply = w.request({"op": "metrics"}, timeout_s=60.0)
            except Exception:
                continue  # lost mid-pull or stub without the op
            if isinstance(reply, dict) and reply.get("ok") \
                    and reply.get("metrics") is not None:
                snaps.append(reply["metrics"])
        if not snaps:
            return None
        from megba_tpu_torch.observability import metrics as _metrics

        return _metrics.merge_snapshots(snaps)

    # -- dispatch --------------------------------------------------------
    @staticmethod
    def _resolve(future: Future, result=None, exc=None) -> None:
        try:
            if future.cancelled():
                return
            if exc is not None:
                future.set_exception(exc)
            else:
                future.set_result(result)
        except InvalidStateError:
            pass

    def _shed_expired_locked(self, now: float) -> List[_Routed]:
        if self._ndeadline <= 0:
            return []
        shed: List[_Routed] = []
        removed = 0
        for key in list(self._pending):
            items = self._pending[key]
            keep: List[_Routed] = []
            for it in items:  # one O(n) partition pass per bucket
                if it.future.cancelled():
                    removed += 1
                    if it.deadline is not None:
                        self._ndeadline -= 1
                elif it.deadline is not None and now >= it.deadline:
                    removed += 1
                    self._ndeadline -= 1
                    shed.append(it)
                else:
                    keep.append(it)
            if len(keep) != len(items):
                if keep:
                    self._pending[key] = keep
                else:
                    del self._pending[key]
        if removed:
            self._npending = sum(len(v) for v in self._pending.values())
        return shed

    @staticmethod
    def _ready(items: List[_Routed], now: float) -> List[_Routed]:
        # Escalated items park behind a `not_before` backoff gate; they
        # stay pending (flush-visible) but undispatchable until due.
        return [it for it in items
                if it.not_before is None or it.not_before <= now]

    def _depths_locked(self, now: float) -> Dict[str, int]:
        depths: Dict[str, int] = {}
        for (sc, _dims), items in self._pending.items():
            n = len(self._ready(items, now))
            if n:
                depths[str(sc)] = depths.get(str(sc), 0) + n
        return depths

    def _pick_locked(self, wid: str, now: float) -> Tuple[
            Optional[List[_Routed]], bool, bool]:
        """(batch, stolen, cold) for worker `wid`, or (None, False,
        False).  `cold` flags a dispatch whose bucket has no artifact
        on the target worker — a compile-on-dispatch latency cliff the
        coverage-gap satellite surfaces."""
        view = self._views[wid]
        if not view.connected:
            # Reconnect window: this worker keeps its assignment but
            # takes no new work; route() detours its buckets meanwhile.
            return None, False, False
        # 1) buckets homed here (or routable/detoured here), oldest first
        candidates = []
        for key, items in self._pending.items():
            ready = self._ready(items, now)
            if not ready:
                continue
            bucket = str(key[0])
            # route() (not the raw assignment) so a disconnected home's
            # buckets detour to warm connected peers for the window.
            homed = self._table.route(bucket, self._views)
            if homed == wid:
                candidates.append((min(it.enqueued for it in ready),
                                   key))
        if candidates:
            # Tiebreak on the bucket string: submit_many stamps a whole
            # fleet with ONE enqueue time, and (ShapeClass, dims) keys
            # do not order.
            _, key = min(candidates, key=lambda c: (c[0], str(c[1][0]),
                                                    c[1][1]))
            cold = str(key[0]) not in view.warm
            return self._take_locked(key, view, now), False, cold
        # 2) steal: deepest warm backlog homed on a live peer
        if self.steal:
            bucket = self._table.steal_candidate(
                wid, self._views, self._depths_locked(now))
            if bucket is not None:
                for key, items in self._pending.items():
                    if str(key[0]) == bucket and self._ready(items, now):
                        # Stealing requires warmth, so never cold.
                        return (self._take_locked(key, view, now),
                                True, False)
        return None, False, False

    def _take_locked(self, key: Tuple, view: WorkerView,
                     now: float) -> List[_Routed]:
        items = self._pending[key]
        take = self._ready(items, now)[:self.max_batch]
        taken = set(map(id, take))
        rest = [it for it in items if id(it) not in taken]
        if rest:
            self._pending[key] = rest
        else:
            del self._pending[key]
        self._npending -= len(take)
        self._ndeadline -= sum(
            1 for it in take if it.deadline is not None)
        view.routed += len(take)
        return take

    def _serve(self, worker) -> None:
        wid = worker.worker_id
        while True:
            batch: Optional[List[_Routed]] = None
            stolen = False
            cold = False
            shed_out: Optional[List[_Routed]] = None
            with self._lock:
                while True:
                    if not self._views[wid].alive:
                        return
                    now = time.monotonic()
                    shed = self._shed_expired_locked(now)
                    if shed:
                        # Shed futures resolve OUTSIDE the lock (a
                        # done-callback re-entering the router must not
                        # self-deadlock on the non-reentrant Condition);
                        # they count as in-flight until resolved so
                        # flush() cannot observe "drained" early — the
                        # FleetQueue shed discipline.
                        self._inflight += len(shed)
                        shed_out = shed
                        break
                    batch, stolen, cold = self._pick_locked(wid, now)
                    if batch is not None:
                        break
                    if (self._closing and self._npending == 0
                            and self._inflight == 0):
                        return
                    # Wake on submit/reroute/close; the timed slice also
                    # re-checks deadlines so sheds stay prompt.
                    self._lock.wait(timeout=0.05)
                if batch is not None:
                    self._inflight += len(batch)
            if shed_out is not None:
                self.stats.record_shed(len(shed_out))
                self.timer.count_event("federation_shed", len(shed_out))
                for it in shed_out:
                    self._resolve(it.future, exc=DeadlineExceeded(
                        f"problem {it.problem.name!r} shed before "
                        "dispatch (deadline expired)"))
                with self._lock:
                    self._inflight -= len(shed_out)
                    self._lock.notify_all()
                continue
            if cold:
                # Coverage-gap satellite: a dispatch whose (bucket,
                # lanes, rung) has no artifact on the target is a
                # compile-on-dispatch — count it every time, warn ONCE
                # per missing key so lane-rung holes surface without
                # spamming a hot path.
                self.stats.record_cold_dispatch(len(batch))
                self.timer.count_event("fed_cold_dispatch", len(batch))
                registry = _obs.metrics_registry()
                if registry is not None:
                    registry.counter(
                        "megba_fed_cold_dispatch_total",
                        "Dispatches with no artifact on the target "
                        "worker (compile-on-dispatch)").inc(
                            len(batch), bucket=batch[0].bucket,
                            worker=wid)
                lanes = len(batch)
                warn_key = (batch[0].bucket, lanes, 0)
                first = False
                with self._lock:
                    if warn_key not in self._cold_warned:
                        self._cold_warned.add(warn_key)
                        first = True
                if first:
                    warnings.warn(ColdDispatchWarning(
                        f"cold dispatch: no artifact for bucket="
                        f"{batch[0].bucket!r} lanes={lanes} rung=0 on "
                        f"worker {wid!r} — this batch compiles on "
                        "dispatch (export artifacts for this key to "
                        "remove the latency cliff)"), stacklevel=2)
            try:
                try:
                    msg: Dict[str, Any] = {
                        "op": "solve",
                        "problems": [it.problem for it in batch]}
                    recorder = _obs.span_recorder()
                    scope = (contextlib.nullcontext()
                             if recorder is None else recorder.span(
                                 "fed_dispatch", bucket=batch[0].bucket,
                                 worker=wid, problems=len(batch),
                                 stolen=stolen))
                    with scope:
                        if recorder is not None:
                            msg["trace"] = recorder.context()
                        reply = worker.request(
                            msg, timeout_s=self.watchdog_s)
                    if recorder is not None and reply.get("spans"):
                        recorder.ingest(reply["spans"])
                except (WorkerLostError, TimeoutError) as exc:
                    if isinstance(exc, TimeoutError):
                        exc = WorkerLostError(
                            wid, "solve exceeded the "
                            f"{self.watchdog_s:.0f}s watchdog budget")
                    self._on_worker_lost(worker, batch, exc)
                    return
                now = time.monotonic()
                if reply.get("ok") and len(reply.get("results", ())) != len(
                        batch):
                    # A short/long ok-reply must fail the batch TYPED —
                    # zip truncation would strand the tail futures
                    # unresolved past flush() forever ("never silently").
                    reply = {"ok": False, "error": (
                        f"worker returned {len(reply.get('results', ()))} "
                        f"results for a {len(batch)}-problem batch")}
                if reply.get("ok"):
                    results = reply["results"]
                    worker.warm = set(reply.get("warm", worker.warm))
                    with self._lock:
                        self._views[wid].warm = set(worker.warm)
                    if reply.get("first_solve") is not None:
                        self.stats.record_first_solve(
                            wid, reply["first_solve"])
                    self.stats.record_batch(wid, len(batch), stolen)
                    registry = _obs.metrics_registry()
                    if registry is not None:
                        registry.counter(
                            "megba_fed_dispatch_total",
                            "Problems dispatched per shape-class bucket "
                            "and worker").inc(
                                len(batch), bucket=batch[0].bucket,
                                worker=wid)
                        if stolen:
                            registry.counter(
                                "megba_fed_steal_total",
                                "Problems moved by work-stealing").inc(
                                    len(batch), bucket=batch[0].bucket,
                                    worker=wid)
                    if stolen:
                        self.timer.count_event("federation_steal")
                        self.timer.count_event(
                            "federation_stolen_problems", len(batch))
                    for it, fr in zip(batch, results):
                        fr.latency_s = now - it.enqueued
                        if (it.deadline is not None
                                and now >= it.deadline):
                            # The FleetQueue contract: a late result is
                            # DELIVERED, flagged, counted — never
                            # silently on time.
                            fr.deadline_missed = True
                            self.stats.record_deadline_miss()
                            self.timer.count_event(
                                "federation_deadline_miss")
                        self._resolve(it.future, result=fr)
                else:
                    err = RuntimeError(
                        f"worker {wid} solve failed: "
                        f"{reply.get('error')}")
                    for it in batch:
                        self._resolve(it.future, exc=err)
            except Exception as exc:  # never die silently mid-batch
                # A router-side bug must fail THIS batch typed and keep
                # the thread serving — a dead serve thread would wedge
                # flush() forever (the FleetQueue dispatcher contract).
                for it in batch:
                    self._resolve(it.future, exc=exc)
            finally:
                with self._lock:
                    self._inflight -= len(batch)
                    self._lock.notify_all()

    def _on_worker_lost(self, worker, batch: List[_Routed],
                        exc: WorkerLostError) -> None:
        """Typed loss handling: count it, reroute the in-flight batch
        (bounded), re-home the dead worker's buckets, keep serving."""
        wid = worker.worker_id
        worker.alive = False
        worker.terminate()
        self.stats.record_worker_lost(wid)
        self.timer.count_event("federation_worker_lost")
        registry = _obs.metrics_registry()
        if registry is not None:
            registry.counter("megba_fed_worker_lost_total",
                             "Federation workers lost").inc(worker=wid)
        flight = _obs.flight_recorder()
        if flight is not None:
            # The router-side crash record for deaths the worker could
            # not announce (SIGKILL, OOM): what died, why, and what it
            # had in flight — then dump the ring, because the fleet may
            # be about to fail outright if this was the last survivor.
            flight.record(
                "worker_lost", worker=wid, reason=exc.reason,
                inflight=len(batch),
                buckets=sorted({it.bucket for it in batch})[:8])
        # Failures are COLLECTED under the lock and resolved outside it:
        # a future's done-callback may re-enter the router, and the
        # Condition's lock is not reentrant.  The failed items count as
        # in-flight until resolved (the caller's finally decrements the
        # batch; _inflight covers it throughout).
        to_fail: List[Tuple[Future, WorkerLostError]] = []
        escalated = 0
        with self._lock:
            self._views[wid].alive = False
            self._table.reassign_lost(wid, self._views)
            survivors = any(v.alive for v in self._views.values())
            rerouted = 0
            for it in batch:
                it.reroutes += 1
                if not survivors:
                    to_fail.append((it.future, WorkerLostError(
                        wid, f"{exc.reason}; no surviving workers")))
                elif it.reroutes > self.max_reroutes:
                    if (self.escalation is not None
                            and self.escalation.retry_dispatch_errors
                            and not it.escalated):
                        # Router-level escalation: consult
                        # the EscalationPolicy ladder ONCE before
                        # failing typed — one extra retry behind the
                        # policy's deterministic seeded backoff.  The
                        # same-clock rule applies: `not_before` joins
                        # enqueued/deadline on time.monotonic(), never
                        # the handle-side monotonic_s() epoch.
                        it.escalated = True
                        it.not_before = (
                            time.monotonic()
                            + self.escalation.backoff_s(it.seq,
                                                        it.reroutes))
                        self._pending.setdefault(it.key, []).append(it)
                        self._npending += 1
                        if it.deadline is not None:
                            self._ndeadline += 1
                        escalated += 1
                        continue
                    self.stats.record_reroute_failure()
                    to_fail.append((it.future, WorkerLostError(
                        wid, f"{exc.reason}; rerouted {it.reroutes - 1} "
                        f"times (max_reroutes={self.max_reroutes}, "
                        "escalation "
                        + ("consumed" if it.escalated else "off")
                        + ")")))
                else:
                    self._pending.setdefault(it.key, []).append(it)
                    self._npending += 1
                    if it.deadline is not None:
                        self._ndeadline += 1
                    rerouted += 1
            if rerouted:
                self.stats.record_reroute(rerouted)
                self.timer.count_event("federation_reroute", rerouted)
                if registry is not None:
                    for it in batch:
                        if it.reroutes <= self.max_reroutes:
                            registry.counter(
                                "megba_fed_reroute_total",
                                "Problems rerouted off lost workers"
                            ).inc(bucket=it.bucket)
                if flight is not None:
                    flight.record("reroute", worker=wid, n=rerouted)
            if escalated:
                self.stats.record_escalation(escalated)
                self.timer.count_event("fed_escalation", escalated)
                if registry is not None:
                    registry.counter(
                        "megba_fed_escalation_total",
                        "Problems retried via the escalation ladder "
                        "after reroute exhaustion").inc(
                            escalated, worker=wid)
                if flight is not None:
                    flight.record("escalation", worker=wid, n=escalated)
            if not survivors:
                # Nothing can serve the queue: fail it all, typed.
                for key in list(self._pending):
                    for it in self._pending.pop(key):
                        to_fail.append((it.future, WorkerLostError(
                            wid, f"{exc.reason}; no surviving workers")))
                self._npending = 0
                self._ndeadline = 0
            # in-flight accounting: the serve loop's finally owns the
            # decrement (this handler runs inside its try)
            self._lock.notify_all()
        for future, err in to_fail:
            self._resolve(future, exc=err)
        with self._lock:
            self._lock.notify_all()  # flush waiters re-check after fails
        if flight is not None:
            from megba_tpu_torch.observability import flight as _flight

            _flight.dump_default(f"worker_lost:{wid}")


def append_federation_report(option, stats: FederationStats, timer,
                             path: str) -> None:
    """One router-lifetime SolveReport line carrying the federation
    block — what `summarize --aggregate`'s federation view renders."""
    from megba_tpu_torch.observability.report import (
        SolveReport,
        append_report,
        backend_topology,
        config_to_dict,
    )

    rep = SolveReport(
        problem={"kind": "federation_router"},
        config=config_to_dict(option),
        backend=backend_topology(),
        phases=timer.as_dict(),
        result={},
        federation=stats.as_dict(),
        created_unix=wall_unix(),
    )
    append_report(rep, path)


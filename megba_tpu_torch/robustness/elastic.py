"""Elastic multi-process solves: liveness, bounded dispatches, shrink-world.

Counterpart of `megba_tpu/robustness/elastic.py`.  The sharded solve's
sums assume every process survives the whole solve (MegBA ran one
process).  A lost rank turns each survivor's next gather into a
transport error (gloo reports a SIGKILLed peer as a closed connection
within milliseconds) or, for a peer that hangs, a block until the
process group's timeout.  This module is the failure contract of the
multi-process path, four pieces:

- **HeartbeatBoard**: per-rank heartbeat files under a shared
  directory.  Each rank's beat is a counter written atomically; the
  monitor classifies peers ALIVE / STRAGGLER / DEAD by how long its own
  clock has gone without seeing the counter change, so clocks are never
  compared across processes.  The federation tier's pipe workers beat
  it too (serving/federation.py).
- **CollectiveWatchdog**: a deadline around each guarded dispatch, so a
  hung but beating peer surfaces as a typed `CollectiveTimeout` within
  the budget instead of a block.
- **ElasticMonitor**: the rank's runtime: beats on a daemon thread,
  guards each chunk dispatch (a worker thread, polled for peer liveness
  first and the deadline second), classifies dispatch errors (a gloo
  transport error while a peer has just died is a `WorkerLost`), and
  keeps the counters `SolveReport.elastic` carries.
- **resume_elastic**: the shrink-world path: tear down the process group
  (`parallel.multihost.shutdown_multihost`, abandoning the dead peers),
  re-lower the same problem at the surviving world on this process's
  devices (`parallel.mesh.local_devices_only`) and continue the chunked
  solve from the latest schema-v3 snapshot.

Detection is host-side only: it adds no collective and no launch to a
solve.  Aborts happen at chunk boundaries by construction: a chunk whose
dispatch dies is never snapshotted, so the previous chunk's checksummed
snapshot is the recovery line.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import tempfile
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from megba_tpu_torch.utils.timing import PhaseTimer


class ElasticError(RuntimeError):
    """Base of the elastic-distribution failure taxonomy."""


class WorkerLost(ElasticError):
    """One or more peer ranks stopped beating past the death threshold.

    `ranks` are the lost peers; `detected_after_s` is the staleness of
    the deadest peer at declaration (time since its last observed beat,
    on the DETECTING rank's clock) — the time-to-detection the harness
    asserts against the watchdog budget; `label` names the dispatch (or
    liveness check) that surfaced the loss.
    """

    def __init__(self, ranks: Sequence[int], label: str = "",
                 detected_after_s: float = 0.0) -> None:
        self.ranks = tuple(sorted(int(r) for r in ranks))
        self.label = label
        self.detected_after_s = float(detected_after_s)
        super().__init__(
            f"worker rank(s) {list(self.ranks)} lost "
            f"(no heartbeat for {self.detected_after_s:.3f}s)"
            + (f" during {label!r}" if label else ""))


class CollectiveTimeout(ElasticError):
    """A guarded dispatch exceeded its watchdog budget with every peer
    still beating — a wedged (hung/straggling) collective, not a death.
    """

    def __init__(self, label: str, budget_s: float, elapsed_s: float) -> None:
        self.label = label
        self.budget_s = float(budget_s)
        self.elapsed_s = float(elapsed_s)
        super().__init__(
            f"dispatch {label!r} exceeded its {self.budget_s:.3f}s "
            f"watchdog budget (elapsed {self.elapsed_s:.3f}s) with all "
            "peers still beating")


class RankState(enum.Enum):
    UNKNOWN = 0  # never observed a beat, still inside the join grace
    ALIVE = 1  # beat observed within straggler_after_s
    STRAGGLER = 2  # stale past straggler_after_s but not yet declared dead
    DEAD = 3  # stale past dead_after_s (or never joined within it)


class HeartbeatBoard:
    """Per-rank heartbeat files under a rendezvous directory.

    `beat()` atomically replaces this rank's file with an incremented
    counter.  `observe()` classifies every PEER by the time since its
    counter last CHANGED, measured on this process's own (injectable)
    clock — immune to cross-host clock skew, and deterministic under an
    injected clock for tests.  A rank that has never beaten is UNKNOWN
    until the join grace (`dead_after_s` from the first observation)
    expires, then DEAD: a worker that never came up is as lost as one
    that died.
    """

    def __init__(self, directory: str, rank: int, world: int, *,
                 straggler_after_s: float = 1.0, dead_after_s: float = 3.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside world {world}")
        if not 0 < straggler_after_s <= dead_after_s:
            raise ValueError(
                f"need 0 < straggler_after_s <= dead_after_s, got "
                f"{straggler_after_s} / {dead_after_s}")
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.rank = int(rank)
        self.world = int(world)
        self.straggler_after_s = float(straggler_after_s)
        self.dead_after_s = float(dead_after_s)
        self._clock = clock
        # Thread-confined, not locked: `_counter` belongs to whichever
        # single thread drives beat() (the monitor's beater thread —
        # start()'s one pre-spawn beat orders-before via Thread.start),
        # and the observation maps belong to the observing thread
        # (ElasticMonitor's guard poll loop).  Cross-thread publication
        # happens through the filesystem (atomic replace), never these.
        self._counter = 0
        self._last_value: Dict[int, int] = {}
        self._last_change: Dict[int, float] = {}

    def path_for(self, rank: int) -> str:
        return os.path.join(self.directory, f"rank{int(rank)}.hb")

    def beat(self) -> int:
        """Publish one heartbeat (atomic replace: a concurrent reader
        sees the old beat or the new one, never a torn file)."""
        self._counter += 1
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                fh.write(f"{self._counter} {os.getpid()}\n")
            os.replace(tmp, self.path_for(self.rank))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return self._counter

    def _read_counter(self, rank: int) -> Optional[int]:
        try:
            with open(self.path_for(rank)) as fh:
                return int(fh.read().split()[0])
        except (OSError, ValueError, IndexError):
            return None  # missing or torn-by-external-tooling: no beat

    def observe(self, now: Optional[float] = None) -> Dict[int, RankState]:
        """Classify every peer rank (self excluded) at `now`."""
        now = self._clock() if now is None else now
        out: Dict[int, RankState] = {}
        for r in range(self.world):
            if r == self.rank:
                continue
            value = self._read_counter(r)
            seen_before = r in self._last_value
            if value is not None and (
                    not seen_before or value != self._last_value[r]):
                self._last_value[r] = value
                self._last_change[r] = now
            if r not in self._last_change:
                # First-ever observation of a silent rank: anchor the
                # join grace here, not at process start.
                self._last_change[r] = now
            stale = now - self._last_change[r]
            if stale >= self.dead_after_s:
                out[r] = RankState.DEAD
            elif r not in self._last_value:
                out[r] = RankState.UNKNOWN
            elif stale >= self.straggler_after_s:
                out[r] = RankState.STRAGGLER
            else:
                out[r] = RankState.ALIVE
        return out

    def staleness(self, rank: int, now: Optional[float] = None) -> float:
        """Seconds since `rank`'s beat counter last changed (inf if it
        was never observed at all)."""
        now = self._clock() if now is None else now
        anchor = self._last_change.get(int(rank))
        return float("inf") if anchor is None else now - anchor

    def dead_ranks(self, now: Optional[float] = None) -> List[int]:
        return [r for r, s in self.observe(now).items()
                if s is RankState.DEAD]


@dataclasses.dataclass
class _Armed:
    token: int
    label: str
    armed_at: float
    budget_s: float


class CollectiveWatchdog:
    """Deadline bookkeeping for in-flight guarded dispatches.

    Pure injected-clock state machine: `arm` registers a dispatch with
    a budget, `check`/`expired` compare against the clock, `disarm`
    retires it and returns the elapsed time.  `ElasticMonitor.guard`
    drives it from the poll loop; tests drive it with explicit `now=`
    values (arming/disarming across dispatches, timeout payloads).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._armed: Dict[int, _Armed] = {}  # megba: guarded-by(_lock)
        self._next_token = 0  # megba: guarded-by(_lock)
        self.timeouts = 0  # megba: guarded-by(_lock); deadlines fired

    def arm(self, label: str, budget_s: float,
            now: Optional[float] = None) -> int:
        if budget_s <= 0:
            raise ValueError(f"budget_s must be > 0, got {budget_s}")
        now = self._clock() if now is None else now
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._armed[token] = _Armed(token, label, now, float(budget_s))
        return token

    def disarm(self, token: int, now: Optional[float] = None) -> float:
        now = self._clock() if now is None else now
        with self._lock:
            armed = self._armed.pop(token, None)
        if armed is None:
            raise ValueError(f"token {token} is not armed")
        return now - armed.armed_at

    def armed_count(self) -> int:
        with self._lock:
            return len(self._armed)

    def expired(self, now: Optional[float] = None) -> List[Tuple[int, str, float]]:
        """[(token, label, elapsed_s)] for every armed dispatch past its
        budget at `now` — inspection only, no state change."""
        now = self._clock() if now is None else now
        with self._lock:
            return [(a.token, a.label, now - a.armed_at)
                    for a in self._armed.values()
                    if now - a.armed_at > a.budget_s]

    def check(self, token: int, now: Optional[float] = None) -> float:
        """Elapsed seconds for `token`; raises `CollectiveTimeout` (and
        counts it) once past the budget.  The token stays armed so the
        caller's cleanup path still owns the disarm."""
        now = self._clock() if now is None else now
        with self._lock:
            armed = self._armed.get(token)
            if armed is None:
                raise ValueError(f"token {token} is not armed")
            elapsed = now - armed.armed_at
            if elapsed > armed.budget_s:
                self.timeouts += 1
                raise CollectiveTimeout(armed.label, armed.budget_s, elapsed)
        return elapsed


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Tuning for one rank's elastic monitor.

    `heartbeat_dir` must be shared by every rank (same host: any tmp
    dir; several hosts: a shared filesystem).  `watchdog_s` bounds each
    steady-state dispatch; the FIRST guarded dispatch of each kind (per
    `guard(grace_key=...)`, re-granted after a reshard) gets
    `compile_grace_s` on top, for its one-time work (plans, a kernel
    library's first load).  Liveness is the fast detector either way: a
    dead peer surfaces within ~`dead_after_s` + `poll_s` even while a
    long first dispatch is in flight.
    """

    heartbeat_dir: str
    rank: int = 0
    world: int = 1
    interval_s: float = 0.25
    straggler_after_s: float = 1.0
    dead_after_s: float = 3.0
    watchdog_s: float = 60.0
    compile_grace_s: float = 600.0
    poll_s: float = 0.05

    def __post_init__(self) -> None:
        if self.world < 1:
            raise ValueError(f"world must be >= 1, got {self.world}")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside world {self.world}")
        if self.interval_s <= 0 or self.poll_s <= 0:
            raise ValueError("interval_s and poll_s must be > 0")
        if not 0 < self.straggler_after_s <= self.dead_after_s:
            raise ValueError(
                "need 0 < straggler_after_s <= dead_after_s")
        if self.watchdog_s <= 0 or self.compile_grace_s < 0:
            raise ValueError(
                "watchdog_s must be > 0 and compile_grace_s >= 0")


class ElasticMonitor:
    """One rank's liveness + watchdog runtime, and its elastic ledger.

    Owns the heartbeat thread, the guarded-dispatch driver, and the
    counters that become `SolveReport.elastic`.  Every transition also
    lands as a zero-duration PhaseTimer event on `self.timer`
    (`elastic_worker_lost`, `elastic_collective_timeout`,
    `elastic_reshard`, `elastic_resume`) so phase breakdowns and the
    elastic block tell one story.
    """

    def __init__(self, config: ElasticConfig,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.config = config
        self.board = HeartbeatBoard(
            config.heartbeat_dir, config.rank, config.world,
            straggler_after_s=config.straggler_after_s,
            dead_after_s=config.dead_after_s, clock=clock)
        self.watchdog = CollectiveWatchdog(clock=clock)
        self.timer = PhaseTimer()
        self.monitor_id = uuid.uuid4().hex[:12]
        self._clock = clock
        self.workers_lost = 0
        self.collective_timeouts = 0
        self.reshards = 0
        self.resumes = 0
        self.detection_s: List[float] = []
        self._lost_ranks: set = set()
        self._peers_retired = config.world <= 1
        self._graced_keys: set = set()
        self._reshard_worlds: Optional[Tuple[int, int]] = None
        self._beater: Optional[threading.Thread] = None
        self._stop_beating = threading.Event()

    # -- lifecycle -------------------------------------------------------
    @classmethod
    def ensure(cls, elastic) -> Tuple[Optional["ElasticMonitor"], bool]:
        """Normalize a driver's `elastic=` argument.

        None -> (None, False); an `ElasticConfig` -> a fresh STARTED
        monitor the caller now owns (owned=True: the driver must stop
        it); an already-built monitor -> started if needed, not owned.
        """
        if elastic is None:
            return None, False
        if isinstance(elastic, ElasticMonitor):
            elastic.start()
            return elastic, False
        if isinstance(elastic, ElasticConfig):
            monitor = cls(elastic)
            monitor.start()
            return monitor, True
        raise TypeError(
            f"elastic must be an ElasticConfig or ElasticMonitor, got "
            f"{type(elastic).__name__}")

    def start(self) -> None:
        """Beat once now and keep beating on a daemon thread
        (idempotent).  The immediate beat matters: peers' join grace is
        anchored at their first observation, and a rank that only beat
        lazily would burn into it."""
        if self._beater is not None and self._beater.is_alive():
            return
        self.board.beat()
        self._stop_beating.clear()

        def _beat_loop():
            while not self._stop_beating.wait(self.config.interval_s):
                try:
                    self.board.beat()
                except OSError:
                    # A torn rendezvous dir must not kill the beater;
                    # peers will classify us from the last good beat.
                    pass

        self._beater = threading.Thread(
            target=_beat_loop, daemon=True,
            name=f"elastic-beat-r{self.config.rank}")
        self._beater.start()

    def stop(self) -> None:
        self._stop_beating.set()
        if self._beater is not None:
            self._beater.join(timeout=2.0)
            self._beater = None

    def __enter__(self) -> "ElasticMonitor":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- liveness --------------------------------------------------------
    def check_peers(self, now: Optional[float] = None,
                    label: str = "liveness") -> None:
        """Raise `WorkerLost` if any peer is DEAD (no-op once the world
        has been resharded past them, or for a world of one)."""
        if self._peers_retired:
            return
        states = self.board.observe(now)
        dead = [r for r, s in states.items() if s is RankState.DEAD]
        if dead:
            raise self._declare_lost(dead, label, now)

    def _declare_lost(self, ranks: Sequence[int], label: str,
                      now: Optional[float] = None) -> WorkerLost:
        staleness = max(self.board.staleness(r, now) for r in ranks)
        fresh = [r for r in ranks if r not in self._lost_ranks]
        if fresh:
            self._lost_ranks.update(fresh)
            self.workers_lost += len(fresh)
            self.timer.count_event("elastic_worker_lost", len(fresh))
            self.detection_s.extend(
                self.board.staleness(r, now) for r in fresh)
        return WorkerLost(ranks, label=label, detected_after_s=staleness)

    # -- guarded dispatch ------------------------------------------------
    def guard(self, label: str, fn: Callable, *args,
              grace_key=None, **kwargs):
        """Run one dispatch bounded by liveness + the watchdog.

        `fn` runs on a dedicated worker thread; this thread polls the
        heartbeat board (dead peer -> `WorkerLost`, the fast path) and
        the armed deadline (-> `CollectiveTimeout`).  On either, the
        worker thread is abandoned — it is parked inside a collective
        whose peers will never answer; it is a daemon thread whose
        eventual transport error is swallowed — and the CALLER gets
        control back within the budget: the no-wedge contract.  A
        dispatch exception with a freshly-dead peer is classified as
        `WorkerLost` (gloo surfaces peer death as a transport error
        faster than the death threshold elapses).

        `grace_key` identifies the kind of dispatch (the chunked driver
        passes the chunk's iteration count): the FIRST guard per key
        gets `compile_grace_s` on top of the budget, because a first
        dispatch carries one-time work (the plans of a new mesh, a
        kernel library's first load) that must not read as a wedged
        collective.  A reshard clears the granted set (the shrunk mesh
        re-plans).
        """
        key = ("__default__",) if grace_key is None else grace_key
        grace = 0.0
        if key not in self._graced_keys:
            self._graced_keys.add(key)
            grace = self.config.compile_grace_s
        budget = self.config.watchdog_s + grace
        token = self.watchdog.arm(label, budget)
        box: dict = {}
        finished = threading.Event()

        def _run():
            try:
                box["value"] = fn(*args, **kwargs)
            except BaseException as exc:  # delivered to the caller below
                box["error"] = exc
            finally:
                finished.set()

        worker = threading.Thread(
            target=_run, daemon=True, name=f"elastic-dispatch-{label}")
        worker.start()
        try:
            while not finished.wait(self.config.poll_s):
                self.check_peers(label=label)
                self.watchdog.check(token)
        except WorkerLost:
            self.watchdog.disarm(token)
            raise
        except CollectiveTimeout:
            self.collective_timeouts += 1
            self.timer.count_event("elastic_collective_timeout")
            self.watchdog.disarm(token)
            raise
        self.watchdog.disarm(token)
        if "error" in box:
            raise self._classify(box["error"], label)
        return box["value"]

    def _classify(self, error: BaseException, label: str) -> BaseException:
        """A dispatch exception while a peer just died IS the loss.

        gloo reports a SIGKILL'd peer as a TCP reset within
        milliseconds — before the heartbeat threshold can elapse — so
        wait up to one death window for the silence to become official
        before deciding the error was the peer's death rather than a
        genuine program failure.  The wait is bounded on the REAL clock
        (it sleeps real time): with an injected frozen clock the loop
        would otherwise never reach its deadline.
        """
        if self._peers_retired:
            return error
        deadline = time.monotonic() + self.config.dead_after_s \
            + 3 * self.config.poll_s
        while True:
            dead = self.board.dead_ranks()
            if dead:
                lost = self._declare_lost(dead, label)
                lost.__cause__ = error
                return lost
            if time.monotonic() >= deadline:
                return error
            time.sleep(self.config.poll_s)

    # -- reshard / resume ledger ----------------------------------------
    def record_reshard(self, old_world: int, new_world: int) -> None:
        """The world is being re-lowered at `new_world`: retire ALL
        peers and re-grant the first-dispatch grace (the shrunk mesh
        re-plans).  Retiring every peer is correct
        for the supported topology — `resume_elastic` always continues
        on THIS process's local devices after the process group is torn
        down, so no cross-process peers remain; a multi-process regroup
        would initialise a fresh group (and a fresh monitor) through
        `initialize_multihost` instead.
        Idempotent per (old, new) transition — `resume_elastic` records
        it AND the chunked driver re-detects it from the snapshot's
        world header; one transition must count once.
        """
        pair = (int(old_world), int(new_world))
        self._peers_retired = True
        self._graced_keys.clear()
        if self._reshard_worlds == pair:
            return
        self._reshard_worlds = pair
        self.reshards += 1
        self.timer.count_event("elastic_reshard")

    def record_resume(self) -> None:
        self.resumes += 1
        self.timer.count_event("elastic_resume")

    def report_block(self) -> Dict[str, object]:
        """The `SolveReport.elastic` payload: a snapshot of this
        monitor's cumulative counters.  `monitor` identifies the rank's
        monitor instance so an aggregator can take the LAST snapshot
        per monitor and sum ACROSS monitors without double counting."""
        return {
            "monitor": self.monitor_id,
            "rank": self.config.rank,
            "world": self.config.world,
            "workers_lost": self.workers_lost,
            "collective_timeouts": self.collective_timeouts,
            "reshards": self.reshards,
            "resumes": self.resumes,
            "detection_s": [round(float(s), 6) for s in self.detection_s],
        }


def _world_of(device) -> int:
    """The shards a shrink-world resume runs on this process: one per
    device of a sequence, else one per visible card (one on the CPU)."""
    if isinstance(device, (list, tuple)):
        return len(device)
    if device is not None:
        return 1
    import torch

    return max(1, torch.cuda.device_count()) if torch.cuda.is_available() \
        else 1


def resume_elastic(
    residual_jac_fn,
    cameras,
    points,
    obs,
    cam_idx,
    pt_idx,
    option,
    checkpoint_path: str,
    *,
    world_size: Optional[int] = None,
    monitor: Optional[ElasticMonitor] = None,
    checkpoint_every: int = 5,
    cooperative: bool = False,
    shutdown_timeout_s: float = 5.0,
    verbose: bool = False,
    **solve_kwargs,
):
    """Shrink-world resume: re-lower the SAME problem at the surviving
    world size and continue from the latest snapshot (JAX
    elastic.py:578-676).

    Tears down the process group (`shutdown_multihost`; by default
    `abandon=True`: peers are presumed dead, so no collective runs; pass
    `cooperative=True` for a planned reshard where every rank calls
    this), then re-runs `solve_checkpointed` with `option.world_size =
    world_size` (default: this process's devices, `device=` in
    `solve_kwargs`) under `parallel.mesh.local_devices_only()`: the
    shrunk mesh is built from devices THIS process owns, never a dead
    peer's.  A single `device` at a world over 1 puts every shard on it.
    The snapshot's schema-v3 world header turns the world mismatch into
    a warning and a reshard event, not a refusal.

    Parity contract: an interrupted world-W solve resumed at world W'
    matches the uninterrupted world-W run at rtol 1e-6 on final cost and
    parameters, with equal `SolveStatus` (the sums' order changes with
    the world, nothing else).

    A 2-D solve (SolverOption.mesh_2d) resumes onto a smaller 2-D mesh:
    the largest camera-block count the surviving world still factors
    (`parallel.mesh.nearest_cam_blocks`).
    """
    import dataclasses as _dc

    from megba_tpu_torch.algo.checkpointed import solve_checkpointed
    from megba_tpu_torch.parallel.mesh import (
        factor_mesh_2d,
        local_devices_only,
        nearest_cam_blocks,
    )
    from megba_tpu_torch.parallel.multihost import shutdown_multihost

    shutdown_multihost(abandon=not cooperative, timeout_s=shutdown_timeout_s)
    device = solve_kwargs.get("device")
    if world_size is None:
        world_size = _world_of(device)
    world_size = int(world_size)
    if world_size > 1 and not isinstance(device, (list, tuple)) \
            and device is not None:
        solve_kwargs["device"] = [device] * world_size
    old_world = option.world_size
    option = _dc.replace(option, world_size=world_size)
    if option.solver_option.mesh_2d:
        old_cb = option.solver_option.cam_blocks
        if old_cb <= 0:
            _, old_cb = factor_mesh_2d(max(old_world, 1), 0)
        option = _dc.replace(option, solver_option=_dc.replace(
            option.solver_option,
            cam_blocks=nearest_cam_blocks(world_size, old_cb)))
    if monitor is not None:
        monitor.record_reshard(old_world, world_size)
        monitor.record_resume()

    with local_devices_only():
        result = solve_checkpointed(
            residual_jac_fn, cameras, points, obs, cam_idx, pt_idx,
            option, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, verbose=verbose,
            elastic=monitor, **solve_kwargs)

    telemetry = option.telemetry or os.environ.get("MEGBA_TELEMETRY") or None
    if telemetry and monitor is not None:
        _append_elastic_report(monitor, result, telemetry)
    return result


def _append_elastic_report(monitor: ElasticMonitor, result,
                           telemetry: str) -> None:
    """One terminal JSONL line carrying the monitor's final elastic
    ledger (chunk lines carry interim snapshots; this one is the
    complete story, and `summarize --aggregate` keeps the last snapshot
    per monitor)."""
    from megba_tpu_torch.common import status_name
    from megba_tpu_torch.observability.report import (
        SolveReport,
        append_report,
        backend_topology,
    )
    from megba_tpu_torch.utils.timing import wall_unix

    status = getattr(result, "status", None)
    rep = SolveReport(
        problem={},
        config={},
        backend=backend_topology(result.cameras.device),
        phases=monitor.timer.as_dict(),
        result={
            "final_cost": float(result.cost),
            "iterations": int(result.iterations),
            "status": None if status is None else int(status),
            "status_name": (None if status is None
                            else status_name(status)),
        },
        elastic=monitor.report_block(),
        created_unix=wall_unix(),
    )
    append_report(rep, telemetry)

"""FleetStats: service-level counters for the many-problem solver.

Counterpart of `megba_tpu/serving/stats.py`: problems per second at
fixed convergence, how full the buckets run, how much padded work the
ladder wastes, whether the compile pool absorbs the one-time work, and
the resilience and triage counters.  One instance is shared by the
batcher, the compile pool and the dispatch queue; every mutation holds
its lock.  `as_dict()` is the JSON view embedded in telemetry reports
(the `fleet` block) and `report()` the human-readable one.

When the metrics plane is armed (`MEGBA_METRICS`), every `record_*` call
also lands in the process metrics registry (observability/metrics.py)
under the JAX package's series names and labels (`megba_pool_*`,
`megba_queue_*`, `megba_breaker_events_total`, `megba_triage_total`).
Off, the gate is one environment lookup and the metrics module is never
imported.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from megba_tpu_torch import observability as _obs


def _registry():
    return _obs.metrics_registry()


class FleetStats:
    """Aggregate fleet counters; thread-safe; cheap enough to always on."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.problems = 0  # megba: guarded-by(_lock); real problems solved (padding lanes excluded)
        self.batches = 0  # megba: guarded-by(_lock); batched dispatches
        self.solve_seconds = 0.0  # megba: guarded-by(_lock); wall clock inside batched dispatches
        self.lane_slots = 0  # megba: guarded-by(_lock); lanes dispatched, padding lanes included
        self.edge_slots = 0  # megba: guarded-by(_lock); lane-edge slots dispatched (lanes * bucket)
        self.edges_real = 0  # megba: guarded-by(_lock); raw (unpadded) edges across real problems
        self.pool_hits = 0  # megba: guarded-by(_lock); dispatches served by an already-built program
        self.pool_misses = 0  # megba: guarded-by(_lock); dispatches that had to build/compile
        # -- artifact store (serving/artifacts.py): the cold-start split —
        self.artifact_loads = 0  # megba: guarded-by(_lock); buckets warmed from serialized executables
        self.artifact_compiles = 0  # megba: guarded-by(_lock); buckets that paid a real compile
        self.per_bucket: Dict[str, Dict[str, int]] = {}  # megba: guarded-by(_lock)
        # -- resilience counters (serving/resilience.py mechanisms) ------
        self.sheds = 0  # megba: guarded-by(_lock); problems shed before dispatch (deadline expired)
        self.deadline_misses = 0  # megba: guarded-by(_lock); results delivered AFTER their deadline
        self.retries = 0  # megba: guarded-by(_lock); escalation re-enqueues (ladder rungs climbed)
        self.retries_by_rung: Dict[int, int] = {}  # megba: guarded-by(_lock); target rung -> count
        self.rejected = 0  # megba: guarded-by(_lock); submits refused by admission control
        self.breaker_trips = 0  # megba: guarded-by(_lock); bucket breakers opened
        self.breaker_probes = 0  # megba: guarded-by(_lock); half-open probe batches admitted
        self.breaker_recoveries = 0  # megba: guarded-by(_lock); probes that closed the breaker
        self.breaker_fast_fails = 0  # megba: guarded-by(_lock); submits failed fast on a tripped bucket
        self.queue_depth_peak = 0  # megba: guarded-by(_lock); max pending problems ever observed
        # -- pre-flight triage counters (robustness/triage.py) -----------
        self.triage_rejected = 0  # megba: guarded-by(_lock); problems refused with ZERO dispatch
        self.triage_repaired = 0  # megba: guarded-by(_lock); problems auto-repaired before enqueue
        self.triage_warned = 0  # megba: guarded-by(_lock); degenerate problems passed through flagged
        self.triage_points_fixed = 0  # megba: guarded-by(_lock); point blocks frozen by repairs
        self.triage_edges_masked = 0  # megba: guarded-by(_lock); edges soft-deleted by repairs
        self.triage_cams_anchored = 0  # megba: guarded-by(_lock); gauge anchors added by repairs
        self.triage_edges_downweighted = 0  # megba: guarded-by(_lock); robust-downweighted outliers

    # -- recording -------------------------------------------------------
    def record_batch(self, bucket: str, lanes: int, n_real: int,
                     edges_real: int, edge_bucket: int,
                     wall_s: float) -> None:
        with self._lock:
            self.problems += n_real
            self.batches += 1
            self.solve_seconds += wall_s
            self.lane_slots += lanes
            self.edge_slots += lanes * edge_bucket
            self.edges_real += edges_real
            b = self.per_bucket.setdefault(
                bucket, {"problems": 0, "batches": 0, "lane_slots": 0})
            b["problems"] += n_real
            b["batches"] += 1
            b["lane_slots"] += lanes

    def record_pool(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.pool_hits += 1
            else:
                self.pool_misses += 1
        reg = _registry()
        if reg is not None:
            reg.counter(
                "megba_pool_requests_total",
                "Compile-pool program requests by outcome").inc(
                    1, outcome="hit" if hit else "miss")

    def record_artifact(self, loaded: bool) -> None:
        """One bucket warmed: `loaded`=True rode a serialized executable
        (I/O-bound cold start), False paid a trace + XLA compile."""
        with self._lock:
            if loaded:
                self.artifact_loads += 1
            else:
                self.artifact_compiles += 1
        reg = _registry()
        if reg is not None:
            reg.counter(
                "megba_pool_warm_total",
                "Bucket warm-ups: artifact load vs real compile").inc(
                    1, outcome="artifact_load" if loaded else "compile")

    # -- resilience recording (called by FleetQueue under its own lock,
    # but kept self-locking so direct callers stay safe) ----------------
    def record_shed(self, n: int = 1) -> None:
        with self._lock:
            self.sheds += n
        reg = _registry()
        if reg is not None:
            reg.counter("megba_queue_shed_total",
                        "Problems shed before dispatch").inc(n)

    def record_deadline_miss(self, n: int = 1) -> None:
        with self._lock:
            self.deadline_misses += n
        reg = _registry()
        if reg is not None:
            reg.counter("megba_queue_deadline_misses_total",
                        "Results delivered after their deadline").inc(n)

    def record_retry(self, rung: int) -> None:
        """One problem re-enqueued at escalation rung `rung`."""
        with self._lock:
            self.retries += 1
            self.retries_by_rung[int(rung)] = (
                self.retries_by_rung.get(int(rung), 0) + 1)
        reg = _registry()
        if reg is not None:
            reg.counter("megba_queue_retries_total",
                        "Escalation re-enqueues by target rung").inc(
                            1, rung=int(rung))

    def record_reject(self, n: int = 1) -> None:
        with self._lock:
            self.rejected += n
        reg = _registry()
        if reg is not None:
            reg.counter("megba_queue_rejected_total",
                        "Submits refused by admission control").inc(n)

    def record_breaker(self, event: str) -> None:
        """One breaker transition: trip / probe / recover / fast_fail."""
        field = {"trip": "breaker_trips", "probe": "breaker_probes",
                 "recover": "breaker_recoveries",
                 "fast_fail": "breaker_fast_fails"}.get(event)
        if field is None:
            raise ValueError(f"unknown breaker event {event!r}")
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)
        reg = _registry()
        if reg is not None:
            reg.counter("megba_breaker_events_total",
                        "Circuit-breaker transitions by event").inc(
                            1, event=event)

    def record_depth(self, depth: int) -> None:
        with self._lock:
            if depth > self.queue_depth_peak:
                self.queue_depth_peak = depth
        reg = _registry()
        if reg is not None:
            reg.gauge("megba_queue_depth",
                      "Pending problems in the dispatch queue").set(depth)
            reg.gauge("megba_queue_depth_peak",
                      "High-water mark of pending problems").max(depth)

    def record_wait(self, bucket: str, wait_s: float) -> None:
        """Submit-to-dispatch wait of one problem (monotonic seconds).
        FleetStats keeps no wait state: this is the queue's bridge into
        the metrics histogram."""
        reg = _registry()
        if reg is not None:
            reg.histogram("megba_queue_wait_seconds",
                          "Submit-to-dispatch wait per problem").observe(
                              wait_s, bucket=bucket)

    def record_triage(self, action: str,
                      repair: Optional[Dict[str, int]] = None) -> None:
        """One triaged problem: `action` is 'rejected' / 'repaired' /
        'warned'; `repair` carries TriageRepair.counters() for repairs."""
        field = {"rejected": "triage_rejected",
                 "repaired": "triage_repaired",
                 "warned": "triage_warned"}.get(action)
        if field is None:
            raise ValueError(f"unknown triage action {action!r}")
        reg = _registry()
        if reg is not None:
            reg.counter("megba_triage_total",
                        "Triaged problems by action").inc(1, action=action)
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)
            if repair:
                self.triage_points_fixed += int(
                    repair.get("points_fixed", 0))
                self.triage_edges_masked += int(
                    repair.get("edges_masked", 0))
                self.triage_cams_anchored += int(
                    repair.get("cams_anchored", 0))
                self.triage_edges_downweighted += int(
                    repair.get("edges_downweighted", 0))

    # -- derived metrics -------------------------------------------------
    def problems_per_sec(self) -> float:
        with self._lock:
            if self.solve_seconds <= 0.0:
                return 0.0
            return self.problems / self.solve_seconds

    def padding_waste(self) -> float:
        """Fraction of dispatched lane-edge slots that carried no real
        edge — the price of the ladder's quantisation (padded edges AND
        whole padding lanes both count as waste)."""
        with self._lock:
            if self.edge_slots == 0:
                return 0.0
            return 1.0 - self.edges_real / self.edge_slots

    def occupancy(self) -> Dict[str, float]:
        """bucket -> mean real problems per dispatched lane slot."""
        with self._lock:
            return {
                k: (b["problems"] / b["lane_slots"] if b["lane_slots"] else 0.0)
                for k, b in self.per_bucket.items()
            }

    def pool_hit_rate(self) -> float:
        with self._lock:
            n = self.pool_hits + self.pool_misses
            return self.pool_hits / n if n else 0.0

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            base = {
                "problems": self.problems,
                "batches": self.batches,
                "solve_seconds": self.solve_seconds,
                "lane_slots": self.lane_slots,
                "edge_slots": self.edge_slots,
                "edges_real": self.edges_real,
                "pool_hits": self.pool_hits,
                "pool_misses": self.pool_misses,
                "artifact_loads": self.artifact_loads,
                "artifact_compiles": self.artifact_compiles,
                "per_bucket": {k: dict(v)
                               for k, v in self.per_bucket.items()},
                "sheds": self.sheds,
                "deadline_misses": self.deadline_misses,
                "retries": self.retries,
                "retries_by_rung": {str(k): v for k, v
                                    in self.retries_by_rung.items()},
                "rejected": self.rejected,
                "breaker_trips": self.breaker_trips,
                "breaker_probes": self.breaker_probes,
                "breaker_recoveries": self.breaker_recoveries,
                "breaker_fast_fails": self.breaker_fast_fails,
                "queue_depth_peak": self.queue_depth_peak,
                "triage_rejected": self.triage_rejected,
                "triage_repaired": self.triage_repaired,
                "triage_warned": self.triage_warned,
                "triage_points_fixed": self.triage_points_fixed,
                "triage_edges_masked": self.triage_edges_masked,
                "triage_cams_anchored": self.triage_cams_anchored,
                "triage_edges_downweighted": self.triage_edges_downweighted,
            }
        base["problems_per_sec"] = self.problems_per_sec()
        base["padding_waste"] = self.padding_waste()
        base["bucket_occupancy"] = self.occupancy()
        base["pool_hit_rate"] = self.pool_hit_rate()
        return base

    def report(self) -> str:
        d = self.as_dict()
        lines = [
            f"fleet: {d['problems']} problems in {d['batches']} batches "
            f"({d['solve_seconds']:.3f}s solve wall, "
            f"{d['problems_per_sec']:.1f} problems/s)",
            f"  padding waste: {100 * d['padding_waste']:.1f}% of "
            f"lane-edge slots",
            f"  compile pool: {d['pool_hits']} hits / {d['pool_misses']} "
            f"misses ({100 * d['pool_hit_rate']:.0f}% hit rate)",
        ]
        if d["artifact_loads"] or d["artifact_compiles"]:
            lines.append(
                f"  artifact store: {d['artifact_loads']} loaded / "
                f"{d['artifact_compiles']} compiled")
        if (d["sheds"] or d["retries"] or d["rejected"]
                or d["deadline_misses"] or d["breaker_trips"]
                or d["breaker_fast_fails"]):
            lines.append(
                f"  resilience: {d['retries']} retries, {d['sheds']} shed, "
                f"{d['deadline_misses']} deadline-missed, "
                f"{d['rejected']} rejected; breaker: {d['breaker_trips']} "
                f"trips / {d['breaker_probes']} probes / "
                f"{d['breaker_recoveries']} recoveries / "
                f"{d['breaker_fast_fails']} fast-fails "
                f"(peak depth {d['queue_depth_peak']})")
        if d["triage_rejected"] or d["triage_repaired"] or d["triage_warned"]:
            lines.append(
                f"  triage: {d['triage_rejected']} rejected / "
                f"{d['triage_repaired']} repaired / "
                f"{d['triage_warned']} warned "
                f"({d['triage_points_fixed']} points fixed, "
                f"{d['triage_edges_masked']} edges masked, "
                f"{d['triage_cams_anchored']} cams anchored, "
                f"{d['triage_edges_downweighted']} edges downweighted)")
        for bucket, occ in sorted(d["bucket_occupancy"].items()):
            b = d["per_bucket"][bucket]
            lines.append(
                f"  {bucket}: {b['problems']} problems / "
                f"{b['batches']} batches, occupancy {100 * occ:.0f}%")
        return "\n".join(lines)

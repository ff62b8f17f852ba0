"""Render recorded SolveReports as convergence tables + phase breakdowns.

The port's copy of `megba_tpu/observability/summarize.py`: the same
views over the same schema-v2 JSONL, so it renders the reports of either
package.  What the text below says of the federation router, the
elastic monitor and the metrics registry describes report blocks the
port does not write yet (their slices are still to be ported); the views
read them when another producer wrote them.

Usage: python -m megba_tpu_torch.observability.summarize \
    [--aggregate | --fleet] [--metrics <snapshot.json>] <report.jsonl> [...]

Reads JSONL files written by the `MEGBA_TELEMETRY` sink (one SolveReport
per line) and prints, per report: a header (problem shape, backend,
config essentials), the result summary, the per-iteration convergence
table, the phase wall-clock breakdown, and memory stats when present.

`--aggregate` switches to the FLEET view: one block over all reports in
all given files — per-status counts, problems/sec, p50/p95 solve
latency, and (when the reports carry the serving layer's `fleet`
context) per-bucket problem counts plus the resilience counters
(escalated attempts / retries / sheds / deadline misses / rejections
and circuit-breaker transitions) — so a multi-problem run's JSONL is
readable without ad-hoc scripts.  Reports carrying a pre-flight triage
`health` block (robustness/triage.py) add a triage line — rejected /
repaired counts, repair totals (points fixed, edges masked, cams
anchored, edges downweighted) and findings by kind.  A federation
router's lifetime report (serving/federation.py) adds the federation
block: per-worker problem counts, steals, reroutes, worker-lost events
and per-worker cold-start mode/timing (artifact-load vs compile) with
the first-solve trace count.  Reports carrying the elastic-
distribution context (`SolveReport.elastic`, robustness/elastic.py)
add an elastic line: workers lost, collective timeouts, reshards,
resumes, and time-to-detection p50/max (last snapshot per monitor,
summed across monitors).

`--fleet` is the observability plane's multi-worker view: one
per-bucket table over ALL given JSONL files (solves, workers serving
the bucket, LM/PCG iteration mean+max, latency p50/p95/max), with a
per-worker totals line under it.  Worker attribution reads the v2
schema's `worker` field (router workers stamp it from
`MEGBA_FEDERATION_WORKER`) and falls back to `fleet.worker`, so mixed
v1/v2 streams still tabulate — v1 lines just land in the `-` worker
row.  `--metrics <snapshot.json>` (usable with either mode, or alone)
renders a metrics-registry snapshot — `FleetRouter.metrics_snapshot()`
merged output or a single process's `snapshot_to_json` — as a
counter/gauge/histogram table.
"""

from __future__ import annotations

import math
import sys
from typing import Iterable, List

from megba_tpu_torch.observability.report import SolveReport


def load_reports(path: str) -> List[SolveReport]:
    with open(path) as fh:
        return [SolveReport.from_json(line)
                for line in fh if line.strip()]


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f} {unit}"
        n /= 1024.0
    return f"{n:.1f} TiB"


def format_report(rep: SolveReport, index: int = 0) -> str:
    lines = []
    p, b, r = rep.problem, rep.backend, rep.result
    cfg = rep.config or {}
    lines.append(
        f"== report {index}: {p.get('num_cameras', '?')} cams / "
        f"{p.get('num_points', '?')} pts / {p.get('num_edges', '?')} edges "
        f"| {b.get('backend', '?')} x{b.get('device_count', '?')} "
        f"(process {b.get('process_index', 0)}/{b.get('process_count', 1)})")
    algo = cfg.get("algo_option", {}) or {}
    lines.append(
        f"   config: dtype={cfg.get('dtype')} "
        f"compute={cfg.get('compute_kind')} "
        f"jacobian={cfg.get('jacobian_mode')} "
        f"world_size={cfg.get('world_size')} "
        f"max_iter={algo.get('max_iter')}")
    lines.append(
        f"   result: cost {r.get('initial_cost', float('nan')):.6e} -> "
        f"{r.get('final_cost', float('nan')):.6e} in "
        f"{r.get('iterations')} LM iters ({r.get('accepted')} accepted, "
        f"{r.get('pcg_iterations')} PCG), stopped={r.get('stopped')}")
    fb = r.get("precond_fallback") or {}
    if fb.get("block") or fb.get("coarse"):
        # Per-level preconditioner fallback totals (solver/precond.py
        # enum codes, decoded at report build): block = SCHUR_DIAG
        # blocks fallen back to Hpp, coarse = iterations with a
        # degraded hierarchy level, per-level counts when multilevel.
        per = "".join(
            f" L{i + 1}:{n}" for i, n in
            enumerate(fb.get("coarse_levels") or []) if n)
        lines.append(
            f"   precond fallback: {fb.get('block', 0)} block / "
            f"{fb.get('coarse', 0)} coarse iters{per}")

    tiles = getattr(rep, "tiles", None) or {}
    if tiles:
        # Tile-plan attribution (solve.flat_solve): streaming reuse of
        # the planned edge stream + slot occupancy, and the fused
        # bucket-plan summaries when SolverOption.fused_kernels ran.
        rf = tiles.get("reuse_factor")
        occ = tiles.get("occupancy")
        line = f"   tiles[{tiles.get('plan', '?')}]:"
        if rf is not None:
            line += f" reuse_factor={rf:.1f}"
        if occ is not None:
            line += f" occupancy={occ:.3f}"
        lines.append(line)
        for dname in ("fused_to_pt", "fused_to_cam"):
            fp = tiles.get(dname)
            if fp:
                lines.append(
                    f"     fused {dname}: {fp.get('tiles')} tiles x "
                    f"{fp.get('tile')} slots, "
                    f"occupancy={fp.get('occupancy'):.3f}")

    if rep.trace and rep.trace.get("cost"):
        t = rep.trace
        lines.append("   iter  cost          log10    region     rho"
                     "        accept  pcg")
        for k, cost in enumerate(t["cost"]):
            log10 = math.log10(max(cost, 1e-300))
            lines.append(
                f"   {k:4d}  {cost:.6e}  {log10:7.3f}  "
                f"{t['trust_region'][k]:.3e}  {t['rho'][k]:9.3e}  "
                f"{'yes' if t['accept'][k] else ' no':>6}  "
                f"{t['pcg_iters'][k]:4d}")

    if rep.phases:
        lines.append("   phases:")
        total = 0.0
        for name in sorted(rep.phases,
                           key=lambda n: rep.phases[n]["total_s"],
                           reverse=True):
            ph = rep.phases[name]
            t_ms, c = ph["total_s"] * 1e3, ph["calls"]
            total += ph["total_s"]
            lines.append(f"     {name}: {t_ms:.1f} ms / {c} calls "
                         f"= {t_ms / c:.2f} ms")
        lines.append(f"     total: {total * 1e3:.1f} ms")

    if rep.memory:
        peak = rep.memory.get("peak_bytes_in_use")
        if peak is not None:
            lines.append(f"   memory: peak {_fmt_bytes(peak)} in use")
        else:
            lines.append(f"   memory: {rep.memory}")
    return "\n".join(lines)


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an ascending list (q in [0, 100])."""
    if not sorted_vals:
        return float("nan")
    rank = max(int(math.ceil(q / 100.0 * len(sorted_vals))) - 1, 0)
    return sorted_vals[min(rank, len(sorted_vals) - 1)]


def _report_latency(rep: SolveReport) -> float:
    """One report's solve latency: the serving layer's submit-to-result
    latency when present, else the summed phase wall clock."""
    if rep.fleet and rep.fleet.get("latency_s") is not None:
        return float(rep.fleet["latency_s"])
    if rep.phases:
        return sum(ph.get("total_s", 0.0) for ph in rep.phases.values())
    return float("nan")


def aggregate_reports(reports: List[SolveReport]) -> str:
    """The fleet view: status counts, throughput, latency percentiles."""
    if not reports:
        return "no reports"
    lines = []
    by_status: dict = {}
    for rep in reports:
        name = (rep.result or {}).get("status_name") or "unknown"
        by_status[name] = by_status.get(name, 0) + 1
    lats = sorted(l for l in (_report_latency(r) for r in reports)
                  if math.isfinite(l))

    # Throughput: wall span of the run when the reports spread over
    # time; a single batch's reports share one timestamp, so the span
    # is floored by the widest single solve so the rate stays finite
    # and honest.
    stamps = [r.created_unix for r in reports if r.created_unix]
    span = (max(stamps) - min(stamps)) if len(stamps) > 1 else 0.0
    if lats:
        span = max(span, lats[-1])
    rate = len(reports) / span if span > 0 else float("nan")

    lines.append(f"== fleet aggregate: {len(reports)} solves ==")
    for name in sorted(by_status):
        lines.append(f"   status {name}: {by_status[name]}")
    lines.append(f"   throughput: {rate:.2f} problems/s "
                 f"over {span:.3f}s span")
    if lats:
        lines.append(
            f"   latency: p50 {1e3 * _percentile(lats, 50):.1f} ms / "
            f"p95 {1e3 * _percentile(lats, 95):.1f} ms / "
            f"max {1e3 * lats[-1]:.1f} ms")
    buckets: dict = {}
    for rep in reports:
        if rep.fleet and rep.fleet.get("bucket"):
            buckets[rep.fleet["bucket"]] = (
                buckets.get(rep.fleet["bucket"], 0) + 1)
    for bucket in sorted(buckets):
        lines.append(f"   bucket {bucket}: {buckets[bucket]} solves")

    # Resilience view (PR 8): per-report escalation context, plus the
    # service-lifetime counters embedded in each report's fleet.stats —
    # the NEWEST report carries the most complete cumulative view
    # (sheds never emit a report of their own, so only the embedded
    # counters can account for them).  Known limit of a stream-only
    # view: events AFTER the final successful report (e.g. sheds during
    # close, or a run whose every problem was shed) are not in any
    # report — the live `FleetStats.report()` is the authoritative
    # in-process view.
    fleet_reps = [r for r in reports if r.fleet]
    if fleet_reps:
        # One report is emitted PER ATTEMPT (a dispatch that raised
        # emits none), so reports cannot count escalated PROBLEMS
        # exactly — count escalated ATTEMPTS that produced a result
        # instead; the exact re-enqueue total is the `retries` service
        # counter printed beside it.
        escalated = sum(1 for r in fleet_reps
                        if (r.fleet.get("attempts") or 1) > 1)
        max_rung = max((r.fleet.get("rung") or 0) for r in fleet_reps)
        latest = max(fleet_reps,
                     key=lambda r: (r.created_unix or 0.0))
        stats = latest.fleet.get("stats") or {}
        lines.append(
            f"   resilience: {escalated} escalated attempts "
            f"(max rung {max_rung}), "
            f"{stats.get('retries', 0)} retries, "
            f"{stats.get('sheds', 0)} shed, "
            f"{stats.get('deadline_misses', 0)} deadline-missed, "
            f"{stats.get('rejected', 0)} rejected")
        lines.append(
            f"   breaker: {stats.get('breaker_trips', 0)} trips / "
            f"{stats.get('breaker_probes', 0)} probes / "
            f"{stats.get('breaker_recoveries', 0)} recoveries / "
            f"{stats.get('breaker_fast_fails', 0)} fast-fails")

    # Triage view (PR 10): per-report `health` blocks carry each solved
    # problem's pre-flight findings and repair counters; REJECTED
    # problems never emit a report (zero dispatch), so — like sheds —
    # their count can only come from the service-lifetime counters
    # embedded in the NEWEST fleet report's stats.
    health_reps = [r for r in reports if r.health]
    stats_t: dict = {}
    if fleet_reps:
        latest_f = max(fleet_reps, key=lambda r: (r.created_unix or 0.0))
        stats_t = latest_f.fleet.get("stats") or {}
    if health_reps or stats_t.get("triage_rejected"):
        # Escalation retries emit one report per ATTEMPT, each carrying
        # the same health block — dedupe by the fleet problem name so a
        # rung-1 re-solve doesn't double its repair counters (reports
        # without a fleet name are standalone solves and count as-is).
        seen_names: set = set()
        deduped = []
        for rep in health_reps:
            name = (rep.fleet or {}).get("name")
            if name:
                if name in seen_names:
                    continue
                seen_names.add(name)
            deduped.append(rep)
        health_reps = deduped
        by_kind: dict = {}
        repaired = 0
        repair_tot = {"points_fixed": 0, "edges_masked": 0,
                      "cams_anchored": 0, "edges_downweighted": 0}
        for rep in health_reps:
            for f in rep.health.get("findings") or []:
                k = f.get("kind", "unknown")
                by_kind[k] = by_kind.get(k, 0) + int(f.get("count", 0))
            r = rep.health.get("repair")
            if r:
                repaired += 1
                for k in repair_tot:
                    repair_tot[k] += int(r.get(k, 0))
        lines.append(
            f"   triage: {stats_t.get('triage_rejected', 0)} rejected / "
            f"{repaired} repaired solves "
            f"({repair_tot['points_fixed']} points fixed, "
            f"{repair_tot['edges_masked']} edges masked, "
            f"{repair_tot['cams_anchored']} cams anchored, "
            f"{repair_tot['edges_downweighted']} edges downweighted)")
        if by_kind:
            lines.append("   findings: " + ", ".join(
                f"{k}={by_kind[k]}" for k in sorted(by_kind)))

    # Federation view (PR 12): one FederationStats snapshot per router
    # lifetime (serving/federation.append_federation_report) — keep the
    # LAST per router id and sum across routers, same shape as the
    # elastic ledger below.  Worker attribution also rides each fleet
    # report (`fleet.worker`), so the per-worker solve counts can be
    # cross-checked against the router's own routing ledger.
    latest_by_router: dict = {}
    for i, rep in enumerate(reports):
        if not rep.federation:
            continue
        key = rep.federation.get("router") or f"anon{i}"
        prev = latest_by_router.get(key)
        if prev is None or (rep.created_unix or 0.0) >= (
                prev.created_unix or 0.0):
            latest_by_router[key] = rep
    if latest_by_router:
        blocks = [r.federation for r in latest_by_router.values()]
        probs = sum(b.get("problems", 0) for b in blocks)
        steals = sum(b.get("steals", 0) for b in blocks)
        stolen = sum(b.get("stolen_problems", 0) for b in blocks)
        reroutes = sum(b.get("reroutes", 0) for b in blocks)
        lost = sum(b.get("workers_lost", 0) for b in blocks)
        by_worker: dict = {}
        for b in blocks:
            for w, n in (b.get("problems_by_worker") or {}).items():
                by_worker[w] = by_worker.get(w, 0) + n
        per = " / ".join(f"{w}:{by_worker[w]}" for w in sorted(by_worker))
        lines.append(
            f"   federation: {probs} problems across "
            f"{len(by_worker)} workers ({per or 'none'}), "
            f"{steals} steals ({stolen} problems), {reroutes} rerouted, "
            f"{lost} workers lost")
        for b in blocks:
            for w in sorted(b.get("cold_start") or {}):
                cs = b["cold_start"][w]
                fs = (b.get("first_solve") or {}).get(w) or {}
                extra = ""
                if fs.get("traces") is not None:
                    extra = f", first solve {fs['traces']} traces"
                lines.append(
                    f"   cold start {w}: {cs.get('mode', '?')} "
                    f"{float(cs.get('warm_s', float('nan'))):.3f}s "
                    f"({cs.get('artifact_loads', 0)} loaded / "
                    f"{cs.get('artifact_compiles', 0)} compiled)"
                    + extra)

    # Elastic view (PR 9): each elastic block is a CUMULATIVE snapshot
    # of one rank's ElasticMonitor (chunked solves emit one per chunk),
    # so keep the last snapshot per `monitor` id and sum ACROSS
    # monitors — counting every snapshot would multiply the ledger by
    # the chunk count.
    latest_by_monitor: dict = {}
    for i, rep in enumerate(reports):
        if not rep.elastic:
            continue
        key = rep.elastic.get("monitor") or f"anon{i}"
        prev = latest_by_monitor.get(key)
        if prev is None or (rep.created_unix or 0.0) >= (
                prev.created_unix or 0.0):
            latest_by_monitor[key] = rep
    if latest_by_monitor:
        blocks = [r.elastic for r in latest_by_monitor.values()]
        lost = sum(b.get("workers_lost", 0) for b in blocks)
        timeouts = sum(b.get("collective_timeouts", 0) for b in blocks)
        reshards = sum(b.get("reshards", 0) for b in blocks)
        resumes = sum(b.get("resumes", 0) for b in blocks)
        detections = sorted(
            float(s) for b in blocks for s in (b.get("detection_s") or []))
        lines.append(
            f"   elastic: {lost} workers lost, {timeouts} collective "
            f"timeouts, {reshards} reshards, {resumes} resumes "
            f"({len(latest_by_monitor)} monitors)")
        if detections:
            lines.append(
                f"   time-to-detection: p50 "
                f"{_percentile(detections, 50):.3f}s / max "
                f"{detections[-1]:.3f}s over {len(detections)} losses")
    return "\n".join(lines)


def fleet_table(reports: List[SolveReport]) -> str:
    """Per-bucket iteration/latency stats across a multi-worker fleet.

    Buckets come from the serving layer's `fleet.bucket` context
    (reports without one — standalone solves — group under
    "unbatched"); worker attribution prefers the v2 `worker` field and
    falls back to `fleet.worker` so v1 lines still land in the table.
    """
    if not reports:
        return "no reports"
    rows: dict = {}
    by_worker: dict = {}
    for rep in reports:
        fleet = rep.fleet or {}
        bucket = fleet.get("bucket") or "unbatched"
        worker = (getattr(rep, "worker", None)
                  or fleet.get("worker") or "-")
        row = rows.setdefault(
            bucket, {"n": 0, "workers": set(), "lm": [], "pcg": [],
                     "lat": []})
        row["n"] += 1
        row["workers"].add(worker)
        by_worker[worker] = by_worker.get(worker, 0) + 1
        r = rep.result or {}
        if r.get("iterations") is not None:
            row["lm"].append(int(r["iterations"]))
        if r.get("pcg_iterations") is not None:
            row["pcg"].append(int(r["pcg_iterations"]))
        lat = _report_latency(rep)
        if math.isfinite(lat):
            row["lat"].append(lat)

    def _mean(vals: List[float]) -> float:
        return sum(vals) / len(vals) if vals else float("nan")

    lines = [f"== fleet table: {len(reports)} solves / "
             f"{len(rows)} buckets / {len(by_worker)} workers =="]
    header = (f"   {'bucket':<28} {'solves':>6} {'workers':>7} "
              f"{'lm avg':>7} {'lm max':>7} {'pcg avg':>8} "
              f"{'p50 ms':>8} {'p95 ms':>8} {'max ms':>8}")
    lines.append(header)
    for bucket in sorted(rows):
        row = rows[bucket]
        lat = sorted(row["lat"])
        lines.append(
            f"   {bucket:<28} {row['n']:>6} {len(row['workers']):>7} "
            f"{_mean(row['lm']):>7.1f} "
            f"{max(row['lm'], default=0):>7d} "
            f"{_mean(row['pcg']):>8.1f} "
            f"{1e3 * _percentile(lat, 50):>8.1f} "
            f"{1e3 * _percentile(lat, 95):>8.1f} "
            f"{1e3 * (lat[-1] if lat else float('nan')):>8.1f}")
    per = " / ".join(f"{w}:{by_worker[w]}" for w in sorted(by_worker))
    lines.append(f"   by worker: {per}")
    traced = sum(1 for r in reports if getattr(r, "trace_id", None))
    if traced:
        n_traces = len({r.trace_id for r in reports
                        if getattr(r, "trace_id", None)})
        lines.append(f"   traced: {traced} solves in {n_traces} traces")
    return "\n".join(lines)


def format_metrics_snapshot(snap: dict) -> str:
    """Render a metrics-registry snapshot (one process's or the
    router's merged fleet view) as a readable table."""
    lines = [f"== metrics snapshot ({snap.get('schema', '?')}) =="]
    for name in sorted(snap.get("metrics") or {}):
        m = snap["metrics"][name]
        kind = m.get("kind", "?")
        lines.append(f"   {name} ({kind})")
        for key in sorted(m.get("series") or {}):
            s = m["series"][key]
            label = f"{{{key}}}" if key else ""
            if kind == "histogram":
                count = s.get("count", 0)
                total = s.get("sum", 0.0)
                mean = total / count if count else float("nan")
                lines.append(
                    f"     {label or '(no labels)'}: count {count}, "
                    f"sum {total:.6g}, mean {mean:.6g}")
            else:
                lines.append(
                    f"     {label or '(no labels)'}: {float(s):g}")
    return "\n".join(lines)


def fleet_paths(paths: Iterable[str]) -> str:
    reports: List[SolveReport] = []
    for path in paths:
        reports.extend(load_reports(path))
    return fleet_table(reports)


def aggregate_paths(paths: Iterable[str]) -> str:
    reports: List[SolveReport] = []
    for path in paths:
        reports.extend(load_reports(path))
    return aggregate_reports(reports)


def summarize_paths(paths: Iterable[str]) -> str:
    blocks = []
    for path in paths:
        reports = load_reports(path)
        blocks.append(f"{path}: {len(reports)} report(s)")
        blocks.extend(format_report(rep, i) for i, rep in enumerate(reports))
    return "\n".join(blocks)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip())
        return 0 if argv else 2
    aggregate = "--aggregate" in argv
    fleet = "--fleet" in argv
    metrics_path = None
    paths = []
    it = iter(a for a in argv if a not in ("--aggregate", "--fleet"))
    for a in it:
        if a == "--metrics":
            metrics_path = next(it, None)
            if metrics_path is None:
                print("--metrics requires a snapshot path",
                      file=sys.stderr)
                return 2
        else:
            paths.append(a)
    if not paths and metrics_path is None:
        print(__doc__.strip())
        return 2
    if paths:
        if fleet:
            print(fleet_paths(paths))
        elif aggregate:
            print(aggregate_paths(paths))
        else:
            print(summarize_paths(paths))
    if metrics_path is not None:
        import json

        with open(metrics_path) as fh:
            print(format_metrics_snapshot(json.load(fh)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

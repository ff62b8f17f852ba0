"""The port's observability plane (megba_tpu_torch/observability/:
metrics.py, spans.py, flight.py and the gates) against the JAX package's.

Ports of the JAX package's tests/test_obsplane.py cases that need no
federation: the gates closed by default (and, in a fresh interpreter,
no lazy module imported by a telemetry-off solve), registry thread
safety, the Prometheus text equal to JAX's `render_prometheus` for the
same recorded series, `merge_snapshots` bitwise deterministic with
bucket skew refused, the `FleetStats` mirror (the same series as JAX's
mirror), the Chrome trace schema (the same export as JAX's for the same
spans), the bounded ordered flight ring and its dump schema, and a
`SolveReport` carrying the active span's ids.  Also the plane on the
port's own call sites: phase spans of a solve, one `solve_bucket` span
per bucket, and the flight ring of a queue under chaos.  No program of
the JAX package is compiled here.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from megba_tpu.observability import flight as j_flight
from megba_tpu.observability import metrics as j_metrics
from megba_tpu.observability import spans as j_spans
from megba_tpu.serving.stats import FleetStats as JFleetStats

import megba_tpu_torch as mt
from megba_tpu_torch import observability as obs
from megba_tpu_torch.common import AlgoOption, Device, ProblemOption
from megba_tpu_torch.observability import flight, metrics, spans
from megba_tpu_torch.serving.stats import FleetStats

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("MEGBA_METRICS", "MEGBA_TRACE", "MEGBA_FLIGHT")
OPT = ProblemOption(dtype=np.float64, device=Device.CPU,
                    algo_option=AlgoOption(max_iter=2))


def _reset():
    for mod in (metrics, j_metrics):
        mod.reset_default_registry()
    for mod in (spans, flight, j_spans, j_flight):
        mod.reset_default_recorder()


@pytest.fixture
def armed(monkeypatch, tmp_path):
    """Arm the three knobs with fresh process defaults (both packages'),
    and disarm and reset after, so no other test sees the plane."""
    flight_path = tmp_path / "flight.jsonl"
    monkeypatch.setenv("MEGBA_METRICS", "1")
    monkeypatch.setenv("MEGBA_TRACE", "1")
    monkeypatch.setenv("MEGBA_FLIGHT", str(flight_path))
    _reset()
    yield flight_path
    _reset()


def _problems(n=3, seed=0):
    fl = mt.io.synthetic.make_fleet(n, size_range=(17, 30), seed=seed)
    return [mt.FleetProblem.from_synthetic(s, name=f"p{i}")
            for i, s in enumerate(fl)]


# ---------------------------------------------------------------- gates


def test_gates_closed_by_default(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    assert obs.metrics_registry() is None
    assert obs.span_recorder() is None
    assert obs.flight_recorder() is None
    # The per-solve knob opens the metrics gate without the environment.
    assert obs.metrics_registry(enabled=True) is metrics.default_registry()


def test_plane_off_imports_no_lazy_module(tmp_path):
    """A telemetry-off, plane-off `flat_solve` and `solve_many` import
    none of report, summarize, metrics, spans or flight, and write no
    file (a fresh interpreter: in-process other tests import them)."""
    code = (
        "import sys\n"
        "import megba_tpu_torch as mt\n"
        "from megba_tpu_torch.common import AlgoOption, Device, "
        "ProblemOption\n"
        "opt = ProblemOption(device=Device.CPU, algo_option=AlgoOption("
        "max_iter=1))\n"
        "s = mt.make_synthetic_bal(num_cameras=3, num_points=12, seed=0)\n"
        "mt.flat_solve(s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,"
        " opt)\n"
        "mt.solve_many([mt.FleetProblem.from_synthetic(s)], opt)\n"
        "mods = ('report', 'summarize', 'metrics', 'spans', 'flight')\n"
        "bad = [m for m in sys.modules if m == 'jax' or any("
        "m == 'megba_tpu_torch.observability.' + k for k in mods)]\n"
        "assert not bad, bad\n"
        "print('NOOP_OK')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in KNOBS + ("MEGBA_TELEMETRY",)}
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NOOP_OK" in proc.stdout
    assert list(tmp_path.iterdir()) == []


# ------------------------------------------------------------- registry


def test_registry_thread_safety_under_concurrent_increments():
    reg = metrics.MetricsRegistry()
    n_threads, n_each = 8, 500
    barrier = threading.Barrier(n_threads)

    def worker(tid):
        barrier.wait()
        for i in range(n_each):
            reg.counter("megba_test_total", "t").inc(bucket=f"b{tid % 2}")
            reg.gauge("megba_test_depth", "t").max(i, bucket="b0")
            reg.histogram("megba_test_lat", "t").observe(
                0.001 * (i % 7 + 1), bucket="b0")

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = reg.snapshot()
    counters = snap["metrics"]["megba_test_total"]["series"]
    assert sum(counters.values()) == n_threads * n_each
    assert counters["bucket=b0"] == counters["bucket=b1"]
    hist = snap["metrics"]["megba_test_lat"]["series"]["bucket=b0"]
    assert hist["count"] == n_threads * n_each
    assert sum(hist["buckets"]) == hist["count"]
    assert snap["metrics"]["megba_test_depth"]["series"]["bucket=b0"] == (
        n_each - 1)


def _record_golden(mod):
    """The JAX package's golden series plus the escaping and number
    formats, recorded into a fresh registry of `mod`."""
    reg = mod.MetricsRegistry()
    reg.counter("megba_solves_total", "Solves by status").inc(
        3, status="converged", bucket="B1")
    reg.counter("megba_solves_total", "Solves by status").inc(
        1, status="max_iter", bucket="B1")
    reg.gauge("megba_queue_depth", "Queue depth").set(7)
    h = reg.histogram("megba_latency_seconds", "Latency",
                      buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v, bucket="B1")
    reg.counter("megba_escape_total", "").inc(
        2.5, path='a"b\\c\nd', rung=1)
    g = reg.gauge("megba_formats", "Number formats")
    for i, v in enumerate((math.nan, math.inf, -math.inf, 1e20, 0.1, -3.0,
                           1e15, 123456789.25)):
        g.set(v, case=str(i))
    reg.gauge("megba_formats", "Number formats").max(-1.0, case="peak")
    reg.histogram("megba_iters", "Iterations",
                  buckets=mod.ITER_BUCKETS).observe(3, bucket="unbatched",
                                                    factor="-")
    return reg


def test_prometheus_exposition_golden():
    """The JAX package's golden text, from the port's registry."""
    reg = metrics.MetricsRegistry()
    reg.counter("megba_solves_total", "Solves by status").inc(
        3, status="converged", bucket="B1")
    reg.counter("megba_solves_total", "Solves by status").inc(
        1, status="max_iter", bucket="B1")
    reg.gauge("megba_queue_depth", "Queue depth").set(7)
    h = reg.histogram("megba_latency_seconds", "Latency",
                      buckets=(0.1, 1.0))
    h.observe(0.05, bucket="B1")
    h.observe(0.5, bucket="B1")
    h.observe(5.0, bucket="B1")
    golden = (
        "# HELP megba_latency_seconds Latency\n"
        "# TYPE megba_latency_seconds histogram\n"
        'megba_latency_seconds_bucket{bucket="B1",le="0.1"} 1\n'
        'megba_latency_seconds_bucket{bucket="B1",le="1"} 2\n'
        'megba_latency_seconds_bucket{bucket="B1",le="+Inf"} 3\n'
        'megba_latency_seconds_sum{bucket="B1"} 5.55\n'
        'megba_latency_seconds_count{bucket="B1"} 3\n'
        "# HELP megba_queue_depth Queue depth\n"
        "# TYPE megba_queue_depth gauge\n"
        "megba_queue_depth 7\n"
        "# HELP megba_solves_total Solves by status\n"
        "# TYPE megba_solves_total counter\n"
        'megba_solves_total{bucket="B1",status="converged"} 3\n'
        'megba_solves_total{bucket="B1",status="max_iter"} 1\n'
    )
    assert metrics.render_prometheus(reg.snapshot()) == golden


@pytest.mark.parametrize("surface", ["prometheus", "json", "merged"])
def test_exposition_equals_jax(surface):
    """The same recorded series give byte-identical Prometheus text,
    canonical JSON and merged snapshots in both packages."""
    t, j = _record_golden(metrics), _record_golden(j_metrics)
    if surface == "prometheus":
        got = metrics.render_prometheus(t.snapshot())
        want = j_metrics.render_prometheus(j.snapshot())
        assert 'path="a\\"b\\\\c\\nd"' in got and "NaN" in got
    elif surface == "json":
        got = metrics.snapshot_to_json(t.snapshot())
        want = j_metrics.snapshot_to_json(j.snapshot())
    else:
        got = metrics.render_prometheus(metrics.merge_snapshots(
            [t.snapshot(), _record_golden(metrics).snapshot()]))
        want = j_metrics.render_prometheus(j_metrics.merge_snapshots(
            [j.snapshot(), _record_golden(j_metrics).snapshot()]))
    assert got == want
    assert metrics.SCHEMA == j_metrics.SCHEMA
    assert metrics.LATENCY_BUCKETS_S == j_metrics.LATENCY_BUCKETS_S
    assert metrics.ITER_BUCKETS == j_metrics.ITER_BUCKETS
    assert metrics.RATIO_BUCKETS == j_metrics.RATIO_BUCKETS


def test_merge_snapshots_sums_and_is_bitwise_deterministic():
    def make(n):
        reg = metrics.MetricsRegistry()
        reg.counter("megba_x_total", "x").inc(n, bucket="B1")
        reg.gauge("megba_depth", "d").set(n)
        reg.histogram("megba_lat", "l").observe(0.01 * n, bucket="B1")
        return reg.snapshot()

    a, b = make(2), make(5)
    merged = metrics.merge_snapshots([a, b])
    assert merged["metrics"]["megba_x_total"]["series"]["bucket=B1"] == 7
    assert merged["metrics"]["megba_depth"]["series"][""] == 7
    assert merged["metrics"]["megba_lat"]["series"]["bucket=B1"][
        "count"] == 2
    assert metrics.snapshot_to_json(metrics.merge_snapshots([a, b])) == (
        metrics.snapshot_to_json(metrics.merge_snapshots([a, b])))
    assert (metrics.merge_snapshots([a, b])["metrics"]
            == metrics.merge_snapshots([b, a])["metrics"])


@pytest.mark.parametrize("skew", ["buckets", "kind"])
def test_merge_rejects_skew(skew):
    r1, r2 = metrics.MetricsRegistry(), metrics.MetricsRegistry()
    r1.histogram("megba_lat", "l", buckets=(0.1, 1.0)).observe(0.5)
    if skew == "buckets":
        r2.histogram("megba_lat", "l", buckets=(0.2, 2.0)).observe(0.5)
        match = "bucket mismatch"
    else:
        r2.counter("megba_lat", "l").inc()
        match = "kind mismatch"
    with pytest.raises(ValueError, match=match):
        metrics.merge_snapshots([r1.snapshot(), r2.snapshot()])


def test_registry_refuses_kind_change_and_bad_buckets():
    reg = metrics.MetricsRegistry()
    reg.counter("megba_a", "a")
    with pytest.raises(ValueError, match="already registered as counter"):
        reg.gauge("megba_a", "a")
    with pytest.raises(ValueError, match="strictly increasing"):
        reg.histogram("megba_b", "b", buckets=(1.0, 0.5))


def _drive_stats(stats):
    stats.record_pool(False)
    stats.record_pool(True)
    stats.record_artifact(False)
    stats.record_shed(2)
    stats.record_deadline_miss()
    stats.record_retry(rung=1)
    stats.record_retry(rung=2)
    stats.record_reject(3)
    for event in ("trip", "probe", "recover", "fast_fail"):
        stats.record_breaker(event)
    stats.record_depth(5)
    stats.record_depth(2)
    stats.record_wait("B1", 0.02)
    stats.record_triage("repaired", {"points_fixed": 2})
    stats.record_triage("rejected")
    stats.record_batch("B1", 8, 5, 100, 2048, 0.5)


def test_fleet_stats_mirror_into_registry(armed):
    """Every `record_*` lands in the registry under JAX's names and
    labels: the two mirrors' Prometheus texts are equal."""
    t, j = FleetStats(), JFleetStats()
    _drive_stats(t)
    _drive_stats(j)
    snap = metrics.default_registry().snapshot()
    m = snap["metrics"]
    assert m["megba_queue_shed_total"]["series"][""] == 2
    assert m["megba_queue_retries_total"]["series"]["rung=1"] == 1
    assert m["megba_queue_wait_seconds"]["series"]["bucket=B1"][
        "count"] == 1
    assert m["megba_queue_depth"]["series"][""] == 2
    assert m["megba_queue_depth_peak"]["series"][""] == 5
    assert metrics.render_prometheus(snap) == j_metrics.render_prometheus(
        j_metrics.default_registry().snapshot())
    assert t.as_dict()["queue_depth_peak"] == 5


def test_fleet_stats_off_records_nothing(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    _reset()
    _drive_stats(FleetStats())
    assert metrics.default_registry().snapshot()["metrics"] == {}


# ---------------------------------------------------------------- spans


def test_chrome_trace_export_schema(armed, tmp_path):
    """The span schema and the Chrome trace export: the port's export of
    its recorded spans equals the JAX package's export of the same spans,
    and `write_chrome_trace` writes it."""
    rec = obs.span_recorder()
    with rec.span("request", bucket="B1"):
        with rec.span("solve_bucket"):
            rec.record_phase("dispatch", 0.01)
    with pytest.raises(RuntimeError):
        with rec.span("failing"):
            raise RuntimeError("boom")
    doc = spans.to_chrome_trace(rec.spans())
    assert doc == j_spans.to_chrome_trace(rec.spans())
    assert doc["schema"] == spans.SCHEMA == j_spans.SCHEMA
    events = doc["traceEvents"]
    meta = [e for e in events if e["ph"] == "M"]
    complete = [e for e in events if e["ph"] == "X"]
    assert meta and meta[0]["name"] == "process_name"
    assert {e["name"] for e in complete} == {
        "request", "solve_bucket", "phase.dispatch", "failing"}
    by_name = {e["name"]: e for e in complete}
    assert by_name["failing"]["args"]["error"] == "RuntimeError"
    assert (by_name["solve_bucket"]["args"]["parent_id"]
            == by_name["request"]["args"]["span_id"])
    assert (by_name["phase.dispatch"]["args"]["parent_id"]
            == by_name["solve_bucket"]["args"]["span_id"])
    for e in complete:
        assert e["dur"] >= 0 and isinstance(e["pid"], int)
        assert 0 <= e["tid"] < (1 << 31)
        assert e["args"]["trace_id"]
    path = tmp_path / "trace.json"
    spans.write_chrome_trace(str(path), rec.spans())
    assert json.loads(path.read_text()) == json.loads(json.dumps(doc))


def test_span_context_adopt_ingest_and_drain(armed):
    """A context taken from one recorder grafts spans of another under
    it; `ingest` merges them and `drain` empties the recorder."""
    rec = obs.span_recorder()
    assert rec.context() is None
    other = spans.SpanRecorder(process_name="w0")
    with rec.span("dispatch") as parent:
        ctx = rec.context()
        assert ctx == {"trace_id": parent["trace_id"],
                       "span_id": parent["span_id"]}
        with other.adopt("worker_solve", ctx, worker="w0"):
            pass
    rec.ingest(other.drain())
    assert other.spans() == []
    got = {s["name"]: s for s in rec.drain()}
    assert got["worker_solve"]["parent_id"] == got["dispatch"]["span_id"]
    assert got["worker_solve"]["trace_id"] == got["dispatch"]["trace_id"]
    assert got["worker_solve"]["process"] == "w0"
    assert rec.spans() == []


def test_solve_phases_and_buckets_become_spans(armed):
    """Armed, a `flat_solve`'s PhaseTimer phases become spans, and a
    `solve_many` records one `solve_bucket` span per bucket with its
    phases nested under it."""
    s = mt.make_synthetic_bal(num_cameras=3, num_points=16, seed=0)
    mt.flat_solve(s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx, OPT)
    rec = obs.span_recorder()
    names = [x["name"] for x in rec.drain()]
    assert {"phase.lowering", "phase.plan", "phase.dispatch"} <= set(names)
    res = mt.solve_many(_problems(4), OPT)
    got = rec.drain()
    buckets = [x for x in got if x["name"] == "solve_bucket"]
    assert len(buckets) == len({str(r.shape) for r in res})
    ids = {x["span_id"] for x in buckets}
    dispatch = [x for x in got if x["name"] == "phase.dispatch"]
    assert dispatch and all(x["parent_id"] in ids for x in dispatch)
    assert buckets[0]["args"]["factor"] == "bal"


def test_solve_report_carries_span_ids(armed, tmp_path):
    """Under an armed recorder the report line names the active span."""
    from megba_tpu_torch.observability.report import SolveReport

    sink = tmp_path / "reports.jsonl"
    s = mt.make_synthetic_bal(num_cameras=3, num_points=16, seed=0)
    rec = obs.span_recorder()
    with rec.span("request") as span:
        mt.flat_solve(s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
                      dataclasses.replace(OPT, telemetry=str(sink)))
    rep = SolveReport.from_json(sink.read_text().splitlines()[-1])
    assert (rep.trace_id, rep.span_id) == (span["trace_id"],
                                           span["span_id"])
    assert rep.worker is None


# --------------------------------------------------------------- flight


def test_flight_ring_is_bounded_and_ordered():
    rec = flight.FlightRecorder(capacity=4, process_name="t")
    for i in range(10):
        rec.record("tick", i=i)
    events = rec.events()
    assert len(events) == 4
    assert [e["i"] for e in events] == [6, 7, 8, 9]
    assert [e["seq"] for e in events] == [7, 8, 9, 10]
    d = rec.dump_dict(reason="test")
    assert d["dropped"] == 6 and d["process"] == "t"
    rec.clear()
    assert rec.events() == [] and rec.dump_dict()["dropped"] == 0
    with pytest.raises(ValueError, match="capacity"):
        flight.FlightRecorder(capacity=0)
    assert flight.DEFAULT_CAPACITY == j_flight.DEFAULT_CAPACITY == 256


def test_flight_dump_schema_matches_jax(armed):
    """The dump line has JAX's schema and keys; each package's
    `load_dumps` reads the other's file, skipping a torn line."""
    path = str(armed)
    t, j = flight.FlightRecorder(), j_flight.FlightRecorder()
    for rec in (t, j):
        rec.record("breaker", event="trip", bucket="B1", reason="x")
    assert flight.dump_path() == path
    obs.flight_recorder().record("queue_shed", count=1, names=["a"])
    assert flight.dump_default("test") == path
    j.dump(path, reason="jax")
    with open(path, "a") as fh:
        fh.write('{"schema": "megba_tpu.flight/v1", "torn\n')
    ported, ref = flight.load_dumps(path), j_flight.load_dumps(path)
    assert ported == ref and len(ported) == 2
    assert set(ported[0]) == set(ported[1]) == set(j.dump_dict())
    assert ported[0]["schema"] == flight.SCHEMA == j_flight.SCHEMA
    assert ported[0]["events"][0]["kind"] == "queue_shed"
    assert set(t.events()[0]) == set(j.events()[0])


def test_flight_ring_records_queue_chaos(armed):
    """A FleetQueue under injected dispatch failures and a deadline
    records the chaos, the dispatch failure, the escalation retry, the
    breaker event and the shed in the ring."""
    from megba_tpu_torch import EscalationPolicy, FleetQueue
    from megba_tpu_torch.robustness.faults import DispatchChaos
    from megba_tpu_torch.serving import DeadlineExceeded

    probs = _problems(3)
    with FleetQueue(OPT, max_batch=2, max_wait_s=30.0,
                    escalation=EscalationPolicy(backoff_base_s=0.0, seed=0),
                    chaos=DispatchChaos(fail_first=1)) as q:
        futs = [q.submit(p) for p in probs[:2]]
        doomed = q.submit(probs[2], deadline_s=0.0)
        q.flush()
        for f in futs:
            assert np.isfinite(float(f.result(timeout=60).cost))
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=60)
    kinds = [e["kind"] for e in obs.flight_recorder().events()]
    for kind in ("chaos_injection", "dispatch_failure", "escalation_retry",
                 "queue_shed"):
        assert kind in kinds, kinds
    assert kinds.index("chaos_injection") < kinds.index("dispatch_failure")

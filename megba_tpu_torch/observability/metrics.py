"""Process-local metrics registry with Prometheus exposition.

Counterpart of `megba_tpu/observability/metrics.py`, with its names,
label escaping, number format and schema, so the Prometheus text of the
same recorded series is byte-identical in both packages.  A thread-safe
registry of counters, gauges and histograms that the queue, the batcher,
the compile pool and the solve entry points increment from the host
only: a solve launches the same kernels, and gives the same bits, with
metrics on or off.

Consumption surfaces:

- ``registry.snapshot()``: a JSON-round-trippable dict with sorted,
  deterministic keys; :func:`merge_snapshots` merges the snapshots of
  several processes.
- :func:`render_prometheus`: the Prometheus text exposition format
  (``# HELP`` / ``# TYPE`` headers, ``_bucket`` / ``_sum`` / ``_count``
  histogram series with cumulative ``le`` labels) of any snapshot.
- ``summarize --fleet --metrics`` renders a snapshot as a table.

Off by default: nothing in the package imports this module unless
``MEGBA_METRICS`` (or the per-solve ``ProblemOption.metrics`` knob) is
set; consumers go through ``observability.metrics_registry()``, which
imports it lazily.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SCHEMA = "megba_tpu.metrics/v1"

# Fixed log-spaced latency buckets (seconds): 1ms .. 60s in 1/2.5/5
# decades.  Fixed on purpose — merged snapshots from N workers must share
# bucket boundaries or the merge is meaningless.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 25.0, 60.0,
)

# Fill/padding ratios and other [0, 1] observables.
RATIO_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 1.0,
)

# Iteration-count observables (LM/PCG iterations per solve).
ITER_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
)


def _label_key(labels: Dict[str, str]) -> str:
    """Canonical series key: sorted ``k=v`` pairs joined by ``,``.

    Sorted so that snapshots (and their merges) are order-independent
    and bitwise-deterministic regardless of increment interleaving.
    """
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


def _parse_label_key(key: str) -> List[Tuple[str, str]]:
    if not key:
        return []
    return [tuple(part.split("=", 1)) for part in key.split(",")]


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """One named metric family; per-label-set series live in `_series`."""

    kind = "untyped"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._registry = registry
        # One registry-wide lock shared by every family: series updates
        # and whole-registry snapshots serialize against each other.
        self._lock = registry._lock
        self._series: Dict[str, object] = {}  # megba: guarded-by(_lock)

    def _series_dict(self):
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1, **labels: str) -> None:
        key = _label_key({k: str(v) for k, v in labels.items()})
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + n

    def _series_dict(self):
        return {k: self._series[k] for k in sorted(self._series)}


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels: str) -> None:
        key = _label_key({k: str(v_) for k, v_ in labels.items()})
        with self._lock:
            self._series[key] = float(v)

    def max(self, v: float, **labels: str) -> None:
        """Record a high-water mark (e.g. peak queue depth)."""
        key = _label_key({k: str(v_) for k, v_ in labels.items()})
        with self._lock:
            self._series[key] = max(float(v), self._series.get(key, -math.inf))

    def _series_dict(self):
        return {k: self._series[k] for k in sorted(self._series)}


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, registry,
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        super().__init__(name, help, registry)
        self.buckets: Tuple[float, ...] = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(
                f"histogram {name!r} buckets must be strictly increasing, "
                f"got {buckets}")

    def observe(self, v: float, **labels: str) -> None:
        key = _label_key({k: str(v_) for k, v_ in labels.items()})
        v = float(v)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = {"buckets": [0] * len(self.buckets),
                          "sum": 0.0, "count": 0}
                self._series[key] = series
            # Non-cumulative per-bucket counts internally; exposition
            # renders the Prometheus cumulative form.
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    series["buckets"][i] += 1
                    break
            series["sum"] += v
            series["count"] += 1

    def _series_dict(self):
        out = {}
        for k in sorted(self._series):
            s = self._series[k]
            out[k] = {"buckets": list(s["buckets"]),
                      "sum": s["sum"], "count": s["count"]}
        return out


class MetricsRegistry:
    """Thread-safe get-or-create registry of named metric families."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}  # megba: guarded-by(_lock)

    def _get_or_create(self, cls, name, help, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, self, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def snapshot(self) -> Dict:
        """JSON-round-trippable snapshot with deterministic key order."""
        with self._lock:
            metrics = {}
            for name in sorted(self._metrics):
                m = self._metrics[name]
                entry = {"kind": m.kind, "help": m.help,
                         "series": m._series_dict()}
                if isinstance(m, Histogram):
                    entry["buckets"] = list(m.buckets)
                metrics[name] = entry
            return {"schema": SCHEMA, "metrics": metrics}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


def merge_snapshots(snapshots: Iterable[Dict]) -> Dict:
    """Merge snapshots from N processes into one.

    Counters and histogram series sum; gauges sum too (the fleet gauges
    — queue depth, in-flight — are additive across workers, and summing
    in sorted-series order keeps the result bitwise-deterministic for
    any input order of equal snapshots).  Histogram merges require equal
    bucket boundaries (they are fixed module constants, so drift means a
    version skew worth failing loudly on).
    """
    merged: Dict[str, Dict] = {}
    for snap in snapshots:
        if not snap:
            continue
        for name, entry in sorted(snap.get("metrics", {}).items()):
            tgt = merged.get(name)
            if tgt is None:
                tgt = {"kind": entry["kind"], "help": entry.get("help", ""),
                       "series": {}}
                if "buckets" in entry:
                    tgt["buckets"] = list(entry["buckets"])
                merged[name] = tgt
            if tgt["kind"] != entry["kind"]:
                raise ValueError(
                    f"metric {name!r} kind mismatch in merge: "
                    f"{tgt['kind']} vs {entry['kind']}")
            if entry["kind"] == "histogram" and (
                    list(entry.get("buckets", [])) != tgt.get("buckets")):
                raise ValueError(
                    f"histogram {name!r} bucket mismatch in merge")
            for key in sorted(entry["series"]):
                s = entry["series"][key]
                t = tgt["series"].get(key)
                if entry["kind"] == "histogram":
                    if t is None:
                        t = {"buckets": [0] * len(s["buckets"]),
                             "sum": 0.0, "count": 0}
                        tgt["series"][key] = t
                    t["buckets"] = [a + b for a, b
                                    in zip(t["buckets"], s["buckets"])]
                    t["sum"] += s["sum"]
                    t["count"] += s["count"]
                else:
                    tgt["series"][key] = (0.0 if t is None else t) + s
    return {"schema": SCHEMA,
            "metrics": {k: _sorted_entry(merged[k]) for k in sorted(merged)}}


def _sorted_entry(entry: Dict) -> Dict:
    out = {"kind": entry["kind"], "help": entry.get("help", ""),
           "series": {k: entry["series"][k] for k in sorted(entry["series"])}}
    if "buckets" in entry:
        out["buckets"] = entry["buckets"]
    return out


def render_prometheus(snapshot: Dict) -> str:
    """Prometheus text exposition (format 0.0.4) of a snapshot."""
    lines: List[str] = []
    for name in sorted(snapshot.get("metrics", {})):
        entry = snapshot["metrics"][name]
        if entry.get("help"):
            lines.append(f"# HELP {name} {entry['help']}")
        lines.append(f"# TYPE {name} {entry['kind']}")
        if entry["kind"] == "histogram":
            buckets = entry["buckets"]
            for key in sorted(entry["series"]):
                s = entry["series"][key]
                base = _parse_label_key(key)
                cum = 0
                for ub, n in zip(buckets, s["buckets"]):
                    cum += n
                    lines.append(_sample(f"{name}_bucket",
                                         base + [("le", _fmt_value(ub))],
                                         cum))
                lines.append(_sample(f"{name}_bucket",
                                     base + [("le", "+Inf")], s["count"]))
                lines.append(_sample(f"{name}_sum", base, s["sum"]))
                lines.append(_sample(f"{name}_count", base, s["count"]))
        else:
            for key in sorted(entry["series"]):
                lines.append(_sample(name, _parse_label_key(key),
                                     entry["series"][key]))
    return "\n".join(lines) + ("\n" if lines else "")


def _sample(name: str, labels: List[Tuple[str, str]], value: float) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in labels)
        return f"{name}{{{body}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


def snapshot_to_json(snapshot: Dict) -> str:
    """Canonical JSON encoding (sorted keys, no whitespace drift) — the
    bitwise-determinism surface metrics_snapshot() tests pin."""
    return json.dumps(snapshot, sort_keys=True, separators=(",", ":"))


# --- process default registry ---------------------------------------------

_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT


def reset_default_registry() -> None:
    """Testing hook: drop the process-default registry's contents."""
    default_registry().reset()

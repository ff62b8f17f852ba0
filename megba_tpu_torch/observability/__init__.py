"""Solve observability: the per-iteration trace (trace.py), the verbose
output (emit.py), the JSONL `SolveReport` telemetry (report.py) and its
reader (summarize.py, `python -m megba_tpu_torch.observability.summarize`),
and the observability plane, off by default:

- `metrics`: a process-local counter / gauge / histogram registry with
  Prometheus text and JSON snapshots (`MEGBA_METRICS=1` or
  `ProblemOption(metrics=True)`);
- `spans`: request-scoped spans exported as Chrome / Perfetto trace JSON
  (`MEGBA_TRACE=1`);
- `flight`: a bounded ring of structured service events, dumped as JSONL
  (`MEGBA_FLIGHT=<path>`).

Consumers go through the three gates below (the JAX package's
`observability/__init__.py:77-108`): one environment lookup when the
plane is off, a lazy import when it is on.  `report`, `summarize`,
`metrics`, `spans` and `flight` load on first use, so a solve with
telemetry and the plane off imports none of them.
"""

import os

from megba_tpu_torch.observability.emit import (
    emit_problem_stats,
    emit_verbose_iteration,
    next_verbose_token,
)
from megba_tpu_torch.observability.trace import SolveTrace, trace_to_dict

__all__ = ["SolveReport", "SolveTrace", "append_report", "build_report",
           "emit_problem_stats", "emit_verbose_iteration",
           "flight_recorder", "metrics_registry", "next_verbose_token",
           "span_recorder", "trace_to_dict"]

_LAZY = {"SolveReport", "append_report", "build_report"}


def __getattr__(name):
    if name in _LAZY:
        from megba_tpu_torch.observability import report

        return getattr(report, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def metrics_registry(enabled: bool = False):
    """The process-default MetricsRegistry, or None when the plane is off.

    Armed by `MEGBA_METRICS` (any non-empty value) or `enabled=True` (the
    resolved `ProblemOption.metrics` knob).  Off, this is one environment
    lookup and never imports `metrics`."""
    if not (enabled or os.environ.get("MEGBA_METRICS")):
        return None
    from megba_tpu_torch.observability import metrics

    return metrics.default_registry()


def span_recorder(enabled: bool = False):
    """The process-default SpanRecorder, or None (armed by MEGBA_TRACE)."""
    if not (enabled or os.environ.get("MEGBA_TRACE")):
        return None
    from megba_tpu_torch.observability import spans

    return spans.default_recorder()


def flight_recorder(enabled: bool = False):
    """The process-default FlightRecorder, or None (armed by MEGBA_FLIGHT)."""
    if not (enabled or os.environ.get("MEGBA_FLIGHT")):
        return None
    from megba_tpu_torch.observability import flight

    return flight.default_recorder()

"""Request-scoped spans, exported as a Chrome / Perfetto trace.

Counterpart of `megba_tpu/observability/spans.py` (schema
`megba_tpu.spans/v1`, the same span and trace-event fields):

- :class:`SpanRecorder` records completed spans per process
  (thread-safe, bounded by `_MAX_SPANS`).  The active span context lives
  in a ``threading.local`` stack, so nested ``with recorder.span(...)``
  blocks become parent and child.
- A trace context (``trace_id`` + parent ``span_id``) is a plain dict
  (:meth:`SpanRecorder.context`); :meth:`SpanRecorder.adopt` grafts a
  span under a context taken elsewhere, and :meth:`SpanRecorder.ingest`
  merges spans drained from another recorder.
- :func:`to_chrome_trace` exports span dicts as Chrome / Perfetto
  trace-event JSON (``ph: "X"`` complete events, µs timestamps, one
  ``process_name`` record per pid).
- PhaseTimer phases join as child spans through
  ``utils.timing.set_phase_hook`` (:func:`install_phase_hook`), so the
  lowering / plan / dispatch / execute breakdown nests under the span
  that caused it.

Timestamps are wall-clock µs; durations come from the same reads.

Off by default behind ``MEGBA_TRACE``; consumers reach it through the
lazy ``observability.span_recorder()`` gate.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

SCHEMA = "megba_tpu.spans/v1"

_MAX_SPANS = 65536  # bounded: a leaked recorder must not grow unbounded


def _new_id() -> str:
    return os.urandom(8).hex()


def now_us() -> float:
    return time.time() * 1e6


class _Ctx(threading.local):
    def __init__(self):
        self.stack: List[Dict] = []


class SpanRecorder:
    """Process-local recorder of completed spans."""

    def __init__(self, process_name: Optional[str] = None):
        self._lock = threading.Lock()
        self._spans: List[Dict] = []  # megba: guarded-by(_lock)
        self._ctx = _Ctx()  # threading.local: per-thread, needs no lock
        self.pid = os.getpid()
        self.process_name = process_name or (
            os.environ.get("MEGBA_FEDERATION_WORKER") or "router")

    # -- context propagation ------------------------------------------------

    def context(self) -> Optional[Dict[str, str]]:
        """Wire form of the ACTIVE span context (None outside any span).

        The returned dict rides an RPC frame; the receiving process
        passes it to :meth:`adopt` so its spans join the same trace.
        """
        if not self._ctx.stack:
            return None
        top = self._ctx.stack[-1]
        return {"trace_id": top["trace_id"], "span_id": top["span_id"]}

    def span(self, name: str, ctx: Optional[Dict[str, str]] = None, **args):
        """Context manager recording one complete span.

        ``ctx`` (a :meth:`context` dict from another process) grafts the
        span under a remote parent; otherwise the parent is the
        innermost active local span, and a fresh trace id is minted at
        the root.
        """
        return _SpanScope(self, name, ctx, args)

    def adopt(self, name: str, ctx: Optional[Dict[str, str]], **args):
        """Alias of :meth:`span` that reads as 'join the remote trace'."""
        return _SpanScope(self, name, ctx, args)

    # -- phase-hook integration ---------------------------------------------

    def record_phase(self, name: str, duration_s: float) -> None:
        """Attach a just-finished PhaseTimer phase as a child span that
        ENDS now (phases only report durations on exit)."""
        end = now_us()
        parent = self._ctx.stack[-1] if self._ctx.stack else None
        span = {
            "name": f"phase.{name}",
            "trace_id": parent["trace_id"] if parent else _new_id(),
            "span_id": _new_id(),
            "parent_id": parent["span_id"] if parent else None,
            "ts_us": end - duration_s * 1e6,
            "dur_us": duration_s * 1e6,
            "pid": self.pid,
            "process": self.process_name,
            "tid": threading.get_ident(),
            "args": {},
        }
        self._append(span)

    # -- collection ---------------------------------------------------------

    def _append(self, span: Dict) -> None:
        with self._lock:
            if len(self._spans) < _MAX_SPANS:
                self._spans.append(span)

    def ingest(self, spans: List[Dict]) -> None:
        """Merge spans drained from another process (worker replies)."""
        for s in spans or []:
            self._append(dict(s))

    def drain(self) -> List[Dict]:
        with self._lock:
            out, self._spans = self._spans, []
            return out

    def spans(self) -> List[Dict]:
        with self._lock:
            return list(self._spans)


class _SpanScope:
    def __init__(self, recorder: SpanRecorder, name: str,
                 ctx: Optional[Dict[str, str]], args: Dict):
        self._r = recorder
        self._name = name
        self._remote = ctx
        self._args = {k: str(v) for k, v in args.items()}
        self.span: Optional[Dict] = None

    def __enter__(self):
        stack = self._r._ctx.stack
        if self._remote:
            trace_id = self._remote["trace_id"]
            parent_id = self._remote.get("span_id")
        elif stack:
            trace_id = stack[-1]["trace_id"]
            parent_id = stack[-1]["span_id"]
        else:
            trace_id = _new_id()
            parent_id = None
        self.span = {
            "name": self._name,
            "trace_id": trace_id,
            "span_id": _new_id(),
            "parent_id": parent_id,
            "ts_us": now_us(),
            "dur_us": 0.0,
            "pid": self._r.pid,
            "process": self._r.process_name,
            "tid": threading.get_ident(),
            "args": self._args,
        }
        stack.append(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        self.span["dur_us"] = max(0.0, now_us() - self.span["ts_us"])
        if exc_type is not None:
            self.span["args"]["error"] = exc_type.__name__
        stack = self._r._ctx.stack
        if stack and stack[-1] is self.span:
            stack.pop()
        self._r._append(self.span)
        return False


def install_phase_hook(recorder: SpanRecorder) -> None:
    """Route completed PhaseTimer phases into `recorder` as child spans."""
    from megba_tpu_torch.utils import timing

    timing.set_phase_hook(recorder.record_phase)


def to_chrome_trace(spans: List[Dict]) -> Dict:
    """Chrome/Perfetto trace-event JSON (the ``chrome://tracing`` load
    format): one ``ph: "X"`` complete event per span plus
    ``process_name`` metadata per pid, so a merged multi-process fleet
    solve renders with every worker as its own named track."""
    events = []
    seen_pids: Dict[int, str] = {}
    for s in sorted(spans, key=lambda s: (s["ts_us"], s["span_id"])):
        pid = int(s.get("pid", 0))
        if pid not in seen_pids:
            seen_pids[pid] = str(s.get("process", pid))
            events.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": seen_pids[pid]},
            })
        args = dict(s.get("args", {}))
        args["trace_id"] = s["trace_id"]
        args["span_id"] = s["span_id"]
        if s.get("parent_id"):
            args["parent_id"] = s["parent_id"]
        events.append({
            "ph": "X",
            "name": s["name"],
            "cat": "megba",
            "ts": s["ts_us"],
            "dur": s["dur_us"],
            "pid": pid,
            "tid": int(s.get("tid", 0)) % (1 << 31),
            "args": args,
        })
    return {"schema": SCHEMA, "displayTimeUnit": "ms",
            "traceEvents": events}


def write_chrome_trace(path: str, spans: List[Dict]) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(to_chrome_trace(spans), fh)


# --- process default recorder ----------------------------------------------

_DEFAULT: Optional[SpanRecorder] = None
_DEFAULT_LOCK = threading.Lock()


def default_recorder() -> SpanRecorder:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = SpanRecorder()
            # Armed processes get PhaseTimer phases as child spans for
            # free: the lowering/program/dispatch/execute breakdown
            # nests under whatever request span is active.
            install_phase_hook(_DEFAULT)
        return _DEFAULT


def reset_default_recorder() -> None:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is not None:
            from megba_tpu_torch.utils import timing

            timing.set_phase_hook(None)
        _DEFAULT = None

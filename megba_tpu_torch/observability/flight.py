"""Flight recorder: a bounded ring of structured events.

Counterpart of `megba_tpu/observability/flight.py` (schema
`megba_tpu.flight/v1`).  A process keeps its last N structured events
(dispatch chaos injections, circuit-breaker transitions, queue sheds,
escalation retries, dispatch failures) in a fixed-size ring, and a dump
writes the ring as one JSONL line, so a post-mortem carries what the
service was doing before a fault, not just the fault.

Event shape: ``{"t_unix": <wall s>, "seq": <monotone int>, "kind":
<str>, ...fields}``.  The ring is bounded (default 256 events) and
recording is a deque append under a lock.  Off by default behind
``MEGBA_FLIGHT`` (the value is the dump path), reached through the lazy
``observability.flight_recorder()`` gate.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

SCHEMA = "megba_tpu.flight/v1"

DEFAULT_CAPACITY = 256


class FlightRecorder:
    """Thread-safe bounded ring buffer of structured events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 process_name: Optional[str] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.process_name = process_name or (
            os.environ.get("MEGBA_FEDERATION_WORKER") or "router")
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=capacity)  # megba: guarded-by(_lock)
        self._seq = 0  # megba: guarded-by(_lock)
        self._dropped = 0  # megba: guarded-by(_lock)

    def record(self, kind: str, **fields) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._seq += 1
            event = {"t_unix": time.time(), "seq": self._seq, "kind": kind}
            event.update(fields)
            self._ring.append(event)

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._dropped = 0

    def dump_dict(self, reason: str = "") -> Dict:
        with self._lock:
            return {
                "schema": SCHEMA,
                "process": self.process_name,
                "pid": os.getpid(),
                "reason": reason,
                "dropped": self._dropped,
                "dumped_unix": time.time(),
                "events": list(self._ring),
            }

    def dump(self, path: str, reason: str = "") -> str:
        """Append one JSONL dump line to `path`; returns the path.

        Append-mode JSONL on purpose: N surviving processes dumping on
        the same loss each land their own line instead of clobbering
        each other (the sink discipline SolveReport already uses).
        """
        payload = self.dump_dict(reason=reason)
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(payload, sort_keys=True) + "\n")
        return path


def load_dumps(path: str) -> List[Dict]:
    """Parse a JSONL flight-dump file (skips malformed lines — a dump
    raced by a dying process must not poison the post-mortem)."""
    out = []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and rec.get("schema") == SCHEMA:
                    out.append(rec)
    except FileNotFoundError:
        pass
    return out


# --- process default recorder ----------------------------------------------

_DEFAULT: Optional[FlightRecorder] = None
_DEFAULT_LOCK = threading.Lock()


def default_recorder() -> FlightRecorder:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = FlightRecorder()
        return _DEFAULT


def reset_default_recorder() -> None:
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = None


def dump_path() -> Optional[str]:
    """The armed dump path (the MEGBA_FLIGHT value), or None."""
    return os.environ.get("MEGBA_FLIGHT") or None


def dump_default(reason: str = "") -> Optional[str]:
    """Dump the process-default ring to the armed path; best-effort (the
    caller is usually a dying process or a loss handler — a failed dump
    must never mask the original fault)."""
    path = dump_path()
    if not path:
        return None
    try:
        return default_recorder().dump(path, reason=reason)
    except OSError:
        return None

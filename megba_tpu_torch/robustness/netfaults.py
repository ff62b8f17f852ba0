"""Deterministic network fault injection for the federation transport.

Counterpart of `megba_tpu/robustness/netfaults.py`: the same plan, the
same decision streams for the same seeds, the same events.

`ChaosTcpProxy` is an in-process TCP proxy that sits between a
`FleetRouter` and its workers (point the router's `advertise` address,
or a worker's `--connect`, at the proxy) and injects faults by SEEDED
plan — the same `NetFaultPlan` always produces the same fault sequence
on the same connection order, so a chaos smoke is a regression test,
not a flake generator.

Fault families, chosen to exercise each typed failure the transport
layer promises (serving/transport.py):

- **drop**: the connection is severed abruptly mid-stream — the peer
  sees EOF/ECONNRESET and enters the reconnect window.
- **delay**: a chunk is forwarded late — exercises heartbeat-silence
  detection (`_ConnSuspect`) without actually losing the link.
- **truncate**: a PREFIX of a chunk is forwarded, then the connection
  is severed — the peer's codec raises `FrameTruncatedError` naming
  got/need bytes (never unpickles garbage).
- **reorder**: a chunk is held and forwarded after its successor —
  byte-stream corruption, surfacing as `FrameMagicError` or
  `FrameDigestError` downstream.
- **partition**: `partition()` severs every live connection and
  refuses new ones (accept-then-close, the router keeps seeing a
  listening port — a network partition, not a dead host) until
  `heal()`.

Every injected fault is appended to `proxy.events` for assertions.

Decisions draw from `np.random.default_rng(SeedSequence([seed,
conn_index, direction]))`: per-connection, per-direction streams, so
adding a fault family or a connection does not shift any other
stream's decisions.

The proxy reads no clock: it needs only `time.sleep` for the delay
fault.
"""

from __future__ import annotations

import contextlib
import dataclasses
import socket
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np

from megba_tpu_torch.serving.transport import parse_address

_CHUNK = 1 << 16


@dataclasses.dataclass(frozen=True)
class NetFaultPlan:
    """Seeded per-chunk fault probabilities for one proxy.

    Rates are per forwarded chunk and cascade in order drop →
    truncate → reorder → delay (at most one fault per chunk).  The
    default plan is CLEAN — a proxy with `NetFaultPlan()` is a
    transparent relay, the control arm of any chaos experiment.
    """

    seed: int = 0
    drop_rate: float = 0.0
    truncate_rate: float = 0.0
    reorder_rate: float = 0.0
    delay_rate: float = 0.0
    delay_s: float = 0.05

    def __post_init__(self) -> None:
        for name in ("drop_rate", "truncate_rate", "reorder_rate",
                     "delay_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")

    def rng(self, conn_index: int, direction: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            [self.seed, conn_index, direction]))


class ChaosTcpProxy:
    """Deterministic in-process TCP proxy (see module docstring).

    Listens on 127.0.0.1 (ephemeral port, read `address`), dials
    `upstream` once per accepted connection, and pumps bytes both ways
    through the fault plan.  Use as a context manager or call
    `close()`.
    """

    def __init__(self, upstream: str,
                 plan: Optional[NetFaultPlan] = None) -> None:
        self.upstream = parse_address(upstream)
        self.plan = plan or NetFaultPlan()
        self._lock = threading.Lock()
        self._partitioned = False  # guarded by _lock
        self._closing = False  # guarded by _lock
        self._conns: List[socket.socket] = []  # guarded by _lock
        self.events: List[Tuple[Any, ...]] = []  # guarded by _lock
        self._nconn = 0  # guarded by _lock; connection index
        self._pumps: List[threading.Thread] = []  # guarded by _lock
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(64)
        lsock.settimeout(0.2)  # accept slices re-check the closing flag
        self._lsock = lsock
        bound = lsock.getsockname()
        self.address = f"{bound[0]}:{bound[1]}"
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="megba-chaos-accept")
        self._accept_thread.start()

    # -- fault control ---------------------------------------------------
    def _record(self, *event: Any) -> None:
        with self._lock:
            self.events.append(event)

    def partition(self) -> None:
        """Sever every live connection and refuse new ones until
        `heal()` — the port stays open (a partition, not a death)."""
        with self._lock:
            self._partitioned = True
            conns, self._conns = self._conns, []
            self.events.append(("partition", len(conns)))
        for s in conns:
            _kill_socket(s)

    def heal(self) -> None:
        with self._lock:
            self._partitioned = False
            self.events.append(("heal",))

    def event_counts(self) -> dict:
        with self._lock:
            counts: dict = {}
            for ev in self.events:
                counts[ev[0]] = counts.get(ev[0], 0) + 1
            return counts

    def close(self) -> None:
        with self._lock:
            if self._closing:
                return
            self._closing = True
            conns, self._conns = self._conns, []
            pumps = list(self._pumps)
        try:
            self._lsock.close()
        except OSError:
            pass
        for s in conns:
            _kill_socket(s)
        self._accept_thread.join(timeout=5.0)
        for t in pumps:
            t.join(timeout=5.0)

    def __enter__(self) -> "ChaosTcpProxy":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- relay machinery -------------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                down, _peer = self._lsock.accept()
            except TimeoutError:
                continue
            except OSError:
                return  # listener closed
            with self._lock:
                if self._closing:
                    _kill_socket(down)
                    return
                refused = self._partitioned
                idx = self._nconn
                self._nconn += 1
            if refused:
                self._record("refused", idx)
                _kill_socket(down)
                continue
            try:
                up = socket.create_connection(self.upstream, timeout=5.0)
                up.settimeout(None)
            except OSError:
                self._record("upstream_unreachable", idx)
                _kill_socket(down)
                continue
            self._record("accept", idx)
            with self._lock:
                if self._closing or self._partitioned:
                    pair: List[socket.socket] = []
                else:
                    self._conns.extend((down, up))
                    pair = [down, up]
            if not pair:
                _kill_socket(down)
                _kill_socket(up)
                continue
            for direction, (src, dst) in enumerate(((down, up),
                                                    (up, down))):
                t = threading.Thread(
                    target=self._pump,
                    args=(src, dst, idx, direction), daemon=True,
                    name=f"megba-chaos-pump-{idx}-{direction}")
                with self._lock:
                    self._pumps.append(t)
                t.start()

    def _pump(self, src: socket.socket, dst: socket.socket,
              idx: int, direction: int) -> None:
        rng = self.plan.rng(idx, direction)
        plan = self.plan
        held: Optional[bytes] = None
        try:
            while True:
                try:
                    chunk = src.recv(_CHUNK)
                except OSError:
                    break
                if not chunk:
                    break
                u = float(rng.random())
                if u < plan.drop_rate:
                    self._record("drop", idx, direction)
                    break
                u -= plan.drop_rate
                if u < plan.truncate_rate and len(chunk) > 1:
                    self._record("truncate", idx, direction,
                                 len(chunk) // 2, len(chunk))
                    with contextlib.suppress(OSError):
                        dst.sendall(chunk[:len(chunk) // 2])
                    break
                u -= plan.truncate_rate
                if u < plan.reorder_rate and held is None:
                    # Hold this chunk; it goes out AFTER its successor.
                    self._record("reorder", idx, direction)
                    held = chunk
                    continue
                u -= plan.reorder_rate
                if u < plan.delay_rate and plan.delay_s > 0:
                    self._record("delay", idx, direction)
                    time.sleep(plan.delay_s)
                try:
                    dst.sendall(chunk)
                    if held is not None:
                        dst.sendall(held)
                        held = None
                except OSError:
                    break
        finally:
            _kill_socket(src)
            _kill_socket(dst)


def _kill_socket(s: socket.socket) -> None:
    try:
        s.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        s.close()
    except OSError:
        pass

"""Liveness for multi-process runs: per-rank heartbeat files.

Counterpart of the first half of `megba_tpu/robustness/elastic.py`:
`RankState` and `HeartbeatBoard`, which the federation tier's pipe
topology uses for worker liveness (serving/federation.py beside
serving/worker.py).  Each worker beats a counter file under a shared
directory; the router classifies every peer by how long its own clock
has gone without seeing that counter change, so clocks are never
compared across processes.

The rest of the JAX module (`ElasticMonitor`, the `CollectiveWatchdog`,
`resume_elastic`, the shrink-world path) waits for the multi-host slice
of the port.
"""

from __future__ import annotations

import enum
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional


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

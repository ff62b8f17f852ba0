"""Timing hooks: the clock helpers, the phase timer and the profiler.

Counterpart of `megba_tpu/utils/timing.py`.  `PhaseTimer` collects named
phase timings; a phase syncs the card only on the outputs registered
with its handle, so an unsynced phase measures the host's enqueue.  Each
phase is also a `torch.profiler.record_function` range
(`megba.phase.<name>`), so the phase breakdown and a profiler timeline
line up.  `trace_profile(logdir)` is the JAX package's profiler context:
a `torch.profiler.profile` that writes a Chrome trace into `logdir`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Callable, Dict, Optional

import torch


def monotonic_s() -> float:
    """Monotonic seconds for measuring durations (never wall clock)."""
    return time.perf_counter()


def wall_unix() -> float:
    """Unix wall-clock seconds, for report timestamps only — never for
    durations (NTP steps make wall-clock deltas lie)."""
    return time.time()


# Optional observer of completed PhaseTimer phases, signature
# (name, duration_s).  Exceptions are swallowed: telemetry must never
# fail a solve.
_PHASE_HOOK: Optional[Callable[[str, float], None]] = None


def set_phase_hook(hook: Optional[Callable[[str, float], None]]) -> None:
    global _PHASE_HOOK
    _PHASE_HOOK = hook


def _block_until_ready(x) -> None:
    """Synchronise the card of every CUDA tensor in `x` (a tensor or a
    nest of tuples, lists and dicts of them)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _block_until_ready(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _block_until_ready(v)


class _Phase:
    """Handle yielded by PhaseTimer.phase; register outputs to sync on."""

    def __init__(self):
        self._targets = []

    def sync(self, x):
        """Mark `x` (tensors produced inside the block) to be synchronised
        before the phase's clock stops; returns x."""
        self._targets.append(x)
        return x


class PhaseTimer:
    """Accumulates wall-clock per named phase; device-sync aware.

    CUDA launches are asynchronous, so an un-synced phase measures only
    the enqueue.  Register the block's outputs on the yielded handle:

        with timer.phase("pcg") as ph:
            out = ph.sync(pcg_solve(...))
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        handle = _Phase()
        with torch.profiler.record_function(f"megba.phase.{name}"):
            t0 = time.perf_counter()
            try:
                yield handle
            finally:
                for t in handle._targets:
                    _block_until_ready(t)
                dt = time.perf_counter() - t0
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1
                if _PHASE_HOOK is not None:
                    try:
                        _PHASE_HOOK(name, dt)
                    except Exception:
                        pass

    def count_event(self, name: str, n: int = 1) -> None:
        """Count an instantaneous event (zero duration), e.g. a triage
        repair counter: it shows in `as_dict()` / `report()` with
        total_s 0.0 and `calls` the occurrence count."""
        self.totals.setdefault(name, 0.0)
        self.counts[name] = self.counts.get(name, 0) + n

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        """{name: {total_s, calls}}."""
        return {name: {"total_s": self.totals[name],
                       "calls": self.counts[name]}
                for name in self.totals}

    def reset(self) -> None:
        """Drop all accumulated phases (reuse one timer across solves)."""
        self.totals.clear()
        self.counts.clear()

    def report(self) -> str:
        if not self.totals:
            return "no phases recorded"
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name}: {t * 1e3:.1f} ms total / {c} calls = "
                         f"{t / c * 1e3:.2f} ms")
        total = sum(self.totals.values())
        lines.append(
            f"total: {total * 1e3:.1f} ms over {len(self.totals)} phases")
        return "\n".join(lines)


_TRACE_SEQ = itertools.count()


@contextlib.contextmanager
def trace_profile(logdir: Optional[str]):
    """torch.profiler trace context; no-op (yields None) when `logdir` is
    None.  Profiles the host and, when a card is present, its CUDA
    activity (the kernels' launches by their symbol names), and writes
    one Chrome trace, `trace-<pid>-<n>.json`, into `logdir` (created if
    missing) when the block ends; yields the profiler, whose
    `key_averages()` the caller may read.  The PhaseTimer phases of the
    block show as `megba.phase.<name>` ranges."""
    if logdir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"trace-{os.getpid()}-{next(_TRACE_SEQ)}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)

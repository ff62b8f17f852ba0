"""Runtime rebuild sentinel: count rebuilds per (site, signature).

Counterpart of `megba_tpu/analysis/retrace.py`.  The port compiles no
program, so what it can "recompile" is what it builds on first use:

- a kernel library: `ops/kernels.load_library` notes site
  ``"kernel_build"`` when it starts `nvcc` for a library and
  ``"kernel_load"`` when it loads one into the process (built here, or
  installed from an artifact by serving/artifacts), the library's digest
  file name as the signature;
- a host plan: `ops/segtiles._cached` notes site ``"plan:<kind>"`` on a
  plan-cache miss (kind: single, sharded, mesh2d, ...), a digest of the
  cache key as the signature.

A repeat of an identical solve builds nothing and misses nothing, so it
notes nothing.  `RetraceSentinel` wraps a window and fails it on:

- a *duplicate*: the same (site, signature) noted twice, or noted in the
  window after being noted before it (an evicted plan rebuilt, a library
  built twice);
- more new notes than `max_compiles` allows (per window, optionally only
  at the given `sites`).

Standard library only: the hooks in the solver's modules cost one dict
update on a miss and nothing on a hit.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Tuple

_LOCK = threading.Lock()
# (site, static, signature) -> notes, process lifetime (the JAX key's
# shape; the port's static part is always "").
_COUNTS: Dict[Tuple[str, str, str], int] = {}


class RetraceError(AssertionError):
    """An unexpected rebuild (a cache bust or an unstable signature)."""


def note_build(site: str, signature: str) -> None:
    """Record one build (or first load, or plan-cache miss) of `site`
    with `signature`."""
    key = (str(site), "", str(signature))
    with _LOCK:
        _COUNTS[key] = _COUNTS.get(key, 0) + 1


def snapshot() -> Dict[Tuple[str, str, str], int]:
    with _LOCK:
        return dict(_COUNTS)


def site_totals(sites: Optional[Iterable[str]] = None) -> Dict[str, int]:
    """Notes per site over the process's lifetime (only `sites` if
    given)."""
    want = None if sites is None else set(sites)
    out: Dict[str, int] = {}
    for (site, _, _), n in snapshot().items():
        if want is None or site in want or any(
                site.startswith(w + ":") for w in want):
            out[site] = out.get(site, 0) + n
    return out


class RetraceSentinel:
    """Context manager guarding a window against unexpected rebuilds.
    `sites` limits the window to those sites (a name or a "plan" prefix
    for every "plan:<kind>")."""

    def __init__(self, max_compiles: Optional[int] = None,
                 sites: Optional[Iterable[str]] = None) -> None:
        self.max_compiles = max_compiles
        self.sites = None if sites is None else tuple(sites)
        self._allowed_duplicates = 0
        self._allowed_extra = 0
        self._base: Dict[Tuple[str, str, str], int] = {}

    def allow(self, duplicates: int = 0, extra_compiles: int = 0) -> None:
        """Raise the window's tolerance."""
        self._allowed_duplicates += duplicates
        self._allowed_extra += extra_compiles

    def _watched(self, site: str) -> bool:
        return self.sites is None or any(
            site == s or site.startswith(s + ":") for s in self.sites)

    def new_compiles(self) -> Dict[Tuple[str, str, str], int]:
        """(site, static, signature) -> notes since the window opened."""
        now = snapshot()
        return {k: v - self._base.get(k, 0) for k, v in now.items()
                if v > self._base.get(k, 0) and self._watched(k[0])}

    def total_new(self) -> int:
        return sum(self.new_compiles().values())

    def duplicates(self):
        """Signatures noted more than once within the window, or noted
        in the window after being noted before it."""
        out = []
        for key, delta in self.new_compiles().items():
            before = self._base.get(key, 0)
            if delta + min(before, 1) > 1:
                out.append((key, delta))
        return out

    def __enter__(self) -> "RetraceSentinel":
        self._base = snapshot()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            return  # don't mask the real failure
        self.check()

    def check(self) -> None:
        dups = self.duplicates()
        if len(dups) > self._allowed_duplicates:
            lines = "\n".join(f"  {site} sig={sig} built +{delta}x"
                              for (site, _, sig), delta in dups)
            raise RetraceError(
                "unexpected rebuild — identical (site, signature) built "
                "more than once (an evicted plan or a library rebuilt):\n"
                + lines)
        total = self.total_new()
        budget = (None if self.max_compiles is None
                  else self.max_compiles + self._allowed_extra)
        if budget is not None and total > budget:
            lines = "\n".join(f"  {site} sig={sig} x{delta}"
                              for (site, _, sig), delta
                              in sorted(self.new_compiles().items()))
            raise RetraceError(
                f"{total} new builds in the window (budget {budget}):\n"
                + lines)


def sentinel(max_compiles: Optional[int] = None,
             sites: Optional[Iterable[str]] = None) -> RetraceSentinel:
    """A fresh sentinel window (use as a context manager)."""
    return RetraceSentinel(max_compiles=max_compiles, sites=sites)

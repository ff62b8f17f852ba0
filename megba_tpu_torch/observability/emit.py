"""Single home of the solver's human-readable output.

Counterpart of `megba_tpu/observability/emit.py`, with its formats: the
per-iteration verbose line of the BA and PGO loops (the format the JAX
package's `utils/curves` parses) and the problem-stats line `solve_bal`
prints.  The port's loops are host-driven, so a line is a plain call.

The per-solve verbose clocks live here too: host start times keyed by a
per-solve token (`next_verbose_token`).  Iteration 0's line starts that
solve's clock, so it prints `elapsed 0.0 ms`; the table is pruned by
LAST-TOUCH time, so a long solve that keeps printing never loses its
clock to a burst of short ones.
"""

from __future__ import annotations

import itertools
import time

import numpy as np

# token -> [t0, last_touch] (host perf_counter seconds).
_VERBOSE_CLOCKS: dict = {}
_MAX_CLOCKS = 64

# Monotonic per-solve token source.  count().__next__ is atomic under
# the GIL, so concurrent solves never share a token.
next_verbose_token = itertools.count(1).__next__


def _emit_verbose_line(token, k, c, a, p):
    now = time.perf_counter()
    token = int(token)
    entry = _VERBOSE_CLOCKS.get(token)
    if int(k) == 0 or entry is None:
        while len(_VERBOSE_CLOCKS) >= _MAX_CLOCKS:
            # Evict the least-recently-touched clock; never clear() —
            # that would wipe live solves' clocks.
            stalest = min(_VERBOSE_CLOCKS,
                          key=lambda t: _VERBOSE_CLOCKS[t][1])
            _VERBOSE_CLOCKS.pop(stalest)
        entry = _VERBOSE_CLOCKS[token] = [now, now]
    else:
        entry[1] = now
    dt = (now - entry[0]) * 1e3
    # Format contract: the JAX package's utils/curves._LINE parses this.
    print(
        f"iter {int(k)}: cost {float(c):.6e} "
        f"log10 {np.log10(max(float(c), 1e-300)):.3f} "
        f"accept {bool(a)} pcg_iters {int(p)} "
        f"elapsed {dt:.1f} ms", flush=True)


def emit_verbose_iteration(token, k, cost, accept, pcg_iters) -> None:
    """Print one per-iteration line (cost, log10 cost, accept, PCG
    iterations, elapsed ms since this solve's iteration 0, keyed by the
    solve's `token`).  Shared by the BA and PGO loops."""
    _emit_verbose_line(token, k, cost, accept, pcg_iters)


def emit_problem_stats(num_cameras, num_points, num_observations,
                       max_cam_degree, max_pt_degree, hpl_blocks):
    """The verbose problem-stats line (solve_bal's pre-solve summary)."""
    print(
        f"problem: {num_cameras} cameras, {num_points} points, "
        f"{num_observations} observations | max camera degree "
        f"{max_cam_degree}, max point degree {max_pt_degree}, Hpl blocks "
        f"{hpl_blocks if hpl_blocks >= 0 else 'n/a (edges unsorted)'}",
        flush=True)

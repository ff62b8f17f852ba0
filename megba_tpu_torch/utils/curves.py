"""Capture and parse the LM solver's verbose per-iteration lines.

Counterpart of `megba_tpu/utils/curves.py`.  The per-iteration `iter k:
cost ...` line (observability/emit.py, the JAX package's format since
the port's verbose lines were ported) is the source of the cost-curve
evidence: one shared parser keeps the scripts that read it in lockstep
with the emit format, so a format drift raises here instead of silently
producing empty curves.  The port's loops are host-driven, so every line
is printed before the solve returns; `run_with_curve` still waits for
the card before it parses.
"""

from __future__ import annotations

import contextlib
import io
import re
import sys
from typing import Callable, Optional

# The cost group matches nan/inf too: a diverged run's iterations must
# stay visible in the parsed curve instead of vanishing.
_LINE = re.compile(
    r"iter (\d+): cost (-?(?:[0-9.eE+-]+|nan|inf)) .*accept (True|False) "
    r"pcg_iters (\d+)")


def parse_verbose_curve(text: str, require: bool = True) -> list[dict]:
    """Verbose solver stdout -> [{iter, cost, accept, pcg_iters}, ...]."""
    curve = [
        {"iter": int(m.group(1)), "cost": float(m.group(2)),
         "accept": m.group(3) == "True", "pcg_iters": int(m.group(4))}
        for m in _LINE.finditer(text)]
    if require and not curve:
        raise ValueError(
            "no verbose iteration lines matched — did the solver's "
            "verbose format (observability/emit.py:_emit_verbose_line) "
            "change without updating utils/curves._LINE?")
    return curve


class _Tee(io.TextIOBase):
    """Buffer that also passes writes through to a live stream."""

    def __init__(self, passthrough):
        self.buf = io.StringIO()
        self._live = passthrough

    def write(self, s):
        self.buf.write(s)
        self._live.write(s)
        return len(s)

    def flush(self):
        self._live.flush()


def _synchronize(_result) -> None:
    """Wait for the card, if this process uses one."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def run_with_curve(fn: Callable[[], object],
                   block_on: Optional[Callable[[object], object]] = None,
                   tee: bool = False):
    """Run `fn` capturing stdout; return (result, curve).

    `block_on(result)` (default: synchronise the card, when the process
    uses one) runs INSIDE the capture.  `tee=True` additionally passes
    every line through to the real stdout as it is emitted — use it for
    long runs so a crash mid-solve still leaves the per-iteration
    forensics in the log instead of dying inside the buffer.
    """
    buf = _Tee(sys.stdout) if tee else io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
        (_synchronize if block_on is None else block_on)(result)
    text = buf.buf.getvalue() if tee else buf.getvalue()
    return result, parse_verbose_curve(text)


def dtype_parity_payload(solve_for, rel_tol, label="", block_on=None,
                         gap_tol=None):
    """The f64-vs-f32 parity protocol, defined once for every family.

    `solve_for(np_dtype)` runs one verbose solve and returns a result
    with cost/initial_cost/iterations/accepted/pcg_iterations fields
    (LMResult and PGOResult both qualify).  Runs f64 then f32, captures
    both curves, and returns the payload dict with the two runs, the
    final-cost relative difference, and the PER-ITERATION relative gaps
    over the common prefix of the two curves (the trajectories must
    track each other, not merely coincide at the optimum).

    Pass criterion: final relative difference <= `rel_tol` AND the
    maximum per-iteration gap <= `gap_tol` (default `100 * rel_tol`,
    two orders looser than the final-cost bar, because mid-trajectory
    f32 rounding legitimately wobbles before convergence pulls the
    curves together).  When the runs take different iteration counts
    the payload records `iterations_equal=False` and
    `curve_len_{f64,f32}` instead of silently zip-truncating the
    comparison.  The keys are the JAX package's.
    """
    import numpy as np

    from megba_tpu_torch.utils.timing import monotonic_s

    runs = {}
    for dtype in (np.float64, np.float32):
        t0 = monotonic_s()
        res, curve = run_with_curve(lambda: solve_for(dtype),
                                    block_on=block_on)
        elapsed = monotonic_s() - t0
        runs[np.dtype(dtype).name] = {
            "initial_cost": float(res.initial_cost),
            "final_cost": float(res.cost),
            "iterations": int(res.iterations),
            "accepted": int(res.accepted),
            "pcg_iterations": int(res.pcg_iterations),
            "elapsed_s": round(elapsed, 3),
            "curve": curve,
        }
        print(f"[{label}] {np.dtype(dtype).name}: "
              f"{float(res.initial_cost):.6e} -> {float(res.cost):.6e} "
              f"in {int(res.iterations)} iters ({elapsed:.1f}s)",
              flush=True)
    r64, r32 = runs["float64"], runs["float32"]
    gap_tol = 100.0 * rel_tol if gap_tol is None else gap_tol
    rel = abs(r32["final_cost"] - r64["final_cost"]) / max(
        r64["final_cost"], 1e-300)
    gaps = [
        abs(b["cost"] - a["cost"]) / max(abs(a["cost"]), 1e-300)
        for a, b in zip(r64["curve"], r32["curve"])]
    max_gap = max(gaps, default=0.0)
    payload = {
        "runs": runs,
        "final_rel_diff": rel,
        "curve_rel_gaps": gaps,
        "max_curve_rel_gap": max_gap,
        "iterations_equal": len(r64["curve"]) == len(r32["curve"]),
        "curve_len_f64": len(r64["curve"]),
        "curve_len_f32": len(r32["curve"]),
        "rel_tol": rel_tol,
        "gap_tol": gap_tol,
        "pass": bool(rel <= rel_tol and max_gap <= gap_tol),
    }
    print(f"[{label}] final rel diff {rel:.3e}, max curve gap "
          f"{max_gap:.3e} over {len(gaps)} common iters "
          f"({'PASS' if payload['pass'] else 'FAIL'} at rel_tol={rel_tol}, "
          f"gap_tol={gap_tol})",
          flush=True)
    return payload

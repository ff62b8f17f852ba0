"""Deterministic fault injection at the residual / linear-system boundary.

Counterpart of `megba_tpu/robustness/faults.py`; on an edge-sharded mesh
each shard carries the poison of its own edges (`fault_partition`).  A
`FaultPlan` carries two tensors and a window:

- `edge_nan` ([nE]): NaN at the poisoned edges, 0 elsewhere, added to
  their residual rows while the window is open: a transient data fault
  that poisons the cost, the gradient and every product built from them;
- `point_crush` ([Np]): 1 at the points whose Hll blocks are scaled by
  `_CRUSH` after the system build while the window is open: Hll^-1 blows
  up and the Schur complement goes indefinite while every scalar stays
  finite, the breakdown the guarded PCG detects.

Iteration stamps: a linearisation is stamped with the LM iteration whose
system it produces; the pre-loop linearisation and every evaluation at
carry k share stamp k, shifted into global iterations by `offset`.  The
window is the half-open global range [start, stop).  `window` and
`offset` are host integers, so whether the window is open is host
arithmetic (`fault_active`) and reads nothing from the device; a closed
window adds nothing.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One seeded fault: what to poison, and when (global LM iterations)."""

    edge_nan: torch.Tensor  # [nE]: NaN at poisoned edges, 0 elsewhere
    point_crush: torch.Tensor  # [Np]: 1 at points whose Hll is crushed
    window: Tuple[int, int]  # global-iteration [start, stop)
    offset: int = 0  # global iteration of local k = 0


# Hll crush factor: small enough that Hll^-1 dominates the Schur
# subtrahend (indefinite S), large enough that every f32 intermediate
# stays finite.
_CRUSH = 1e-8


def make_nan_burst(n_edges: int, edges: Sequence[int], start: int, stop: int,
                   n_points: int = 0, dtype=np.float32) -> FaultPlan:
    """NaN residual burst on `edges` for global iterations [start, stop)."""
    edge_nan = np.zeros((n_edges,), dtype)
    edge_nan[np.asarray(list(edges), np.int64)] = np.nan
    return FaultPlan(edge_nan=torch.from_numpy(edge_nan),
                     point_crush=torch.from_numpy(np.zeros((n_points,),
                                                           dtype)),
                     window=(int(start), int(stop)), offset=0)


def make_point_indefinite_burst(n_points: int, points: Sequence[int],
                                start: int, stop: int, n_edges: int = 0,
                                dtype=np.float32) -> FaultPlan:
    """Crush the Hll blocks of `points` for global iterations [start, stop).

    The crushed blocks invert to huge (finite) values, the Schur
    subtrahend Hpl Hll^-1 Hlp overwhelms Hpp, and S goes indefinite: the
    PCG guard's sign-flipped-delta breakdown, every scalar still finite.
    """
    crush = np.zeros((n_points,), dtype)
    crush[np.asarray(list(points), np.int64)] = 1.0
    return FaultPlan(edge_nan=torch.from_numpy(np.zeros((n_edges,), dtype)),
                     point_crush=torch.from_numpy(crush),
                     window=(int(start), int(stop)), offset=0)


def with_offset(plan: FaultPlan, offset: int) -> FaultPlan:
    """Shift the plan so local iteration 0 maps to global `offset`."""
    return dataclasses.replace(plan, offset=int(offset))


def inert_fault_plan(n_edges: int, n_points: int = 0,
                     dtype=np.float32) -> FaultPlan:
    """A plan whose window never opens: zero poison, window [0, 0)."""
    return FaultPlan(
        edge_nan=torch.from_numpy(np.zeros((n_edges,), dtype)),
        point_crush=torch.from_numpy(np.zeros((n_points,), dtype)),
        window=(0, 0), offset=0)


def close_fault_window(plan: FaultPlan) -> FaultPlan:
    """The plan with its window forced shut ([0, 0)): the unpoisoned
    control of a fault experiment."""
    return dataclasses.replace(plan, window=(0, 0))


def fault_active(plan: FaultPlan, k: int) -> bool:
    """Is the window open at local iteration k?  Host arithmetic."""
    g = int(k) + int(plan.offset)
    return int(plan.window[0]) <= g < int(plan.window[1])


def poison_residuals(r: torch.Tensor, plan: FaultPlan, k: int) -> torch.Tensor:
    """Add the edge poison to the [od, nE] residual rows while the window
    is open at iteration k; `r` itself otherwise."""
    if not fault_active(plan, k):
        return r
    return r + plan.edge_nan.to(r.dtype)[None, :]


def poison_system(system, plan: FaultPlan, k: int):
    """Crush the Hll rows of the planned points while the window is open.

    `system` is a linear_system.builder.SchurSystem.  A plan built
    without a point axis (a pure edge fault) leaves it alone.
    """
    if (plan.point_crush.shape[0] != system.Hll.shape[1]
            or not fault_active(plan, k)):
        return system
    dt = system.Hll.dtype
    crush = plan.point_crush.to(system.Hll.device)
    scale = torch.where(crush > 0, torch.tensor(_CRUSH, dtype=dt,
                                                device=crush.device),
                        torch.tensor(1.0, dtype=dt, device=crush.device))
    return dataclasses.replace(system, Hll=system.Hll * scale[None, :])


def lower_edge_vector(vec: np.ndarray, perm: Optional[np.ndarray] = None,
                      mask: Optional[np.ndarray] = None,
                      n_padded: Optional[int] = None) -> np.ndarray:
    """Apply a lowering's edge permutation / padding to a [nE] vector.

    Mirrors what flat_solve does to `obs`: an optional permutation into
    slot order, explicit zeroing of padding slots (np.where, never a
    multiply: 0 * NaN is NaN), and zero-padding up to `n_padded`.
    """
    v = np.asarray(vec)
    if perm is not None:
        v = v[np.asarray(perm)]
    if mask is not None:
        v = np.where(np.asarray(mask) > 0, v, np.zeros_like(v))
    if n_padded is not None and v.shape[0] < n_padded:
        v = np.concatenate([v, np.zeros((n_padded - v.shape[0],), v.dtype)])
    return np.ascontiguousarray(v)


def fault_partition(plan: FaultPlan, bounds: Sequence[int],
                    devices: Sequence[torch.device]) -> Tuple[FaultPlan, ...]:
    """Split a lowered plan over contiguous edge shards (JAX
    `fault_partition_specs`, faults.py:215): shard k's plan carries the
    poison of edges [bounds[k], bounds[k+1]) of the concatenated shard
    streams on devices[k]; the point mask, window and offset are
    replicated (the first shard's plan crushes the summed system)."""
    return tuple(
        dataclasses.replace(
            plan, edge_nan=plan.edge_nan[bounds[k]:bounds[k + 1]].to(d),
            point_crush=plan.point_crush.to(devices[0]))
        for k, d in enumerate(devices))


def lower_fault_plan(plan: FaultPlan, *, n_edges: int, n_points: int,
                     dtype, perm: Optional[np.ndarray] = None) -> FaultPlan:
    """Lower one plan onto a padded shape class (JAX faults.py:136-171):
    `edge_nan` takes the camera-sort permutation the problem's edges took
    (`perm`, from serving.shape_class.pad_to_class) and is zero-padded to
    the bucket's edge count; `point_crush` is zero-padded to its point
    count (padding points are fixed identity blocks).  A plan built
    without an edge or point axis lowers to zeros there."""
    edge = np.asarray(torch.as_tensor(plan.edge_nan).cpu()).astype(
        dtype, copy=False)
    if edge.shape[0] == 0:
        edge = np.zeros((n_edges,), dtype)
    else:
        edge = lower_edge_vector(edge, perm=perm, n_padded=n_edges)
    if edge.shape[0] != n_edges:
        raise ValueError(
            f"fault plan edge_nan has {np.asarray(plan.edge_nan).shape[0]} "
            f"edges; problem lowers to {n_edges}")
    crush = np.asarray(torch.as_tensor(plan.point_crush).cpu()).astype(
        dtype, copy=False)
    if crush.shape[0] > n_points:
        raise ValueError(
            f"fault plan point_crush has {crush.shape[0]} points; bucket "
            f"holds {n_points}")
    if crush.shape[0] < n_points:
        crush = np.concatenate(
            [crush, np.zeros((n_points - crush.shape[0],), dtype)])
    return FaultPlan(edge_nan=torch.from_numpy(edge),
                     point_crush=torch.from_numpy(crush),
                     window=(int(plan.window[0]), int(plan.window[1])),
                     offset=int(plan.offset))


def stack_fault_plans(plans: Sequence[FaultPlan]) -> FaultPlan:
    """Same-shape plans on a leading lane axis (JAX faults.py:174-185):
    `edge_nan` [L, nE], `point_crush` [L, Np], `window` an [L, 2] and
    `offset` an [L] host int32 array; each lane reads only its own
    rows."""
    if not plans:
        raise ValueError("stack_fault_plans needs at least one plan")
    return FaultPlan(
        edge_nan=torch.stack([torch.as_tensor(p.edge_nan) for p in plans]),
        point_crush=torch.stack([torch.as_tensor(p.point_crush)
                                 for p in plans]),
        window=np.asarray([[int(p.window[0]), int(p.window[1])]
                           for p in plans], np.int32),
        offset=np.asarray([int(p.offset) for p in plans], np.int32))


class InjectedDispatchError(RuntimeError):
    """The exception DispatchChaos raises: distinguishable from real
    dispatch failures in logs and assertions."""


@dataclasses.dataclass
class DispatchChaos:
    """Deterministic host-level chaos for the fleet dispatch path (JAX
    faults.py:237-308).

    The fleet queue's dispatcher calls `before_dispatch(bucket)` right
    after taking a batch; the hook raises `InjectedDispatchError` (the
    retry and circuit-breaker paths) or sleeps `delay_s` (deadline
    pressure).  `fail_first` fails the first N dispatches of every
    matching bucket; `fail_rate` also fails a seeded pseudo-random subset,
    one `np.random.default_rng` per bucket from (`seed`, bucket name), so
    a fixed submission order replays the same failures.  `buckets` (names
    as `str(ShapeClass)`) restricts the chaos; None means all.
    """

    fail_first: int = 0
    fail_rate: float = 0.0
    delay_s: float = 0.0
    seed: int = 0
    buckets: Optional[frozenset] = None

    def __post_init__(self) -> None:
        if not 0.0 <= self.fail_rate <= 1.0:
            raise ValueError(f"fail_rate must be in [0, 1], got "
                             f"{self.fail_rate}")
        if self.fail_first < 0 or self.delay_s < 0:
            raise ValueError("fail_first and delay_s must be >= 0")
        self._lock = threading.Lock()
        self._counts: dict = {}
        self._rngs: dict = {}

    def dispatches(self, bucket: str) -> int:
        """How many dispatches this bucket has seen."""
        with self._lock:
            return self._counts.get(bucket, 0)

    def before_dispatch(self, bucket: str) -> None:
        """Raises `InjectedDispatchError` when this dispatch of `bucket`
        is chosen to fail."""
        if self.buckets is not None and bucket not in self.buckets:
            return
        with self._lock:
            n = self._counts.get(bucket, 0)
            self._counts[bucket] = n + 1
            if self.fail_rate > 0.0:
                rng = self._rngs.get(bucket)
                if rng is None:
                    rng = np.random.default_rng(np.random.SeedSequence(
                        [self.seed, *bucket.encode()]))
                    self._rngs[bucket] = rng
                roll = float(rng.random())
            else:
                roll = 1.0
        if self.delay_s > 0.0:
            time.sleep(self.delay_s)
        if n < self.fail_first or roll < self.fail_rate:
            from megba_tpu_torch import observability as _obs

            flight = _obs.flight_recorder()
            if flight is not None:
                # Injected faults land in the flight ring like real ones:
                # a dump shows the chaos that drove it.
                flight.record("chaos_injection", bucket=bucket,
                              dispatch=n)
            raise InjectedDispatchError(
                f"chaos: injected dispatch failure #{n} for bucket "
                f"{bucket}")

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

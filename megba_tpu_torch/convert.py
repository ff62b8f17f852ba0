"""Carry state between the JAX package's numpy arrays and the port.

`to_torch` turns the arrays of a BA problem (cameras, points, obs,
cam_idx, pt_idx and optional sqrt_info, edge-major or feature-major, at
a registered factor's widths) into tensors on a given device and dtype;
`schur_system_to_torch` turns an assembled Schur system of the JAX
package (its fields read as numpy) into the port's `SchurSystem`;
`fault_plan_to_torch` turns a fault plan of the JAX package into the
port's `FaultPlan`; `fleet_problem_to_torch` a JAX `FleetProblem` (its
fault plan included) into the port's; `g2o_graph_to_torch` copies a parsed `G2OGraph` of
the JAX package into the port's (io/g2o.py); `result_to_numpy` turns an
`LMResult` back into numpy.  Both packages then compute on the same
inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from megba_tpu_torch.algo.lm import LMResult
from megba_tpu_torch.linear_system.builder import SchurSystem
from megba_tpu_torch.observability.trace import TRACE_FIELDS
from megba_tpu_torch.robustness.faults import FaultPlan



def _widths(factor) -> Dict[str, int]:
    """Leading (feature) width of each float array in feature-major
    layout, from a factor's spec (a name or a `factors.FactorSpec`)."""
    from megba_tpu_torch.factors import get_factor
    from megba_tpu_torch.factors.registry import require_schur

    spec = require_schur(get_factor(factor), "to_torch")
    return {"cameras": spec.cam_dim, "points": spec.pt_dim,
            "obs": spec.obs_dim, "sqrt_info": spec.residual_dim ** 2}


def to_torch(
    cameras: np.ndarray,
    points: np.ndarray,
    obs: np.ndarray,
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    sqrt_info: Optional[np.ndarray] = None,
    *,
    device: Union[str, torch.device],
    dtype: torch.dtype = torch.float64,
    feature_major: bool = False,
    factor="bal",
) -> Dict[str, Optional[torch.Tensor]]:
    """Numpy problem arrays -> contiguous feature-major tensors.

    The widths are `factor`'s (a registered name or a spec; BAL: cameras
    9, points 3, obs 2, sqrt_info 2 x 2).  With `feature_major=False` the
    inputs are edge-major (cameras [Nc, cd], obs [nE, od], sqrt_info
    [nE, rd, rd]) and are transposed; with True they are already [F, N]
    (sqrt_info [rd*rd, nE]).  Index arrays become int64.
    """
    widths = _widths(factor)
    out: Dict[str, Optional[torch.Tensor]] = {}
    for name, a in (("cameras", cameras), ("points", points), ("obs", obs),
                    ("sqrt_info", sqrt_info)):
        if a is None:
            out[name] = None
            continue
        a = np.asarray(a)
        if not feature_major:
            a = a.reshape(a.shape[0], -1).T
        if a.shape[0] != widths[name]:
            raise ValueError(f"{name}: expected {widths[name]} feature "
                             f"rows, got shape {a.shape}")
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)
    for name, a in (("cam_idx", cam_idx), ("pt_idx", pt_idx)):
        out[name] = torch.from_numpy(
            np.asarray(a).astype(np.int64).reshape(-1)).to(device)
    return out


def schur_system_to_torch(
    system,
    *,
    device: Union[str, torch.device],
    dtype: Optional[torch.dtype] = None,
    edge_perm: Optional[np.ndarray] = None,
) -> SchurSystem:
    """A Schur system with the JAX package's fields (Hpp [Nc, cd, cd],
    Hll [pd*pd, Np], g_cam [cd, Nc], g_pt [pd, Np], optional W
    [cd*pd, nE]; any array numpy can read) -> the port's SchurSystem.

    `edge_perm` reorders W's edge columns into the port's slot order
    (`W[:, edge_perm]`, e.g. the cam plan's `perm` for a system built in
    the caller's edge order).  `dtype` defaults to the arrays' own.  W
    becomes the rows of a one-shard mesh (a 1-tuple,
    parallel.mesh.one_shard).
    """
    def put(a):
        t = torch.from_numpy(np.array(a, order="C"))  # a writable copy
        return t.to(device=device, dtype=dtype or t.dtype)

    W = None
    if getattr(system, "W", None) is not None:
        W = np.asarray(system.W)
        W = (put(W if edge_perm is None else W[:, edge_perm]),)
    return SchurSystem(Hpp=put(system.Hpp), Hll=put(system.Hll),
                       g_cam=put(system.g_cam), g_pt=put(system.g_pt), W=W)


def fault_plan_to_torch(plan, *, device: Union[str, torch.device] = "cpu"
                        ) -> FaultPlan:
    """A fault plan with the JAX package's fields (edge_nan [nE],
    point_crush [Np], window [2], offset; any arrays numpy can read) ->
    the port's FaultPlan, its tensors on `device` in the arrays' dtype."""
    def put(a):
        return torch.from_numpy(np.array(a)).to(device)

    window = np.asarray(plan.window).reshape(-1)
    return FaultPlan(edge_nan=put(plan.edge_nan),
                     point_crush=put(plan.point_crush),
                     window=(int(window[0]), int(window[1])),
                     offset=int(np.asarray(plan.offset)))


def fleet_problem_to_torch(problem):
    """A `FleetProblem` with the JAX package's fields -> the port's
    `serving.FleetProblem`: every array copied (numpy, host side), the
    fault plan through `fault_plan_to_torch` (CPU tensors), the health
    record copied."""
    from megba_tpu_torch.serving.batcher import FleetProblem

    def copy(v):
        return None if v is None else np.array(v)

    return FleetProblem(
        cameras=copy(problem.cameras), points=copy(problem.points),
        obs=copy(problem.obs), cam_idx=copy(problem.cam_idx),
        pt_idx=copy(problem.pt_idx), name=str(problem.name),
        fault_plan=(None if problem.fault_plan is None
                    else fault_plan_to_torch(problem.fault_plan)),
        edge_mask=copy(problem.edge_mask), cam_fixed=copy(problem.cam_fixed),
        pt_fixed=copy(problem.pt_fixed),
        health=None if problem.health is None else dict(problem.health),
        factor=str(problem.factor))


def g2o_graph_to_torch(graph):
    """A `G2OGraph` with the JAX package's fields -> the port's
    `io.g2o.G2OGraph`, every array copied (numpy, host side), so one
    parsed graph is solved by both packages."""
    from megba_tpu_torch.io.g2o import G2OGraph

    def copy(v):
        return v if isinstance(v, bool) else np.array(v)

    return G2OGraph(**{f.name: copy(getattr(graph, f.name))
                       for f in dataclasses.fields(G2OGraph)})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def result_to_numpy(result: LMResult) -> Dict[str, object]:
    """An LMResult as a dict of numpy arrays and Python scalars; the trace
    becomes a dict of [iterations] arrays."""
    out: Dict[str, object] = {}
    for f in dataclasses.fields(result):
        v = getattr(result, f.name)
        if f.name == "trace":
            out["trace"] = (None if v is None else {
                t: _np(getattr(v, t))[: result.iterations]
                for t in TRACE_FIELDS})
        elif v is None or isinstance(v, (bool, int, float)):
            out[f.name] = v
        else:
            out[f.name] = _np(v)
    return out

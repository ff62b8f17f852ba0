"""Flat solve pipeline + one-call BAL convenience (PyTorch).

Counterpart of `megba_tpu/solve.py` on the single-device plan path:
`flat_solve` takes the conventional edge-major numpy arrays, plans both
segment orders on the host (ops/segtiles.make_dual_plans: the stable
camera sort is the canonical edge order), with `fused_kernels` derives
from them the input index of each fused direction once
(ops/fused.with_fused_plans), moves feature-major tensors to the device
once, runs the LM loop, and returns the solved cameras and points
edge-major ([N, d]) again.

Entry points run on CUDA unless the caller passes `device="cpu"` (or an
option with `device=Device.CPU`); with no card and no such request they
raise.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from megba_tpu_torch.algo.lm import LMResult, lm_solve
from megba_tpu_torch.common import (
    DTYPE_TO_TORCH,
    EdgeOrder,
    PrecondKind,
    ProblemOption,
    resolve_device,
    validate_options,
)
from megba_tpu_torch.io.bal import BALFile, load_bal
from megba_tpu_torch.ops.fused import with_fused_plans
from megba_tpu_torch.ops.segtiles import (
    build_cluster_plan,
    build_multilevel_plan,
    coobservation_edge_order,
    device_cluster_plan,
    device_multilevel_plan,
    make_dual_plans,
)
from megba_tpu_torch.robustness.faults import FaultPlan, lower_edge_vector


def _host(a) -> np.ndarray:
    """A tensor (any device) or array as a writable host numpy copy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().copy()
    return np.array(a)


def flat_solve(
    cameras: np.ndarray,
    points: np.ndarray,
    obs: np.ndarray,
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    option: ProblemOption,
    sqrt_info: Optional[np.ndarray] = None,
    edge_mask: Optional[np.ndarray] = None,
    cam_fixed: Optional[np.ndarray] = None,
    pt_fixed: Optional[np.ndarray] = None,
    verbose: bool = False,
    device: Union[None, str, torch.device] = None,
    residual_jac_fn: Optional[Callable] = None,
    initial_region: Optional[float] = None,
    initial_v: Optional[float] = None,
    initial_dx: Optional[np.ndarray] = None,
    fault_plan: Optional[FaultPlan] = None,
) -> LMResult:
    """Lower flat arrays and run the solve on one device.

    Arrays are edge-major numpy: cameras [Nc, 9], points [Np, 3],
    obs [nE, 2], cam_idx/pt_idx [nE], sqrt_info [nE, 2, 2].  `edge_mask`
    ([nE] 0/1, caller's edge order) soft-deletes edges: a 0 edge adds
    nothing to the cost or the system.  `cam_fixed` / `pt_fixed` ([Nc] /
    [Np] bool) freeze vertices.  The result's cameras/points (and, under
    `SolverOption.warm_start`, `dx_cam`) are [N, d] tensors on the solve
    device.

    `residual_jac_fn` is the residual + Jacobian engine
    (ops.residuals.make_residual_jacobian_fn); None is the BAL engine of
    `option.jacobian_mode`.  `initial_region` / `initial_v` replace the
    trust-region start state, and `initial_dx` ([Nc, 9], edge-major like
    `cameras`) seeds the warm-start carry under `SolverOption.warm_start`
    (ignored otherwise): with a previous result's `region`, `v` and
    `dx_cam` they resume a solve split in two.

    `fault_plan` (robustness.faults.FaultPlan, `edge_nan` in the caller's
    edge order) seeds a deterministic fault into the solve, for the
    guards of `RobustOption(guards=True)` to contain.  Under
    `SolverOption.edge_order=EdgeOrder.COOBS` the edges are first put in
    co-observation order (camera-major, point-minor); NATURAL keeps the
    caller's order into the stable camera sort.  Under
    `SolverOption.precond` TWO_LEVEL or MULTILEVEL the camera clusters are
    planned on the host over the final edge stream; the result's
    `coarse_plan_seconds` says how long that took.
    """
    validate_options(option)
    dev = resolve_device(device, option)
    dtype = np.dtype(option.dtype)
    tdtype = DTYPE_TO_TORCH[dtype]
    cameras = np.asarray(cameras).astype(dtype, copy=False)
    points = np.asarray(points).astype(dtype, copy=False)
    obs = np.asarray(obs).astype(dtype, copy=False)
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    n_edges = int(cam_idx.shape[0])
    if obs.shape[0] != n_edges or pt_idx.shape[0] != n_edges:
        raise ValueError(
            f"obs ({obs.shape[0]}), cam_idx ({n_edges}) and pt_idx "
            f"({pt_idx.shape[0]}) must have one row per edge")
    mask = np.ones(n_edges, dtype)
    if edge_mask is not None:
        mask = np.asarray(edge_mask).astype(dtype, copy=False).reshape(-1)
        if mask.shape[0] != n_edges:
            raise ValueError(
                f"edge_mask has {mask.shape[0]} entries for a problem "
                f"with {n_edges} edges")
    fault_edge = None
    if fault_plan is not None:
        fault_edge = _host(fault_plan.edge_nan)
        if fault_edge.shape[0] != n_edges:
            raise ValueError(
                f"fault_plan.edge_nan has {fault_edge.shape[0]} entries "
                f"for a problem with {n_edges} edges")
    if option.solver_option.edge_order == EdgeOrder.COOBS:
        # A host pre-permutation of the caller's edges; the stable camera
        # sort below keeps its point-minor order (JAX solve.py:368-389).
        operm = coobservation_edge_order(cam_idx, pt_idx)
        cam_idx, pt_idx, obs = cam_idx[operm], pt_idx[operm], obs[operm]
        mask = mask[operm]
        if sqrt_info is not None:
            sqrt_info = np.asarray(sqrt_info)[operm]
        if fault_edge is not None:
            fault_edge = fault_edge[operm]

    # Canonical edge order = the stable camera sort (cam plan slots).
    plan_c, plans = make_dual_plans(cam_idx, pt_idx, cameras.shape[0],
                                    points.shape[0], dev)
    if option.solver_option.fused_kernels:
        plans = with_fused_plans(plans)
    perm = plan_c.perm
    cluster_plan, plan_seconds = _coarse_plan(option, plan_c.seg,
                                              pt_idx[perm], mask[perm],
                                              cameras.shape[0],
                                              points.shape[0], dev)
    if verbose and plan_seconds is not None:
        print(f"coarse plan: {plan_seconds:.3f} s on the host", flush=True)

    def edge_rows(a: np.ndarray) -> torch.Tensor:
        """[nE, ...] caller order -> feature-major [F, nE] slot order."""
        a = a[perm].reshape(n_edges, -1)
        return torch.from_numpy(np.ascontiguousarray(a.T)).to(dev)

    def vertex_rows(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a.T)).to(dev)

    def flags(a: Optional[np.ndarray], n: int) -> Optional[torch.Tensor]:
        if a is None:
            return None
        a = np.asarray(a, dtype=bool).reshape(-1)
        if a.shape[0] != n:
            raise ValueError(f"fixed mask has {a.shape[0]} entries, "
                             f"expected {n}")
        return torch.from_numpy(a).to(dev)

    si = None
    if sqrt_info is not None:
        si = edge_rows(np.asarray(sqrt_info).astype(dtype, copy=False))
    dx0 = None
    if initial_dx is not None and option.solver_option.warm_start:
        initial_dx = np.asarray(initial_dx).astype(dtype, copy=False)
        if initial_dx.shape != cameras.shape:
            raise ValueError(f"initial_dx has shape {initial_dx.shape}, "
                             f"cameras {cameras.shape}")
        dx0 = vertex_rows(initial_dx)
    fault = None
    if fault_plan is not None:
        fault = FaultPlan(
            edge_nan=torch.from_numpy(lower_edge_vector(fault_edge, perm)).to(
                dev, tdtype),
            point_crush=torch.from_numpy(
                _host(fault_plan.point_crush)).to(dev, tdtype),
            window=(int(fault_plan.window[0]), int(fault_plan.window[1])),
            offset=int(fault_plan.offset))
    result = lm_solve(
        vertex_rows(cameras), vertex_rows(points), edge_rows(obs),
        plans.cam.seg.long(),
        torch.from_numpy(pt_idx[perm].astype(np.int64)).to(dev),
        torch.from_numpy(mask[perm]).to(dev, tdtype), option, plans,
        sqrt_info=si, cam_fixed=flags(cam_fixed, cameras.shape[0]),
        pt_fixed=flags(pt_fixed, points.shape[0]), verbose=verbose,
        residual_jac_fn=residual_jac_fn, initial_region=initial_region,
        initial_v=initial_v, initial_dx=dx0, fault_plan=fault,
        cluster_plan=cluster_plan)
    result.coarse_plan_seconds = plan_seconds
    result.cameras = result.cameras.T.contiguous()
    result.points = result.points.T.contiguous()
    if result.dx_cam is not None:
        result.dx_cam = result.dx_cam.T.contiguous()
    return result


def _coarse_plan(option: ProblemOption, cam_idx: np.ndarray,
                 pt_idx: np.ndarray, mask: np.ndarray, num_cameras: int,
                 num_points: int, dev: torch.device):
    """The camera-cluster plan of a TWO_LEVEL or MULTILEVEL Schur solve
    (JAX solve.py:587-628), over the solver's edge stream (camera slots),
    with its host seconds; (None, None) for every other option."""
    so = option.solver_option
    if not option.use_schur or so.precond not in (PrecondKind.TWO_LEVEL,
                                                  PrecondKind.MULTILEVEL):
        return None, None
    t = time.perf_counter()
    if so.precond == PrecondKind.TWO_LEVEL:
        plan = device_cluster_plan(build_cluster_plan(
            cam_idx, pt_idx, num_cameras, num_points, so.coarse_clusters,
            mask=mask), dev)
    else:
        plan = device_multilevel_plan(build_multilevel_plan(
            cam_idx, pt_idx, num_cameras, num_points, so.coarse_clusters,
            mask=mask, coarsen_factor=so.coarsen_factor,
            max_levels=so.max_levels), dev)
    return plan, time.perf_counter() - t


def solve_bal(
    bal: Union[BALFile, str, os.PathLike],
    option: Optional[ProblemOption] = None,
    verbose: bool = False,
    device: Union[None, str, torch.device] = None,
) -> Tuple[BALFile, LMResult]:
    """Solve a BAL problem end to end.

    Accepts a parsed `BALFile` or a path (.txt/.bz2).  The default option
    is `ProblemOption()`, the JAX package's: float64, IMPLICIT Schur with
    block-Jacobi (HPP) PCG and AUTODIFF Jacobians.  Returns (solved
    BALFile in the ORIGINAL edge order, LMResult).
    """
    option = option or ProblemOption()
    validate_options(option)
    if not isinstance(bal, BALFile):
        bal = load_bal(bal, dtype=option.dtype)
    if verbose:
        cd = np.bincount(bal.cam_idx, minlength=bal.num_cameras)
        pdg = np.bincount(bal.pt_idx, minlength=bal.num_points)
        print(f"cameras {bal.num_cameras} points {bal.num_points} "
              f"observations {bal.num_observations} max camera degree "
              f"{int(cd.max(initial=0))} max point degree "
              f"{int(pdg.max(initial=0))}", flush=True)
    result = flat_solve(bal.cameras, bal.points, bal.obs, bal.cam_idx,
                        bal.pt_idx, option, verbose=verbose, device=device)
    solved = BALFile(
        cameras=result.cameras.detach().cpu().numpy().astype(np.float64),
        points=result.points.detach().cpu().numpy().astype(np.float64),
        obs=bal.obs, cam_idx=bal.cam_idx, pt_idx=bal.pt_idx)
    return solved, result

"""Flat solve pipeline + one-call BAL convenience (PyTorch).

Counterpart of `megba_tpu/solve.py`: `flat_solve` takes the
conventional edge-major numpy arrays, plans both segment orders of each
shard's edges on the host (ops/segtiles.make_dual_plans: the stable
camera sort is the canonical edge order), with `fused_kernels` derives
from them the input index of each fused direction once
(ops/fused.with_fused_plans), moves feature-major tensors to the devices
once, runs the LM loop, and returns the solved cameras and points
edge-major ([N, d]) again.

The solve runs over a mesh of `ProblemOption.world_size` N shards
(parallel/mesh.py; one device is the mesh of one shard): the 1-D
edge-sharded mesh, whose shards take contiguous pieces of the
camera-sorted edge stream, or with `SolverOption.mesh_2d` the 2-D
camera x edge mesh, whose shards take the device blocks of the
camera-tile plan (ops/segtiles.build_camera_tile_plan).  At N > 1
`device` is a sequence of N devices, which may repeat one (N shards on
one card, or on the CPU); without one the solve takes the first N
visible cards and raises when there are fewer.

Entry points run on CUDA unless the caller passes `device="cpu"` (or an
option with `device=Device.CPU`); with no card and no such request they
raise.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from megba_tpu_torch.algo.lm import LMResult
from megba_tpu_torch.common import (
    DTYPE_TO_TORCH,
    EdgeOrder,
    PrecondKind,
    ProblemOption,
    RobustKind,
    resolve_device,
    validate_options,
)
from megba_tpu_torch.io.bal import BALFile, load_bal
from megba_tpu_torch.ops.fused import with_fused_plans
from megba_tpu_torch.ops.segtiles import (
    build_camera_tile_plan,
    build_cluster_plan,
    build_multilevel_plan,
    coobservation_edge_order,
    device_camera_tile_plan,
    device_sharded_coarse_plan,
    make_dual_plans,
    make_sharded_dual_plans,
    tile_plan_shards,
)
from megba_tpu_torch.parallel.mesh import (
    distributed_lm_solve,
    factor_mesh_2d,
    make_mesh,
    make_mesh_2d,
    resolve_devices,
)
from megba_tpu_torch.robustness.faults import (
    FaultPlan,
    fault_partition,
    lower_edge_vector,
)
from megba_tpu_torch.utils.timing import PhaseTimer


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
    device: Union[None, str, torch.device, Sequence] = None,
    residual_jac_fn: Optional[Callable] = None,
    initial_region: Optional[float] = None,
    initial_v: Optional[float] = None,
    initial_dx: Optional[np.ndarray] = None,
    fault_plan: Optional[FaultPlan] = None,
    factor=None,
    timer: Optional[PhaseTimer] = None,
    triage=None,
) -> LMResult:
    """Lower flat arrays and run the solve.

    Arrays are edge-major numpy: cameras [Nc, cd], points [Np, pd],
    obs [nE, od], cam_idx/pt_idx [nE], sqrt_info [nE, rd, rd], at the
    factor's widths (BAL: cd 9, pd 3, od = rd = 2).  `edge_mask`
    ([nE] 0/1, caller's edge order) soft-deletes edges: a 0 edge adds
    nothing to the cost or the system.  `cam_fixed` / `pt_fixed` ([Nc] /
    [Np] bool) freeze vertices.  The result's cameras/points (and, under
    `SolverOption.warm_start`, `dx_cam`) are [N, d] tensors on the solve
    device.

    `residual_jac_fn` is the residual + Jacobian engine
    (ops.residuals.make_residual_jacobian_fn); None is the engine of
    `factor` or, without one, the BAL engine of `option.jacobian_mode`.
    `factor` (a registered factor name or a `factors.FactorSpec`) routes
    the solve through the factor registry as the JAX package does
    (megba_tpu/solve.py:219-250): a pose-graph factor or an unknown name
    raises a typed `factors.FactorError` here, the arrays' widths are
    checked against the spec, the factor's solver defaults are folded
    into `option`, a robust loss on a `robust_ok=False` family is
    refused, and the engine is `factors.engine_for(spec,
    option.jacobian_mode)`.  `initial_region` / `initial_v` replace the
    trust-region start state, and `initial_dx` ([Nc, cd], edge-major like
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

    With `option.world_size` N > 1, `device` is a sequence of N devices
    (or None: the first N visible cards; fewer raise), and the solve
    runs over the 1-D edge-sharded mesh or, with `SolverOption.mesh_2d`
    (Schur only), the 2-D camera x edge mesh of `cam_blocks` camera
    columns (0: the largest divisor of N up to its square root).  As in
    the JAX package, `fused_kernels` needs the 2-D mesh there, and COOBS
    orders only the 1-D streams (the 2-D plan orders its columns
    co-observation first itself).  The result lives on the first
    device.

    `timer` (utils.timing.PhaseTimer, a fresh one if None) records the
    host phases of the JAX package's names: "triage", "lowering" (the
    arrays' checks and conversions and their moves to the devices),
    "sort" (COOBS), "plan" (the segment, fused and coarse plans) and
    "dispatch" (the LM loop).  `triage` (robustness.triage.TriagePolicy)
    arms the pre-flight health checks (JAX solve.py:266-292): the
    problem is checked on the host in a "triage" phase before any
    lowering or tensor allocation.  Under REJECT a degenerate problem
    raises `ProblemRejected` (HealthReport attached) with no kernel
    launched and nothing allocated on a device; under REPAIR the repairs
    merge into this call's arrays and operands (edge_mask multiplies,
    fixed masks OR, non-finite values sanitised) and each repair counter
    lands on the timer as a `triage_*` event; under WARN the solve is
    unchanged.  With `factor`, the spec's triage hooks drive the
    geometric checks; without, the BAL hooks of io/synthetic.
    """
    spec = None
    if factor is not None:
        option, engine, spec = _factor_route(factor, option, cameras,
                                             points, obs)
        residual_jac_fn = residual_jac_fn or engine
    validate_options(option)
    timer = PhaseTimer() if timer is None else timer
    if triage is not None:
        from megba_tpu_torch.robustness.triage import triage_problem

        # Before any lowering: a REJECT propagates ProblemRejected out of
        # this phase, with the timer holding a "triage" phase alone.
        with timer.phase("triage"):
            outcome = triage_problem(
                cameras, points, obs, cam_idx, pt_idx, triage,
                edge_mask=edge_mask, cam_fixed=cam_fixed,
                pt_fixed=pt_fixed, factor=spec)
        rep = outcome.repair
        if rep is not None and not rep.is_noop:
            for name, n in rep.counters().items():
                if n:
                    timer.count_event(f"triage_{name}", n)
            cameras, points, obs = rep.merged_arrays(cameras, points, obs)
            edge_mask, cam_fixed, pt_fixed = rep.merge_operands(
                edge_mask, cam_fixed, pt_fixed)
    ws = option.world_size
    so = option.solver_option
    mesh2d = bool(ws > 1 and option.use_schur and so.mesh_2d)
    if option.use_schur and so.fused_kernels and ws > 1 and not mesh2d:
        raise ValueError(
            "SolverOption.fused_kernels is implemented for the "
            "single-device tiled lowering and the 2-D mesh ring step; "
            "the 1-D multi-device lowerings keep the segtiles/XLA "
            "paths — pass fused_kernels=False, or mesh_2d=True for a "
            "fused distributed solve")
    if ws > 1:
        devices = resolve_devices(ws, device, default=option.device.value)
        mesh = (make_mesh_2d(*factor_mesh_2d(ws, so.cam_blocks), devices)
                if mesh2d else make_mesh(ws, devices))
    else:
        if isinstance(device, (list, tuple)):
            device = resolve_devices(1, device)[0]
        mesh = make_mesh(1, [resolve_device(device, option)])
    dtype = np.dtype(option.dtype)
    with timer.phase("lowering"):
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
            mask = np.asarray(edge_mask).astype(dtype, copy=False).reshape(
                -1)
            if mask.shape[0] != n_edges:
                raise ValueError(
                    f"edge_mask has {mask.shape[0]} entries for a problem "
                    f"with {n_edges} edges")
        fault_edge = None
        if fault_plan is not None:
            fault_edge = _host(fault_plan.edge_nan)
            if fault_edge.shape[0] != n_edges:
                raise ValueError(
                    f"fault_plan.edge_nan has {fault_edge.shape[0]} "
                    f"entries for a problem with {n_edges} edges")
    if option.solver_option.edge_order == EdgeOrder.COOBS and not mesh2d:
        # A host pre-permutation of the caller's edges; the stable camera
        # sort below keeps its point-minor order (JAX solve.py:368-389).
        with timer.phase("sort"):
            operm = coobservation_edge_order(cam_idx, pt_idx)
            cam_idx, pt_idx, obs = cam_idx[operm], pt_idx[operm], obs[operm]
            mask = mask[operm]
            if sqrt_info is not None:
                sqrt_info = np.asarray(sqrt_info)[operm]
            if fault_edge is not None:
                fault_edge = fault_edge[operm]

    return _mesh_solve(
        mesh, cameras, points, obs, cam_idx, pt_idx, mask, option,
        sqrt_info, cam_fixed, pt_fixed, verbose, residual_jac_fn,
        initial_region, initial_v, initial_dx, fault_plan, fault_edge, timer)


def _factor_route(factor, option: ProblemOption, cameras, points, obs):
    """The registry's checks and defaults for a solve of `factor`
    (JAX solve.py:219-250): returns the option with the factor's solver
    defaults, the factor's engine and its spec."""
    from megba_tpu_torch.factors import (
        engine_for,
        get_factor,
        validate_factor_arrays,
    )
    from megba_tpu_torch.factors.registry import (
        FactorError,
        apply_factor_solver_defaults,
        require_schur,
    )

    spec = require_schur(get_factor(factor), "flat_solve")
    validate_factor_arrays(spec, np.asarray(cameras), np.asarray(points),
                           np.asarray(obs), where="flat_solve")
    option = apply_factor_solver_defaults(spec, option)
    if option.robust_kind != RobustKind.NONE and not spec.robust_ok:
        raise FactorError(
            f"flat_solve: factor {spec.name!r} is not "
            "robust-kernel eligible (robust_ok=False — e.g. a "
            "marginalization prior must not be IRLS-downweighted); "
            "submit with robust_kind=NONE")
    return option, engine_for(spec, option.jacobian_mode), spec


def _vertex_rows(a: np.ndarray, dev) -> torch.Tensor:
    """[N, d] edge-major -> feature-major [d, N] on `dev`."""
    return torch.from_numpy(np.ascontiguousarray(a.T)).to(dev)


def _flags(a: Optional[np.ndarray], n: int, dev) -> Optional[torch.Tensor]:
    """A fixed-vertex mask ([n] bool) on `dev`, or None."""
    if a is None:
        return None
    a = np.asarray(a, dtype=bool).reshape(-1)
    if a.shape[0] != n:
        raise ValueError(f"fixed mask has {a.shape[0]} entries, "
                         f"expected {n}")
    return torch.from_numpy(a).to(dev)


def _warm_dx(initial_dx, option: ProblemOption, cameras: np.ndarray, dev):
    """The warm-start seed [cd, Nc] on `dev` (None unless warm starts are
    on and one is given)."""
    if initial_dx is None or not option.solver_option.warm_start:
        return None
    initial_dx = np.asarray(initial_dx).astype(cameras.dtype, copy=False)
    if initial_dx.shape != cameras.shape:
        raise ValueError(f"initial_dx has shape {initial_dx.shape}, "
                         f"cameras {cameras.shape}")
    return _vertex_rows(initial_dx, dev)


def _lowered_fault(fault_plan: FaultPlan, fault_edge: np.ndarray,
                   order: np.ndarray, tdtype) -> FaultPlan:
    """The caller's fault plan with its edge poison in `order` (the
    solve's stream order), on the host."""
    return FaultPlan(
        edge_nan=torch.from_numpy(lower_edge_vector(fault_edge, order)).to(
            tdtype),
        point_crush=torch.from_numpy(
            _host(fault_plan.point_crush)).to(tdtype),
        window=(int(fault_plan.window[0]), int(fault_plan.window[1])),
        offset=int(fault_plan.offset))


def _edge_major(result: LMResult, plan_seconds) -> LMResult:
    """The result's parameters (and warm-start step) edge-major again."""
    result.coarse_plan_seconds = plan_seconds
    result.cameras = result.cameras.T.contiguous()
    result.points = result.points.T.contiguous()
    if result.dx_cam is not None:
        result.dx_cam = result.dx_cam.T.contiguous()
    return result


def _coarse_plan(option: ProblemOption, cam_idx: np.ndarray,
                 pt_idx: np.ndarray, mask: np.ndarray, num_cameras: int,
                 num_points: int, devs, shards):
    """The camera-cluster plan of a TWO_LEVEL or MULTILEVEL Schur solve
    (JAX solve.py:587-628), over the camera-sorted edge stream, split
    over the mesh's devices `devs` (`shards`: each shard's positions in
    the stream, ops/segtiles.shard_cluster_plan), with its host seconds;
    (None, None) for every other option."""
    so = option.solver_option
    if not option.use_schur or so.precond not in (PrecondKind.TWO_LEVEL,
                                                  PrecondKind.MULTILEVEL):
        return None, None
    t = time.perf_counter()
    if so.precond == PrecondKind.TWO_LEVEL:
        plan = build_cluster_plan(
            cam_idx, pt_idx, num_cameras, num_points, so.coarse_clusters,
            mask=mask)
    else:
        plan = build_multilevel_plan(
            cam_idx, pt_idx, num_cameras, num_points, so.coarse_clusters,
            mask=mask, coarsen_factor=so.coarsen_factor,
            max_levels=so.max_levels)
    plan = device_sharded_coarse_plan(plan, shards, devs)
    return plan, time.perf_counter() - t


def _mesh_solve(mesh, cameras, points, obs, cam_idx, pt_idx, mask,
                option, sqrt_info, cam_fixed, pt_fixed, verbose,
                residual_jac_fn, initial_region, initial_v, initial_dx,
                fault_plan, fault_edge, timer) -> LMResult:
    """The lowering of a solve over a mesh (JAX solve.py:408-500): the
    shards' edge streams and their plans (the "plan" phase of `timer`),
    the sharded coarse plan and fault plan and the arrays' moves to the
    devices ("lowering"), then `distributed_lm_solve` ("dispatch")."""
    so = option.solver_option
    dtype = np.dtype(option.dtype)
    tdtype = DTYPE_TO_TORCH[dtype]
    devs = mesh.devices
    dev0 = devs[0]
    nc, npt = cameras.shape[0], points.shape[0]
    with timer.phase("plan"):
        tile_plan = None
        if mesh.is_2d:
            # The camera-tile plan's device blocks, real edges only; each
            # block is camera-sorted, so its camera-slot order is its own.
            # Quantum 1: the JAX package pads each column to a multiple of
            # E * EDGE_QUANTUM for static shapes, which on a small problem
            # leaves whole edge shards empty; the CSR plans need no padding,
            # so each edge shard takes an even piece of its column.
            tplan = build_camera_tile_plan(cam_idx, pt_idx, nc, npt,
                                           mesh.edge_shards, mesh.cam_blocks,
                                           quantum=1)
            perms = tile_plan_shards(tplan)
            shard_plans = []
            for p, d in zip(perms, devs):
                plan_c, dp = make_dual_plans(cam_idx[p], pt_idx[p], nc, npt, d)
                if not np.array_equal(plan_c.perm, np.arange(p.shape[0])):
                    raise AssertionError("a 2-D device block is not "
                                         "camera-sorted")
                shard_plans.append(dp)
            shard_plans = tuple(shard_plans)
            tile_plan = device_camera_tile_plan(tplan, devs)
        else:
            perms, shard_plans = make_sharded_dual_plans(cam_idx, pt_idx, nc,
                                                         npt, devs)
        if option.use_schur and so.fused_kernels:
            shard_plans = tuple(with_fused_plans(p) for p in shard_plans)
        bounds = tuple(int(b) for b in np.cumsum([0] + [p.shape[0]
                                                        for p in perms]))
        stream = np.concatenate(perms)
        # The coarse space is planned over the stable camera sort, the
        # world-1 stream, on every mesh: its clusters depend on the stream's
        # order, so every mesh then solves with the world-1 coarse space (the
        # JAX package plans the 2-D mesh's over its 2-D stream instead).
        canon = np.argsort(cam_idx, kind="stable")
        at = np.empty_like(canon)
        at[canon] = np.arange(canon.shape[0])
        cluster_plan, plan_seconds = _coarse_plan(
            option, cam_idx[canon], pt_idx[canon], mask[canon], nc, npt, devs,
            [at[p] for p in perms])
    if verbose and plan_seconds is not None:
        print(f"coarse plan: {plan_seconds:.3f} s on the host", flush=True)

    def per_shard(a: np.ndarray):
        """[nE, ...] caller order -> each shard's [F, n_k] rows."""
        a = a.reshape(a.shape[0], -1)
        return tuple(torch.from_numpy(np.ascontiguousarray(a[p].T)).to(d)
                     for p, d in zip(perms, devs))

    with timer.phase("lowering"):
        si = None
        if sqrt_info is not None:
            si = per_shard(np.asarray(sqrt_info).astype(dtype, copy=False))
        faults = None
        if fault_plan is not None:
            faults = fault_partition(
                _lowered_fault(fault_plan, fault_edge, stream, tdtype),
                bounds, devs)
        operands = (
            _vertex_rows(cameras, dev0), _vertex_rows(points, dev0),
            per_shard(obs), tuple(p.cam.seg.long() for p in shard_plans),
            tuple(torch.from_numpy(pt_idx[p].astype(np.int64)).to(d)
                  for p, d in zip(perms, devs)),
            tuple(torch.from_numpy(mask[p]).to(d, tdtype)
                  for p, d in zip(perms, devs)))
        flags = dict(cam_fixed=_flags(cam_fixed, nc, dev0),
                     pt_fixed=_flags(pt_fixed, npt, dev0),
                     initial_dx=_warm_dx(initial_dx, option, cameras, dev0))
    with timer.phase("dispatch"):
        result = distributed_lm_solve(
            *operands, option, mesh, shard_plans, sqrt_info=si,
            verbose=verbose, residual_jac_fn=residual_jac_fn,
            initial_region=initial_region, initial_v=initial_v,
            fault_plan=faults, cluster_plan=cluster_plan,
            tile_plan=tile_plan, **flags)
    return _edge_major(result, plan_seconds)


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

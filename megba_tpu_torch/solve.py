"""Flat solve pipeline + one-call BAL convenience (PyTorch).

Counterpart of `megba_tpu/solve.py`: `flat_solve` takes the
conventional edge-major numpy arrays, plans both segment orders of each
shard's edges on the host (ops/segtiles.make_dual_plans: the stable
camera sort is the canonical edge order), with `fused_kernels` derives
from them the input index of each fused direction once
(ops/fused.with_fused_plans), moves feature-major tensors to the devices
once, runs the LM loop, and returns the solved cameras and points
edge-major ([N, d]) again.  The plans, and the coarse spaces of TWO_LEVEL
and MULTILEVEL, come from the host plan cache (ops/segtiles.cached_*: a
content-keyed LRU of `MEGBA_PLAN_CACHE` entries, 8 by default), so a
repeated solve of one graph on the same devices (a chunked driver's
chunks, a rerun) plans once.

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

from megba_tpu_torch import observability as _obs
from megba_tpu_torch.algo.lm import LMResult
from megba_tpu_torch.common import (
    DTYPE_TO_TORCH,
    EdgeOrder,
    PrecondKind,
    ProblemOption,
    RobustKind,
    resolve_device,
    strip_observability,
    validate_options,
)
from megba_tpu_torch.io.bal import BALFile, load_bal
from megba_tpu_torch.native import sort_edges_by_camera
from megba_tpu_torch.ops.segtiles import (
    cached_camera_tile_plan,
    cached_cluster_plan,
    cached_multilevel_plan,
    cached_sharded_dual_plans,
    coobservation_edge_order,
    plan_cache_evictions,
)
from megba_tpu_torch.parallel.mesh import (
    EDGE_AXIS,
    distributed_lm_solve,
    factor_mesh_2d,
    make_mesh,
    make_mesh_2d,
    make_process_mesh,
    multiprocess_active,
    resolve_devices,
)
from megba_tpu_torch.parallel.multihost import globalize_for_mesh
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
    residual_jac_fn: Optional[Callable],
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
    *,
    initial_region: Optional[float] = None,
    initial_v: Optional[float] = None,
    initial_dx: Optional[np.ndarray] = None,
    fault_plan: Optional[FaultPlan] = None,
    timer: Optional[PhaseTimer] = None,
    elastic_report: Optional[dict] = None,
    triage=None,
    factor=None,
    device: Union[None, str, torch.device, Sequence] = None,
) -> LMResult:
    """Lower flat arrays and run the solve.

    The arguments are the JAX package's, in its order
    (megba_tpu/solve.py:100): the engine (or None) first, then the
    arrays and the option, positional through `verbose`.  The rest are
    keyword-only: the JAX package's `use_tiled`, `jit_cache` and
    `lower_only` sit among them there and have no counterpart here (the
    port has one lowering and no compiled program), and `device` is the
    port's own.

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
    `coarse_plan_seconds` says how long that took (on a cache hit, how
    long the lookup took).

    With `option.world_size` N > 1, `device` is a sequence of N devices
    (or None: the first N visible cards; fewer raise), and the solve
    runs over the 1-D edge-sharded mesh or, with `SolverOption.mesh_2d`
    (Schur only), the 2-D camera x edge mesh of `cam_blocks` camera
    columns (0: the largest divisor of N up to its square root).  As in
    the JAX package, `fused_kernels` needs the 2-D mesh there, and COOBS
    orders only the 1-D streams (the 2-D plan orders its columns
    co-observation first itself).  The result lives on the first
    device.  Once parallel/multihost.initialize_multihost has joined
    several processes, the 1-D mesh of world N spans them: every process
    calls `flat_solve` with the whole problem and its own `device` (one
    device, or a sequence, one shard each; the shard counts must add up
    to N), lowers only its own shards, and gets the same result, bitwise
    the one-process world-N solve's, on its first device.  A 2-D mesh
    across processes raises NotImplementedError.

    `timer` (utils.timing.PhaseTimer, a fresh one if None) records the
    host phases of the JAX package's names: "triage", "lowering" (the
    arrays' checks and conversions and their moves to the devices),
    "sort" (COOBS), "plan" (the segment and fused plans), "coarse_plan"
    (the camera clusters of TWO_LEVEL and MULTILEVEL) and "dispatch"
    (the LM loop), and the plan cache's events of the JAX package's
    names: `plan_cache_hit` and `plan_cache_evict` (the entries the
    lookup evicted) in "plan", `cluster_plan_cache_hit` in
    "coarse_plan".  `triage` (robustness.triage.TriagePolicy)
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

    Telemetry (JAX solve.py:252-256 and 737-809): `option.telemetry`, or
    else the `MEGBA_TELEMETRY` environment variable, names a JSONL file
    that receives one `observability.report.SolveReport` per call, with
    the timer's phases, an "execute" phase that syncs the result, and
    the guards' recoveries as a `fault_recovery` event.  The knob is
    stripped off the option before the solve.  With telemetry off
    nothing of the report is imported and nothing more is synced.
    `elastic_report` (an elastic monitor's ledger,
    robustness.elastic.ElasticMonitor.report_block(); the chunked driver
    passes it under `elastic=`) becomes the report's `elastic` block, and
    the report's `tiles` block describes this solve's plans.
    `option.metrics` or `MEGBA_METRICS` arms the metrics plane: the solve
    feeds the `megba_solve_*` series of the process registry
    (observability.metrics_registry); `MEGBA_TRACE` records the phases
    as spans.  Neither changes a launch or a bit of the result.
    """
    spec = None
    if factor is not None:
        option, engine, spec = _factor_route(factor, option, cameras,
                                             points, obs)
        residual_jac_fn = residual_jac_fn or engine
    validate_options(option)
    telemetry = option.telemetry or os.environ.get("MEGBA_TELEMETRY") or None
    report_option = option
    option = strip_observability(option)
    timer = PhaseTimer() if timer is None else timer
    # Armed by MEGBA_TRACE, the recorder's first creation installs the
    # PhaseTimer hook, so this solve's phases become spans (one
    # environment lookup when off).
    _obs.span_recorder()
    health = None
    if triage is not None:
        from megba_tpu_torch.robustness.triage import triage_problem

        # Before any lowering: a REJECT propagates ProblemRejected out of
        # this phase, with the timer holding a "triage" phase alone.
        with timer.phase("triage"):
            outcome = triage_problem(
                cameras, points, obs, cam_idx, pt_idx, triage,
                edge_mask=edge_mask, cam_fixed=cam_fixed,
                pt_fixed=pt_fixed, factor=spec)
        health = outcome.report.to_dict()
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
    if ws > 1 and multiprocess_active():
        # One mesh across the process group: this process's shards on
        # `device`, the others' in rank order (parallel/multihost.py).
        if mesh2d:
            raise NotImplementedError(
                "a 2-D mesh (SolverOption.mesh_2d) across processes is not "
                "implemented: its ring ppermute would need point-to-point "
                "sends between processes; solve the 1-D mesh across "
                "processes, or the 2-D mesh in one process")
        mesh = make_process_mesh(ws, device, default=option.device.value)
    elif ws > 1:
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

    result, tiles = _mesh_solve(
        mesh, cameras, points, obs, cam_idx, pt_idx, mask, option,
        sqrt_info, cam_fixed, pt_fixed, verbose, residual_jac_fn,
        initial_region, initial_v, initial_dx, fault_plan, fault_edge, timer,
        bool(telemetry))
    registry = _obs.metrics_registry(report_option.metrics)
    if registry is not None:
        _observe_solve(registry, result)
    if telemetry:
        problem = {"num_cameras": int(cameras.shape[0]),
                   "num_points": int(points.shape[0]),
                   "num_edges": n_edges, "num_edges_padded": n_edges,
                   "world_size": ws}
        if mesh.is_2d:
            problem["mesh"] = f"{mesh.edge_shards}x{mesh.cam_blocks}"
        _emit_report(telemetry, report_option, result, timer, problem,
                     health, mesh.home_device, elastic_report, tiles)
    return result


def _observe_solve(registry, result: LMResult) -> None:
    """The per-solve metrics observables of an unbatched solve (JAX
    solve.py:750-767): LM and PCG iterations over `ITER_BUCKETS` and the
    status counter.  The counts are host values: no sync."""
    from megba_tpu_torch.common import status_name
    from megba_tpu_torch.observability.metrics import ITER_BUCKETS

    registry.histogram(
        "megba_solve_lm_iterations", "LM iterations per solved problem",
        buckets=ITER_BUCKETS).observe(
            int(result.iterations), bucket="unbatched", factor="-")
    registry.histogram(
        "megba_solve_pcg_iterations",
        "Total PCG iterations per solved problem",
        buckets=ITER_BUCKETS).observe(
            int(result.pcg_iterations), bucket="unbatched", factor="-")
    if result.status is not None:
        registry.counter(
            "megba_solve_status_total",
            "Solve outcomes by SolveStatus name").inc(
                1, status=status_name(result.status), bucket="unbatched")


def _emit_report(telemetry: str, option: ProblemOption, result: LMResult,
                 timer: PhaseTimer, problem: dict, health, device,
                 elastic=None, tiles=None) -> None:
    """Append the solve's SolveReport to `telemetry` (JAX
    solve.py:737-809): an "execute" phase syncs the result, the trace's
    preconditioner fallbacks and the guards' recoveries become timer
    events, then the report is built and appended."""
    from megba_tpu_torch.observability.report import (
        _decode_fallback_totals,
        append_report,
        build_report,
    )

    with timer.phase("execute") as ph:
        ph.sync(result.cameras)
    iters = int(result.iterations)
    level = _decode_fallback_totals(result.trace, iters) or {}
    if level.get("block"):
        timer.count_event("precond_fallback", level["block"])
    if level.get("coarse"):
        timer.count_event("precond_fallback_coarse", level["coarse"])
    for li, n in enumerate(level.get("coarse_levels") or []):
        if n:
            timer.count_event(f"precond_fallback_coarse_l{li + 1}", n)
    if result.recoveries:
        timer.count_event("fault_recovery", int(result.recoveries))
    append_report(build_report(option, result, timer.as_dict(), problem,
                               health=health, device=device, elastic=elastic,
                               tiles=tiles), telemetry)


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
                 num_points: int, devs, perms, timer: PhaseTimer):
    """The camera-cluster plan of a TWO_LEVEL or MULTILEVEL Schur solve
    (JAX solve.py:587-628) and its host seconds, timed as the
    "coarse_plan" phase of `timer`; (None, None) for every other option.

    The coarse space is planned over the stable camera sort, the world-1
    stream, on every mesh: its clusters depend on the stream's order, so
    every mesh then solves with the world-1 coarse space (the JAX package
    plans the 2-D mesh's over its 2-D stream instead).  The plan is split
    over the mesh's devices `devs` (`perms`: each shard's edges in the
    caller's order, ops/segtiles.shard_cluster_plan).  It comes from the
    host plan cache (`cached_cluster_plan` / `cached_multilevel_plan`,
    keyed by that stream, the mask, the knobs and the shards), and a hit
    counts a `cluster_plan_cache_hit` event: the seconds returned are
    then the lookup's (the sort and the digests), not a planning's."""
    so = option.solver_option
    if not option.use_schur or so.precond not in (PrecondKind.TWO_LEVEL,
                                                  PrecondKind.MULTILEVEL):
        return None, None
    with timer.phase("coarse_plan"):
        t = time.perf_counter()
        canon = sort_edges_by_camera(cam_idx, num_cameras)
        at = np.empty_like(canon)
        at[canon] = np.arange(canon.shape[0])
        ci, pi, m = cam_idx[canon], pt_idx[canon], mask[canon]
        kw = dict(mask=m, smooth_omega=so.smooth_omega, devices=devs,
                  shards=[at[p] for p in perms])
        if so.precond == PrecondKind.TWO_LEVEL:
            (_, plan), hit = cached_cluster_plan(
                ci, pi, num_cameras, num_points, so.coarse_clusters, **kw)
        else:
            (_, plan), hit = cached_multilevel_plan(
                ci, pi, num_cameras, num_points, so.coarse_clusters,
                coarsen_factor=so.coarsen_factor, max_levels=so.max_levels,
                **kw)
        if hit:
            timer.count_event("cluster_plan_cache_hit")
        return plan, time.perf_counter() - t


def _tiles_block(mesh, cam_idx, pt_idx, mask, stream, shard_plans,
                 fused: bool) -> dict:
    """`SolveReport.tiles` of the port's plans (JAX solve.py:540-556):
    the slot occupancy of the edge stream, its streaming reuse
    (`edge_stream_reuse` over one-vertex tiles: the port's kernels gather
    one vertex row an edge) and, with fused kernels, each direction's
    slot tiles summed over this process's shards (`fused_plan_summary`'s
    keys)."""
    from megba_tpu_torch.ops.fused import SLOT_TILE
    from megba_tpu_torch.ops.segtiles import edge_stream_reuse

    n = int(stream.shape[0])
    info = {"plan": "mesh_2d" if mesh.is_2d else "csr_1d",
            "occupancy": round(float((mask > 0).sum()) / max(1, n), 4),
            **edge_stream_reuse(cam_idx[stream], pt_idx[stream], 1, 1,
                                mask=mask[stream])}
    if fused:
        for key in ("fused_to_pt", "fused_to_cam"):
            plans = [getattr(p, key) for p in shard_plans if p is not None]
            tiles = sum(int(f.tile_ptr.shape[0]) - 1 for f in plans)
            edges = sum(int(f.out.seg.shape[0]) for f in plans)
            info[key] = {"tiles": tiles, "tile": SLOT_TILE,
                         "occupancy": round(edges / max(1, tiles * SLOT_TILE),
                                            4),
                         "edges": edges, "slots": tiles * SLOT_TILE}
    return info


def _mesh_solve(mesh, cameras, points, obs, cam_idx, pt_idx, mask,
                option, sqrt_info, cam_fixed, pt_fixed, verbose,
                residual_jac_fn, initial_region, initial_v, initial_dx,
                fault_plan, fault_edge, timer, want_tiles=False):
    """The lowering of a solve over a mesh (JAX solve.py:408-500): the
    shards' edge streams and their plans (the "plan" phase of `timer`),
    the sharded coarse plan and fault plan and the arrays' moves to the
    devices ("lowering"), then `distributed_lm_solve` ("dispatch").
    Across processes only this process's shards are lowered, and the
    replicated state goes to its home device.  Returns (result, the
    `SolveReport.tiles` block or None)."""
    so = option.solver_option
    dtype = np.dtype(option.dtype)
    tdtype = DTYPE_TO_TORCH[dtype]
    devs = mesh.devices
    dev0 = mesh.home_device
    nc, npt = cameras.shape[0], points.shape[0]
    fused = bool(option.use_schur and so.fused_kernels)
    with timer.phase("plan"):
        # Both lowerings come from the host plan cache (keyed by the
        # graph and the mesh's devices); a hit and the evictions this
        # lookup caused are timer events, as in the JAX package.
        evict0 = plan_cache_evictions()
        tile_plan = None
        if mesh.is_2d:
            # The camera-tile plan's device blocks, real edges only, and
            # each block's dual plans.  Quantum 1: the JAX package pads
            # each column to a multiple of E * EDGE_QUANTUM for static
            # shapes, which on a small problem leaves whole edge shards
            # empty; the CSR plans need no padding, so each edge shard
            # takes an even piece of its column.
            (_, tile_plan, perms, shard_plans), hit = (
                cached_camera_tile_plan(
                    cam_idx, pt_idx, nc, npt, mesh.edge_shards,
                    mesh.cam_blocks, quantum=1, devices=devs, fused=fused))
        else:
            (perms, shard_plans), hit = cached_sharded_dual_plans(
                cam_idx, pt_idx, nc, npt, devs, fused=fused)
        if hit:
            timer.count_event("plan_cache_hit")
        evicted = plan_cache_evictions() - evict0
        if evicted:
            timer.count_event("plan_cache_evict", evicted)
        bounds = tuple(int(b) for b in np.cumsum([0] + [p.shape[0]
                                                        for p in perms]))
        stream = np.concatenate(perms)
    cluster_plan, plan_seconds = _coarse_plan(option, cam_idx, pt_idx, mask,
                                              nc, npt, devs, perms, timer)

    def per_shard(a: np.ndarray):
        """[nE, ...] caller order -> each shard's [F, n_k] rows (None for
        another process's shard)."""
        a = a.reshape(a.shape[0], -1)
        return globalize_for_mesh(
            mesh, lambda k: np.ascontiguousarray(a[perms[k]].T), EDGE_AXIS)

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
            per_shard(obs),
            tuple(None if p is None else p.cam.seg.long()
                  for p in shard_plans),
            globalize_for_mesh(
                mesh, lambda k: pt_idx[perms[k]].astype(np.int64), EDGE_AXIS),
            globalize_for_mesh(
                mesh, lambda k: mask[perms[k]].astype(dtype, copy=False),
                EDGE_AXIS))
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
    tiles = (_tiles_block(mesh, cam_idx, pt_idx, mask, stream, shard_plans,
                          fused) if want_tiles else None)
    return _edge_major(result, plan_seconds), tiles


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
        from megba_tpu_torch.native import degree_stats

        _, _, (max_cd, max_pd, nnz) = degree_stats(
            bal.cam_idx, bal.pt_idx, bal.num_cameras, bal.num_points)
        _obs.emit_problem_stats(bal.num_cameras, bal.num_points,
                                bal.num_observations, max_cd, max_pd, nnz)
    result = flat_solve(None, bal.cameras, bal.points, bal.obs, bal.cam_idx,
                        bal.pt_idx, option, verbose=verbose, device=device)
    solved = BALFile(
        cameras=result.cameras.detach().cpu().numpy().astype(np.float64),
        points=result.points.detach().cpu().numpy().astype(np.float64),
        obs=bal.obs, cam_idx=bal.cam_idx, pt_idx=bal.pt_idx)
    return solved, result

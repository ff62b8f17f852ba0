"""Batched solve of many independent BA problems: `solve_many`.

Counterpart of `megba_tpu/serving/batcher.py`.  Problems group by
(shape class, block dims, factor) (serving/shape_class.py); each group's
problems are padded to their bucket, stacked on a leading lane axis and
solved as ONE lane-batched LM (algo/lanes.py) through the bucket's
program (serving/compile_pool.py), so a fleet of N problems costs one
solve per bucket, not N.  Each lane stops on its own tests and freezes,
and per-problem status, trace and cost come back per lane.  Results are
returned in submission order; the dispatch queue (serving/queue.py)
reuses `_solve_bucket` for its batches.

A problem's result is bitwise the same whatever its batch-mates and the
lane count (algo/lanes.py says how): batching changes where a problem
computes, never what.

`solve_many(..., device=None)` runs on CUDA unless the caller passes
`device="cpu"` or an option with `Device.CPU`; with no card and no such
request it raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from megba_tpu_torch import observability as _obs
from megba_tpu_torch.common import (
    ProblemOption,
    resolve_device,
    status_name,
    strip_observability,
    validate_options,
)
from megba_tpu_torch.observability.trace import SolveTrace
from megba_tpu_torch.serving.compile_pool import CompilePool
from megba_tpu_torch.serving.shape_class import (
    BucketLadder,
    PaddedProblem,
    ShapeClass,
    classify,
    pad_to_class,
)
from megba_tpu_torch.serving.stats import FleetStats
from megba_tpu_torch.utils.timing import PhaseTimer, monotonic_s


@dataclasses.dataclass
class FleetProblem:
    """One independent BA problem of the fleet (edge-major host arrays,
    what `solve.flat_solve` takes).  `name` tags it through stats and
    telemetry.

    `fault_plan` (robustness.faults.FaultPlan, the problem's own edge
    order) puts its batch on the faulted bucket program, batch-mates on
    inert plans.  `edge_mask` ([nE] in [0, 1]), `cam_fixed` / `pt_fixed`
    are the problem's repair operands (robustness/triage.py), folded into
    the bucket's padding masks; `health` carries a triage HealthReport
    dict to the result and the telemetry.  `factor` names its registered
    residual family."""

    cameras: np.ndarray
    points: np.ndarray
    obs: np.ndarray
    cam_idx: np.ndarray
    pt_idx: np.ndarray
    name: str = ""
    fault_plan: Optional[Any] = None
    edge_mask: Optional[np.ndarray] = None
    cam_fixed: Optional[np.ndarray] = None
    pt_fixed: Optional[np.ndarray] = None
    health: Optional[Dict[str, Any]] = None
    factor: str = "bal"

    @classmethod
    def from_synthetic(cls, s, name: str = "",
                       factor: str = "bal") -> "FleetProblem":
        """Wrap a synthetic scene's initial parameters (any generator
        dataclass with cameras0 / points0 / obs / cam_idx / pt_idx)."""
        return cls(cameras=s.cameras0, points=s.points0, obs=s.obs,
                   cam_idx=s.cam_idx, pt_idx=s.pt_idx, name=name,
                   factor=factor)

    def dims(self) -> Tuple[int, int, int]:
        return (int(self.cameras.shape[0]), int(self.points.shape[0]),
                int(self.obs.shape[0]))


@dataclasses.dataclass
class FleetResult:
    """One problem's slice of a batched solve (host numpy, unpadded)."""

    name: str
    shape: ShapeClass
    lane: int
    lanes: int
    cameras: np.ndarray
    points: np.ndarray
    cost: np.ndarray
    initial_cost: np.ndarray
    iterations: int
    accepted: int
    pcg_iterations: int
    status: int
    recoveries: int
    latency_s: float
    trace: Optional[SolveTrace] = None
    deadline_missed: bool = False
    attempts: int = 1
    rung: int = 0
    history: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    health: Optional[Dict[str, Any]] = None

    @property
    def status_name(self) -> str:
        return status_name(self.status)


def _strip_telemetry(option: ProblemOption
                     ) -> Tuple[ProblemOption, Optional[str], ProblemOption]:
    """(option without observability knobs, the telemetry sink — the knob
    wins over MEGBA_TELEMETRY —, the option the reports state)."""
    telemetry = option.telemetry or os.environ.get("MEGBA_TELEMETRY") or None
    return strip_observability(option), telemetry, option


def _check_option(option: ProblemOption) -> None:
    """The JAX package's serving checks: `validate_options` and one
    device.  What its bucket program raises (`algo.lanes.
    check_lane_option`) comes from the bucket program here too, so a
    `FleetQueue` constructs and its futures carry the error."""
    validate_options(option)
    if option.world_size != 1:
        raise ValueError(
            "serving batches over a leading lane axis on a single "
            "program; world_size must be 1 (got "
            f"{option.world_size}) — shard the FLEET across hosts, not "
            "one problem across devices")


def _where(p: FleetProblem, index: int) -> str:
    return (f"FleetProblem {p.name!r}" if p.name
            else f"FleetProblem #{index}" if index >= 0
            else "FleetProblem")


def _problem_spec(p: FleetProblem, index: int = -1):
    """Resolve and dim-check a fleet problem's factor spec (typed
    `FactorError` at the ingestion boundary)."""
    from megba_tpu_torch.factors import get_factor
    from megba_tpu_torch.factors.registry import (
        require_schur,
        validate_factor_arrays,
    )

    where = _where(p, index)
    spec = require_schur(get_factor(p.factor), where)
    validate_factor_arrays(spec, p.cameras, p.points, p.obs, where=where)
    return spec


def _validate_problem(p: FleetProblem, index: int = -1,
                      option: Optional[ProblemOption] = None) -> None:
    """The ingestion gate (JAX batcher.py:182-221): the BAL parsers'
    semantic validation (duplicate edges only for `unique_edges`
    families), and a robust loss on a `robust_ok=False` family refused
    typed; skipped when a triage record says its structural pass ran."""
    spec = _problem_spec(p, index)
    if option is not None and not spec.robust_ok:
        from megba_tpu_torch.common import RobustKind
        from megba_tpu_torch.factors.registry import FactorError

        if option.robust_kind != RobustKind.NONE:
            raise FactorError(
                f"factor {spec.name!r} is not robust-kernel eligible "
                "(robust_ok=False — e.g. a marginalization prior must "
                "not be IRLS-downweighted); submit it under "
                "robust_kind=NONE")
    if p.health is not None and p.health.get("structural", False):
        return
    from megba_tpu_torch.io.bal import validate_problem

    validate_problem(p.cameras, p.points, p.obs, p.cam_idx, p.pt_idx,
                     where=_where(p, index), unique_edges=spec.unique_edges)


def _group_by_bucket(problems: Sequence[FleetProblem], option: ProblemOption,
                     ladder: BucketLadder):
    """Index-preserving grouping: (shape, (cd, pd, od), factor) ->
    [(i, problem)]."""
    groups: Dict[Tuple, List[Tuple[int, FleetProblem]]] = {}
    for i, p in enumerate(problems):
        n_cam, n_pt, n_edge = p.dims()
        sc = classify(n_cam, n_pt, n_edge, option.dtype, ladder)
        dims = (int(p.cameras.shape[1]), int(p.points.shape[1]),
                int(p.obs.shape[1]))
        groups.setdefault((sc, dims, p.factor), []).append((i, p))
    return groups


def _stack_bucket(padded: Sequence[PaddedProblem], lanes: int, dtype):
    """Stack padded problems into lane operands (feature-major).  Lane
    padding to the lane ladder repeats lane 0: it converges as its
    original does, so it never extends the batch, and is dropped."""
    idx = list(range(len(padded))) + [0] * (lanes - len(padded))
    cams = np.stack([np.ascontiguousarray(padded[k].cameras.T) for k in idx])
    pts = np.stack([np.ascontiguousarray(padded[k].points.T) for k in idx])
    obs = np.stack([np.ascontiguousarray(padded[k].obs.T) for k in idx])
    cam_idx = np.stack([padded[k].cam_idx for k in idx])
    pt_idx = np.stack([padded[k].pt_idx for k in idx])
    mask = np.stack([padded[k].mask for k in idx]).astype(dtype)
    cam_fixed = np.stack([padded[k].cam_fixed for k in idx])
    pt_fixed = np.stack([padded[k].pt_fixed for k in idx])
    return cams, pts, obs, cam_idx, pt_idx, mask, cam_fixed, pt_fixed


def _phase_delta(before: Dict[str, Any], after: Dict[str, Any]):
    """This batch's slice of a cumulative PhaseTimer (zero deltas
    dropped)."""
    out: Dict[str, Any] = {}
    for name, v in after.items():
        b = before.get(name, {"total_s": 0.0, "calls": 0})
        d = {"total_s": v["total_s"] - b["total_s"],
             "calls": v["calls"] - b["calls"]}
        if d["total_s"] or d["calls"]:
            out[name] = d
    return out


def _solve_bucket(
    items: Sequence[Tuple[int, FleetProblem]],
    shape: ShapeClass,
    option: ProblemOption,
    engine,
    ladder: BucketLadder,
    pool: CompilePool,
    stats: FleetStats,
    timer: PhaseTimer,
    telemetry: Optional[str],
    report_option: ProblemOption,
    *,
    initial_region: Optional[float] = None,
    rung: int = 0,
    attempts: int = 1,
    factor: str = "bal",
    device=None,
) -> List[Tuple[int, FleetResult]]:
    """Solve one bucket's problems in one lane-batched solve.

    `initial_region` overrides the option's trust-region start (the
    escalation ladder's damping inflation, an operand of the same
    program); `rung` / `attempts` are stamped onto results and
    telemetry.  Any item with a `fault_plan` puts the batch on the
    faulted program, the others on inert plans.  `device` is the
    resolved torch device.  The observability plane (host only; a batch
    launches the same kernels and gives the same bits either way): with
    `MEGBA_TRACE` the dispatch is a `solve_bucket` span, and with the
    metrics plane armed it feeds the `megba_fleet_*` series and each
    problem's `megba_solve_*` series (JAX batcher.py:315-322, 392-460).
    """
    n_real = len(items)
    lanes = ladder.bucket_lanes(n_real)
    recorder = _obs.span_recorder()
    span_scope = (contextlib.nullcontext() if recorder is None
                  else recorder.span("solve_bucket", bucket=str(shape),
                                     factor=factor, lanes=lanes,
                                     problems=n_real, rung=rung))
    with span_scope:
        return _solve_bucket_inner(
            items, shape, option, engine, pool, stats, timer, telemetry,
            report_option, initial_region=initial_region, rung=rung,
            attempts=attempts, factor=factor, device=device, lanes=lanes)


def _solve_bucket_inner(items, shape, option, engine, pool, stats, timer,
                        telemetry, report_option, *, initial_region, rung,
                        attempts, factor, device, lanes
                        ) -> List[Tuple[int, FleetResult]]:
    dtype = np.dtype(option.dtype)
    n_real = len(items)
    phases_before = timer.as_dict()
    faulted = any(p.fault_plan is not None for _, p in items)
    with timer.phase("lowering"):
        padded = [pad_to_class(p.cameras, p.points, p.obs, p.cam_idx,
                               p.pt_idx, shape, edge_mask=p.edge_mask,
                               cam_fixed=p.cam_fixed, pt_fixed=p.pt_fixed)
                  for _, p in items]
        operands = _stack_bucket(padded, lanes, dtype)
        plan_stack = None
        if faulted:
            from megba_tpu_torch.robustness.faults import (
                inert_fault_plan,
                lower_fault_plan,
                stack_fault_plans,
            )

            plans = []
            for (_, p), pp in zip(items, padded):
                if p.fault_plan is None:
                    plans.append(inert_fault_plan(
                        shape.n_edge, shape.n_pt, dtype))
                else:
                    plans.append(lower_fault_plan(
                        p.fault_plan, n_edges=shape.n_edge,
                        n_points=shape.n_pt, dtype=dtype, perm=pp.perm))
            # Lane padding repeats lane 0's operands, so its plan too.
            plans.extend(plans[0] for _ in range(lanes - len(plans)))
            plan_stack = stack_fault_plans(plans)
    cd, pd, od = (operands[0].shape[1], operands[1].shape[1],
                  operands[2].shape[1])

    with timer.phase("program"):
        program = pool.program(engine, option, shape, lanes, cd, pd, od,
                               faulted=faulted, factor=factor, device=device)
    ir = (option.algo_option.initial_region if initial_region is None
          else initial_region)

    t0 = monotonic_s()
    with timer.phase("dispatch"):
        solved = program(*operands, ir, 2.0, plan_stack, device=device)
    with timer.phase("execute"):
        cams_h = solved.cameras.T.cpu().numpy()
        pts_h = solved.points.T.cpu().numpy()
    wall = monotonic_s() - t0

    edges_real = sum(p.n_edge for p in padded)
    stats.record_batch(str(shape), lanes, n_real, edges_real,
                       shape.n_edge, wall)
    registry = _obs.metrics_registry(report_option.metrics)
    if registry is not None:
        _observe_batch(registry, str(shape), factor, rung, lanes, n_real,
                       edges_real, shape.n_edge, wall)

    out: List[Tuple[int, FleetResult]] = []
    for lane, ((orig_i, prob), pp) in enumerate(zip(items, padded)):
        res = solved.results[lane]
        c0 = lane * shape.n_cam
        p0 = lane * shape.n_pt
        fr = FleetResult(
            name=prob.name,
            shape=shape,
            lane=lane,
            lanes=lanes,
            cameras=cams_h[c0:c0 + pp.n_cam].copy(),
            points=pts_h[p0:p0 + pp.n_pt].copy(),
            cost=np.asarray(res.cost.numpy()),
            initial_cost=np.asarray(res.initial_cost.numpy()),
            iterations=int(res.iterations),
            accepted=int(res.accepted),
            pcg_iterations=int(res.pcg_iterations),
            status=int(res.status),
            recoveries=int(res.recoveries),
            latency_s=wall,
            trace=res.trace,
            rung=rung,
            attempts=attempts,
            health=prob.health,
        )
        out.append((orig_i, fr))
        if registry is not None:
            _observe_lane(registry, str(shape), factor, fr)
        if telemetry:
            from megba_tpu_torch.observability.report import (
                append_report,
                build_report,
            )

            problem_shape = {
                "num_cameras": pp.n_cam,
                "num_points": pp.n_pt,
                "num_edges": pp.n_edge,
                "num_edges_padded": shape.n_edge,
                "world_size": 1,
            }
            fleet = {
                "name": prob.name,
                "bucket": str(shape),
                "lane": lane,
                "lanes": lanes,
                "batch_problems": n_real,
                "latency_s": wall,
                "batch_problems_per_sec": n_real / wall if wall > 0 else 0.0,
                "rung": rung,
                "attempts": attempts,
                "stats": stats.as_dict(),
            }
            # A federation worker (serving/worker.py) tags its reports, so
            # a merged multi-worker stream stays attributable.
            fed_worker = os.environ.get("MEGBA_FEDERATION_WORKER")
            if fed_worker:
                fleet["worker"] = fed_worker
            append_report(
                build_report(report_option, res,
                             _phase_delta(phases_before, timer.as_dict()),
                             problem_shape, fleet=fleet, health=prob.health,
                             device=device), telemetry)
    return out


def _observe_batch(registry, bucket: str, factor: str, rung: int,
                   lanes: int, n_real: int, edges_real: int, n_edge: int,
                   wall: float) -> None:
    """One dispatch's `megba_fleet_*` series (JAX batcher.py:392-419)."""
    from megba_tpu_torch.observability.metrics import RATIO_BUCKETS

    registry.counter(
        "megba_fleet_batches_total",
        "Batched dispatches per (bucket, factor, rung)").inc(
            1, bucket=bucket, factor=factor, rung=rung)
    registry.counter(
        "megba_fleet_problems_total",
        "Problems solved per (bucket, factor)").inc(
            n_real, bucket=bucket, factor=factor)
    registry.histogram(
        "megba_fleet_batch_latency_seconds",
        "Batch dispatch+execute wall clock").observe(
            wall, bucket=bucket, factor=factor)
    registry.histogram(
        "megba_fleet_lane_fill_ratio",
        "Real lanes / dispatched lanes per batch",
        buckets=RATIO_BUCKETS).observe(n_real / lanes, bucket=bucket)
    registry.histogram(
        "megba_fleet_edge_fill_ratio",
        "Real edges / padded edge capacity per batch",
        buckets=RATIO_BUCKETS).observe(
            edges_real / (lanes * n_edge), bucket=bucket)


def _observe_lane(registry, bucket: str, factor: str,
                  fr: FleetResult) -> None:
    """One problem's `megba_solve_*` series (JAX batcher.py:443-460)."""
    from megba_tpu_torch.observability.metrics import ITER_BUCKETS

    registry.histogram(
        "megba_solve_lm_iterations", "LM iterations per solved problem",
        buckets=ITER_BUCKETS).observe(fr.iterations, bucket=bucket,
                                      factor=factor)
    registry.histogram(
        "megba_solve_pcg_iterations",
        "Total PCG iterations per solved problem",
        buckets=ITER_BUCKETS).observe(fr.pcg_iterations, bucket=bucket,
                                      factor=factor)
    registry.counter(
        "megba_solve_status_total",
        "Solve outcomes by SolveStatus name").inc(
            1, status=fr.status_name, bucket=bucket)


def solve_many(
    problems: Sequence[FleetProblem],
    option: Optional[ProblemOption] = None,
    *,
    ladder: Optional[BucketLadder] = None,
    pool: Optional[CompilePool] = None,
    stats: Optional[FleetStats] = None,
    timer: Optional[PhaseTimer] = None,
    device=None,
) -> List[FleetResult]:
    """Solve many independent BA problems through lane-batched bucket
    solves; results come back in submission order.

    Problems group by shape class (the ladder-padded (n_cam, n_pt,
    n_edge, dtype)), block dims and factor; each group is one
    lane-batched solve.  Each result carries the problem's own
    `SolveStatus`, cost and trace, bitwise independent of its
    batch-mates.  `ladder` / `pool` / `stats` default to fresh
    instances; a long-lived service passes its own.  Telemetry (the
    option's knob or MEGBA_TELEMETRY) appends one SolveReport per
    problem with a `fleet` block.  `device`: see the module docstring.
    """
    option = option or ProblemOption()
    _check_option(option)
    for i, p in enumerate(problems):
        _validate_problem(p, i, option)
    option, telemetry, report_option = _strip_telemetry(option)
    dev = resolve_device(device, option)
    ladder = ladder or BucketLadder()
    stats = stats or FleetStats()
    pool = pool or CompilePool(stats=stats)
    timer = PhaseTimer() if timer is None else timer
    from megba_tpu_torch.factors import engine_for

    results: List[Optional[FleetResult]] = [None] * len(problems)
    for (shape, _dims, factor), items in _group_by_bucket(
            problems, option, ladder).items():
        engine = engine_for(factor, option.jacobian_mode)
        for orig_i, fr in _solve_bucket(
                items, shape, option, engine, ladder, pool, stats, timer,
                telemetry, report_option, factor=factor, device=dev):
            results[orig_i] = fr
    return results  # type: ignore[return-value]

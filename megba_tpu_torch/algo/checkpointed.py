"""Preemption-safe solve drivers: LM in chunks with on-disk snapshots.

Counterpart of `megba_tpu/algo/checkpointed.py`, with its snapshot
format and semantics.  The LM loop runs in chunks of `checkpoint_every`
iterations; between chunks the full resume state (parameters, trust
region, back-off factor, warm-start step, iteration count, the
accepted / PCG / recovery totals and the stitched trace) is written
atomically (utils/checkpoint.py), and the drivers resume from an
existing snapshot transparently after a topology-fingerprint check.  A
snapshot written by the JAX package for the same problem resumes here,
and the other way round.

One chunk loop (`_run_chunked`) serves both model families:
`solve_checkpointed` (BA, each chunk one `solve.flat_solve`) and
`solve_pgo_checkpointed` (pose graphs, each chunk one
`models.pgo.solve_pgo`).  Each chunk lowers its problem afresh and
starts with a linearisation at the carried parameters; a BA chunk after
the first takes its plans from the host plan cache
(ops/segtiles.cached_*, as the JAX package's chunks do), so only the
arrays' conversions and moves are repeated.  The only device sync the
driver adds is one device-to-host copy a chunk of the parameters and
the resume scalars.

`elastic=` (robustness/elastic.ElasticConfig or ElasticMonitor) bounds
every chunk dispatch of a multi-process solve: peers are checked for
liveness at each chunk boundary and the chunk runs under the monitor's
watchdog, so a dead or hung peer surfaces as a typed `WorkerLost` /
`CollectiveTimeout` instead of a block; the last snapshot is then the
recovery line of `robustness.elastic.resume_elastic`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from megba_tpu_torch.algo.lm import LMResult, derive_status
from megba_tpu_torch.common import ProblemOption, SolveStatus
from megba_tpu_torch.observability.trace import (
    TRACE_FIELDS,
    SolveTrace,
    trace_concat,
    trace_filler,
    trace_slice,
)
from megba_tpu_torch.utils.checkpoint import load_state, save_state


def _topology_fingerprint(cameras, points, cam_idx, pt_idx) -> np.ndarray:
    """[Nc, Np, nE, blake2b(cam_idx), blake2b(pt_idx)] as int64 — cheap,
    order-sensitive identity of the problem graph, over the index arrays
    as int32 (the JAX package's, so either package's snapshot passes the
    other's check for the same problem)."""

    def h(a):
        digest = hashlib.blake2b(
            np.ascontiguousarray(np.asarray(a, np.int32)).tobytes(),
            digest_size=8).digest()
        return int.from_bytes(digest, "little", signed=True)

    return np.asarray(
        [cameras.shape[0], points.shape[0], np.asarray(cam_idx).shape[0],
         h(cam_idx), h(pt_idx)], np.int64)


def _replace(result, **fields):
    """dataclasses.replace / NamedTuple._replace, whichever applies."""
    if dataclasses.is_dataclass(result):
        return dataclasses.replace(result, **fields)
    return result._replace(**fields)


def _host_copy(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Tensors of one device as host arrays through ONE device-to-host
    copy: flattened and concatenated on the device, split on the host,
    each back in its own dtype (exact: the concatenation only widens)."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(flat[at:at + n].reshape(tuple(t.shape)).astype(dtype))
        at += n
    return out


def _chunk_state(result, params: List[torch.Tensor], dx=None):
    """(host params, host resume scalars) of a finished chunk, from one
    device-to-host copy: the parameters, the warm-start step if any,
    the trust region, the back-off factor and the final and first
    costs."""
    tensors = list(params) + ([] if dx is None else [dx]) + [
        result.region.reshape(1), result.v.reshape(1),
        result.cost.reshape(1), result.initial_cost.reshape(1)]
    host = _host_copy(tensors)
    region, v, cost, c0 = (float(a[0]) for a in host[-4:])
    return host[:len(params)], dict(
        region=region, v=v, cost=cost, initial_cost=c0,
        dx=None if dx is None else host[len(params)])


def _run_chunked(solve_chunk: Callable, params, dump_params: Callable,
                 load_params: Callable, topo: np.ndarray, total: int,
                 checkpoint_path: str, checkpoint_every: int,
                 world_size: int = 1, process_index: int = 0,
                 elastic=None):
    """The shared chunk loop: resume, solve in chunks, snapshot, aggregate.

    `solve_chunk(params, max_iter, region, v, dx, done) -> (result,
    new_params, state)` runs up to `max_iter` LM iterations from
    `params` with the given trust-region resume state (None, None on a
    fresh start; `dx` the warm-start resume state, the previous chunk's
    last accepted step, None when unknown or warm starts are off;
    `done` the GLOBAL iteration the chunk starts at, so a fault plan's
    window stays in whole-solve iterations).  `result` exposes
    iterations / accepted / pcg_iterations / stopped (and status,
    recoveries, trace where the family has them); `state` holds the
    chunk's host scalars `region`, `v`, `cost`, `initial_cost` and its
    host `dx` (or None).  `dump_params(params)` returns the two arrays
    the snapshot format stores; `load_params(st)` inverts it.

    `world_size` / `process_index` are stamped into every snapshot's
    schema-v3 world header; a resume at another world size warns and is
    recorded as a reshard on `elastic`.

    `elastic` (robustness.elastic.ElasticMonitor, started) bounds every
    chunk dispatch: peers are checked at each chunk boundary and the
    chunk runs under `ElasticMonitor.guard`, so a dead or hung peer
    surfaces as a typed `WorkerLost` / `CollectiveTimeout` within the
    budget.  The chunk whose dispatch died is never snapshotted: the
    previous chunk's snapshot is the recovery line.  A chunk's result
    is on the host once `solve_chunk` returns (its state is copied
    there), so its whole execution lies inside the guard.
    """
    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")

    def dispatch(label, *chunk_args):
        if elastic is None:
            return solve_chunk(*chunk_args)
        elastic.check_peers(label=label)
        # grace_key = the chunk's iteration count: the first dispatch of
        # each kind (a short final chunk, the 0-iteration evaluate) gets
        # the first-dispatch grace.
        return elastic.guard(label, solve_chunk, *chunk_args,
                             grace_key=("chunk", chunk_args[1]))
    done = 0
    region = v = dx = None
    accepted_total = pcg_total = recoveries_total = 0
    fatal_total = False
    first_cost = None
    already_stopped = False
    # Per-chunk trace slices, stitched into one whole-solve SolveTrace at
    # the end and persisted in each snapshot, so a resumed solve reports
    # the history a straight run would.
    trace_parts = []

    # Problem identity guard: a foreign snapshot with mismatched shapes
    # would otherwise be resumed into garbage.  The graph topology is
    # summarised by an order-sensitive hash of the index arrays.
    if os.path.exists(checkpoint_path):
        st = load_state(checkpoint_path, expect_world_size=world_size)
        saved_ws = st.get("world_size")
        if (elastic is not None and saved_ws is not None
                and int(saved_ws) != int(world_size)):
            # A shrink-world resume through the driver directly (without
            # resume_elastic's own bookkeeping) is still a reshard.
            elastic.record_reshard(int(saved_ws), int(world_size))
        saved_topo = st.get("extra_topology")
        if saved_topo is None or not np.array_equal(
                np.asarray(saved_topo), topo):
            raise ValueError(
                f"checkpoint {checkpoint_path!r} was written for a "
                f"different problem (topology fingerprint "
                f"{None if saved_topo is None else np.asarray(saved_topo).tolist()} "
                f"!= {topo.tolist()}); refusing to resume — delete the "
                "snapshot or point checkpoint_path elsewhere")
        params = load_params(st)
        region = float(st["region"])
        v = float(st["extra_v"])
        done = int(st["iteration"])
        accepted_total = int(st.get("extra_accepted", 0))
        pcg_total = int(st.get("extra_pcg", 0))
        recoveries_total = int(st.get("extra_recoveries", 0))
        fatal_total = bool(st.get("extra_fatal", False))
        if "extra_first_cost" in st:
            first_cost = float(st["extra_first_cost"])
        already_stopped = bool(st.get("extra_stopped", False))
        if "extra_dx" in st:
            dx = np.asarray(st["extra_dx"])
        if "extra_trace_cost" in st:
            # Fields added after a snapshot was written get inert NaN
            # history for the pre-resume iterations.
            filler = trace_filler(
                int(np.asarray(st["extra_trace_cost"]).shape[0]))
            trace_parts.append(SolveTrace(**{
                f: (torch.from_numpy(np.asarray(st[f"extra_trace_{f}"]))
                    if f"extra_trace_{f}" in st else getattr(filler, f))
                for f in TRACE_FIELDS}))
        elif done:
            # A snapshot without a trace: pad the unknowable pre-resume
            # iterations so the stitched trace still lines up with
            # `iterations`.
            trace_parts.append(trace_filler(done))

    result = None
    while not already_stopped and done < total:
        chunk = min(checkpoint_every, total - done)
        result, params, state = dispatch(f"chunk@iter{done}", params,
                                         chunk, region, v, dx, done)
        region, v = state["region"], state["v"]
        if state["dx"] is not None:
            dx = state["dx"]
        if first_cost is None:
            first_cost = state["initial_cost"]
        accepted_total += int(result.accepted)
        pcg_total += int(result.pcg_iterations)
        if getattr(result, "recoveries", None) is not None:
            recoveries_total += int(result.recoveries)
        if getattr(result, "status", None) is not None:
            # Fatality is sticky across chunk boundaries: the snapshot
            # records it, so a resumed fatal solve stays fatal.
            fatal_total = fatal_total or (
                int(result.status) == int(SolveStatus.FATAL_NONFINITE))
        ran = int(result.iterations)
        done += ran
        stopped = bool(result.stopped) or ran < chunk
        arr_a, arr_b = dump_params(params)
        extra = {"v": np.asarray(v),
                 "accepted": np.asarray(accepted_total),
                 "pcg": np.asarray(pcg_total),
                 "recoveries": np.asarray(recoveries_total),
                 "fatal": np.asarray(fatal_total),
                 "first_cost": np.asarray(float(first_cost)),
                 "stopped": np.asarray(stopped),
                 "topology": topo}
        if dx is not None:
            # Warm-start resume state (SolverOption.warm_start).
            extra["dx"] = dx
        chunk_trace = getattr(result, "trace", None)
        if chunk_trace is not None:
            # Only the iterations this chunk ran; the accumulated history
            # (a few scalars an LM iteration) goes into the snapshot.
            trace_parts.append(trace_slice(chunk_trace, ran))
            acc = trace_concat(trace_parts)
            extra.update({f"trace_{f}": getattr(acc, f)
                          for f in TRACE_FIELDS})
        save_state(
            checkpoint_path, arr_a, arr_b,
            region=region, cost=state["cost"], iteration=done,
            world_size=world_size, process_index=process_index,
            extra=extra)
        if stopped:
            break  # converged (possibly exactly on the chunk boundary)

    if result is None:  # resumed at/past total (or converged): evaluate
        result, params, state = dispatch(f"evaluate@iter{done}", params,
                                         0, region, v, dx, done)
        if first_cost is None:
            first_cost = state["initial_cost"]
        if already_stopped:
            result = _replace(result, stopped=True)

    # Whole-solve aggregates, not last-chunk ones.
    fields = dict(
        initial_cost=torch.tensor(first_cost, dtype=result.cost.dtype,
                                  device=result.cost.device),
        iterations=done, accepted=accepted_total, pcg_iterations=pcg_total)
    if getattr(result, "trace", None) is not None:
        fields["trace"] = trace_concat(trace_parts)
    if getattr(result, "status", None) is not None:
        # A fatal chunk keeps the solve fatal; recoveries in any chunk
        # mark it recovered; converged / max_iter / stalled re-derive
        # from the whole-solve aggregates.
        fatal = fatal_total or (
            int(result.status) == int(SolveStatus.FATAL_NONFINITE))
        fields["status"] = derive_status(
            stopped=bool(result.stopped), accepted=accepted_total,
            recoveries=recoveries_total, fatal=fatal)
        if getattr(result, "recoveries", None) is not None:
            fields["recoveries"] = recoveries_total
    return _replace(result, **fields)


def _process_index() -> int:
    """This process's rank in the process group (0 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _chunk_option(option: ProblemOption, max_iter: int) -> ProblemOption:
    return dataclasses.replace(
        option, algo_option=dataclasses.replace(option.algo_option,
                                                max_iter=max_iter))


def solve_checkpointed(
    residual_jac_fn: Optional[Callable],
    cameras: np.ndarray,
    points: np.ndarray,
    obs: np.ndarray,
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    option: ProblemOption,
    checkpoint_path: str,
    checkpoint_every: int = 5,
    verbose: bool = False,
    elastic=None,
    **solve_kwargs,
) -> LMResult:
    """Run the BA LM solve, snapshotting every `checkpoint_every` iters.

    The arguments are the JAX package's, in its order (its
    checkpointed.py:284): `solve.flat_solve`'s engine (or None), arrays
    and option, then the snapshot path; if `checkpoint_path` exists the
    solve resumes from it (after checking that it was written for this
    problem's graph).  Extra keywords flow to `flat_solve` (sqrt_info,
    edge_mask, cam_fixed, pt_fixed, device, factor, triage, timer...); a
    `fault_plan`'s window is in whole-solve iterations and is re-offset
    each chunk.  The result is the last chunk's, with the whole solve's
    initial cost, counts, status, recoveries and stitched trace.

    `elastic` (robustness.elastic.ElasticConfig or ElasticMonitor) arms
    the elastic contract of a multi-process solve: this rank beats, every
    chunk dispatch is bounded by the monitor, and a dead or hung peer
    raises a typed `WorkerLost` / `CollectiveTimeout` at the chunk
    boundary; the latest snapshot is then the recovery line of
    `robustness.elastic.resume_elastic`.  With telemetry on, each chunk's
    SolveReport carries the monitor's counters (`SolveReport.elastic`).
    """
    from megba_tpu_torch.robustness.elastic import ElasticMonitor
    from megba_tpu_torch.robustness.faults import with_offset
    from megba_tpu_torch.solve import flat_solve

    monitor, owned = ElasticMonitor.ensure(elastic)
    fault_plan = solve_kwargs.pop("fault_plan", None)

    def solve_chunk(params, max_iter, region, v, dx, done):
        cams, pts = params
        kwargs = dict(solve_kwargs)
        if fault_plan is not None:
            kwargs["fault_plan"] = with_offset(fault_plan, done)
        if monitor is not None:
            # The chunk's report carries a snapshot of the elastic ledger
            # (the aggregator keeps the last one per monitor).
            kwargs["elastic_report"] = monitor.report_block()
        result = flat_solve(
            residual_jac_fn, cams, pts, obs, cam_idx, pt_idx,
            _chunk_option(option, max_iter),
            verbose=verbose, initial_region=region, initial_v=v,
            initial_dx=dx, **kwargs)
        host, state = _chunk_state(result, [result.cameras, result.points],
                                   result.dx_cam)
        return result, tuple(host), state

    cam_dtype = np.asarray(cameras).dtype
    pt_dtype = np.asarray(points).dtype
    try:
        return _run_chunked(
            solve_chunk,
            params=(cameras, points),
            dump_params=lambda p: (p[0], p[1]),
            load_params=lambda st: (np.asarray(st["cameras"], cam_dtype),
                                    np.asarray(st["points"], pt_dtype)),
            topo=_topology_fingerprint(cameras, points, cam_idx, pt_idx),
            total=option.algo_option.max_iter,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every,
            world_size=option.world_size,
            process_index=_process_index(),
            elastic=monitor,
        )
    finally:
        if owned:
            monitor.stop()


def solve_pgo_checkpointed(
    poses0: np.ndarray,
    edge_i: np.ndarray,
    edge_j: np.ndarray,
    meas: np.ndarray,
    option: ProblemOption,
    checkpoint_path: str,
    checkpoint_every: int = 5,
    verbose: bool = False,
    elastic=None,
    **solve_kwargs,
):
    """Preemption-safe chunked pose-graph solve (models/pgo.solve_pgo).

    The contract of `solve_checkpointed`: chunks of `checkpoint_every`
    LM iterations, atomic snapshots of the resume state between chunks,
    transparent resume after a topology-fingerprint check.  Extra
    keywords flow to `solve_pgo` (sqrt_info, fixed, factor, device...).
    The pose table takes the snapshot's "cameras" slot; "points" holds
    an empty placeholder.  `elastic` bounds the chunk dispatches as in
    `solve_checkpointed` (the pose-graph family writes no SolveReport,
    so there is no per-chunk elastic block).
    """
    from megba_tpu_torch.models.pgo import solve_pgo
    from megba_tpu_torch.robustness.elastic import ElasticMonitor

    monitor, owned = ElasticMonitor.ensure(elastic)

    def solve_chunk(params, max_iter, region, v, dx, done):
        # The pose-graph loop has no cross-chunk warm-start operand.
        del dx, done
        result = solve_pgo(
            params, edge_i, edge_j, meas, _chunk_option(option, max_iter),
            verbose=verbose, initial_region=region, initial_v=v,
            **solve_kwargs)
        (poses,), state = _chunk_state(result, [result.poses])
        return result, poses, state

    poses = np.asarray(poses0)
    try:
        return _run_chunked(
            solve_chunk,
            params=poses,
            dump_params=lambda p: (p, np.zeros((0, 1))),
            load_params=lambda st: np.asarray(st["cameras"]),
            topo=_topology_fingerprint(poses, np.zeros((0, 1)), edge_i,
                                       edge_j),
            total=option.algo_option.max_iter,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every,
            world_size=option.world_size,
            process_index=_process_index(),
            elastic=monitor,
        )
    finally:
        if owned:
            monitor.stop()

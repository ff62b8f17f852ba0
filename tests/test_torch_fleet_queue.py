"""The port's fleet queue and its resilience layer (serving/queue.py,
serving/resilience.py, serving/stats.py, the fault-plan lowering and the
dispatch chaos of robustness/faults.py), ported from the JAX package's
tests/test_fleet_resilience.py and tests/test_serving.py.

The host-side state machines run with injected clocks; the queue runs
real lane-batched solves on the CPU (small scenes, a few seconds in
all): deadline shed, admission RAISE / BLOCK, the breaker's trip,
fast-fail and half-open recovery, flush / close drain, a failed batch
that leaves the queue serving, the escalation ladder healing a poisoned
problem at rung 1 with its clean batch-mates bitwise equal to
`solve_many`, twelve submitter threads, and `submit(triage=)` REJECT with
no dispatch.
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

import megba_tpu.serving as js
from megba_tpu.common import ProblemOption as JProblemOption

from megba_tpu_torch.common import (
    AlgoOption,
    Device,
    PrecondKind,
    PreconditionerKind,
    ProblemOption,
    SolverOption,
    SolveStatus,
    status_retryable,
)
from megba_tpu_torch.io.synthetic import make_synthetic_bal
from megba_tpu_torch.robustness.faults import (
    DispatchChaos,
    FaultPlan,
    InjectedDispatchError,
    close_fault_window,
    inert_fault_plan,
    lower_fault_plan,
    make_nan_burst,
    stack_fault_plans,
)
from megba_tpu_torch.robustness.triage import (
    ProblemRejected,
    TriageAction,
    TriagePolicy,
)
from megba_tpu_torch.serving import (
    BreakerPolicy,
    BreakerState,
    BucketTripped,
    CircuitBreaker,
    DeadlineExceeded,
    EscalationPolicy,
    FleetProblem,
    FleetQueue,
    FleetStats,
    QueueRejected,
    RejectPolicy,
    solve_many,
)

OPT64 = ProblemOption(dtype=np.float64, device=Device.CPU,
                      algo_option=AlgoOption(max_iter=6),
                      solver_option=SolverOption(max_iter=12, tol=1e-10))
TERMINAL = {int(s) for s in SolveStatus}


def _mk(seed, n_pt=24, n_cam=4):
    s = make_synthetic_bal(num_cameras=n_cam, num_points=n_pt,
                           obs_per_point=3, seed=seed, param_noise=2e-2,
                           pixel_noise=0.3, dtype=np.float64)
    return FleetProblem.from_synthetic(s, name=f"s{seed}_p{n_pt}")


def _poison(problem: FleetProblem, edges=(3, 17)) -> FleetProblem:
    """NaN burst on the pre-loop linearisation (window [0, 1)): guards
    off, the carried cost is NaN and every trial is rejected (STALLED);
    guards on, the adoption path heals it (RECOVERED)."""
    plan = make_nan_burst(problem.obs.shape[0], list(edges), start=0,
                          stop=1, n_points=problem.points.shape[0],
                          dtype=np.float64)
    return dataclasses.replace(problem, fault_plan=plan,
                               name=problem.name + "_poisoned")


def _bits(r):
    return (r.cameras.tobytes(), r.points.tobytes(), r.cost.tobytes(),
            r.iterations, r.status, r.trace.cost.numpy().tobytes())


# ---------------------------------------------------------------------------
# EscalationPolicy, retry predicate, breaker (pure host)
# ---------------------------------------------------------------------------


def test_escalation_rung_transforms_are_cumulative():
    pol = EscalationPolicy()
    base = ProblemOption(
        dtype=np.float32,
        solver_option=SolverOption(max_iter=30, forcing=True,
                                   warm_start=True,
                                   precond=PrecondKind.NEUMANN,
                                   preconditioner=(
                                       PreconditionerKind.SCHUR_DIAG)))
    assert pol.option_for_rung(base, 0) == base
    r1 = pol.option_for_rung(base, 1)
    assert r1.robust_option.guards
    assert r1.solver_option == base.solver_option
    r2 = pol.option_for_rung(base, 2)
    assert r2.robust_option.guards
    assert r2.solver_option.precond == PrecondKind.JACOBI
    assert r2.solver_option.preconditioner == PreconditionerKind.HPP
    assert not r2.solver_option.forcing and not r2.solver_option.warm_start
    assert r2.solver_option.max_iter == 60
    assert np.dtype(r2.dtype) == np.float32
    r3 = pol.option_for_rung(base, 3)
    assert np.dtype(r3.dtype) == np.float64 and r3.robust_option.guards
    with pytest.raises(ValueError):
        pol.option_for_rung(base, 4)
    assert pol.initial_region_for_rung(base, 0) is None
    assert pol.initial_region_for_rung(base, 1) == pytest.approx(
        base.algo_option.initial_region / pol.damping_deflation)


def test_escalation_backoff_deterministic_and_equal_to_jax():
    a = EscalationPolicy(seed=7, backoff_base_s=0.02, backoff_factor=2.0,
                         backoff_jitter=0.5)
    ja = js.EscalationPolicy(seed=7, backoff_base_s=0.02,
                             backoff_factor=2.0, backoff_jitter=0.5)
    seq = [a.backoff_s(s, k) for s in range(4) for k in (1, 2, 3)]
    assert seq == [ja.backoff_s(s, k) for s in range(4) for k in (1, 2, 3)]
    assert any(a.backoff_s(s, 1) != EscalationPolicy(seed=8).backoff_s(s, 1)
               for s in range(4))
    for s in range(8):
        for attempt in (1, 2, 3):
            base = 0.02 * 2.0 ** (attempt - 1)
            assert 0.5 * base <= a.backoff_s(s, attempt) <= 1.5 * base
    flat = EscalationPolicy(backoff_jitter=0.0, backoff_base_s=0.01)
    assert flat.backoff_s(3, 2) == pytest.approx(0.02)
    for bad in (dict(max_rungs=0), dict(backoff_jitter=1.0),
                dict(backoff_factor=0.5)):
        with pytest.raises(ValueError):
            EscalationPolicy(**bad)
    with pytest.raises(ValueError):
        a.backoff_s(0, 0)


def test_retry_predicate_and_status_retryable():
    pol = EscalationPolicy()
    assert pol.should_retry(int(SolveStatus.STALLED))
    assert pol.should_retry(int(SolveStatus.FATAL_NONFINITE))
    assert not pol.should_retry(int(SolveStatus.CONVERGED), 1.0)
    assert not pol.should_retry(int(SolveStatus.RECOVERED), 1.0)
    assert pol.should_retry(int(SolveStatus.MAX_ITER), float("nan"))
    assert pol.should_retry(99)
    assert status_retryable(int(SolveStatus.CONVERGED), float("inf"))
    assert not status_retryable(int(SolveStatus.CONVERGED), 1.0)


def test_breaker_state_machine():
    events = []
    cb = CircuitBreaker(BreakerPolicy(trip_after=2, cooldown_s=1.0),
                        on_event=lambda e, b, r: events.append((e, b)))
    assert cb.state("b") is BreakerState.CLOSED
    cb.record_failure("b", "boom", now=0.0)
    assert cb.state("b") is BreakerState.CLOSED
    cb.check_submit("b", now=0.1)
    cb.record_failure("b", "boom2", now=0.2)
    assert cb.state("b") is BreakerState.OPEN
    with pytest.raises(BucketTripped, match="boom2"):
        cb.check_submit("b", now=0.5)
    assert not cb.admit("b", now=0.5)
    assert cb.reopen_at("b") == pytest.approx(1.2)
    cb.check_submit("b", now=1.5)
    assert cb.admit("b", now=1.5)
    assert cb.state("b") is BreakerState.HALF_OPEN
    assert not cb.admit("b", now=1.6)
    cb.record_failure("b", "probe died", now=1.7)
    assert cb.state("b") is BreakerState.OPEN
    assert cb.admit("b", now=3.0)
    cb.record_success("b")
    assert cb.state("b") is BreakerState.CLOSED
    assert cb.reopen_at("b") is None
    cb.record_failure("b", "x", now=3.1)
    assert cb.state("b") is BreakerState.CLOSED
    assert cb.state("other") is BreakerState.CLOSED
    assert [e for e, _ in events] == [
        "trip", "fast_fail", "probe", "trip", "probe", "recover"]
    with pytest.raises(ValueError):
        BreakerPolicy(trip_after=0)


# ---------------------------------------------------------------------------
# Fault plans, chaos, stats
# ---------------------------------------------------------------------------


def test_fault_plan_lowering_and_stacking():
    plan = make_nan_burst(6, [1, 4], start=2, stop=5, n_points=3,
                          dtype=np.float64)
    perm = np.asarray([5, 4, 3, 2, 1, 0])
    low = lower_fault_plan(plan, n_edges=8, n_points=4, dtype=np.float64,
                           perm=perm)
    e = low.edge_nan.numpy()
    assert e.shape == (8,)
    assert np.isnan(e[perm.argsort()[1]]) and np.isnan(e[perm.argsort()[4]])
    assert np.count_nonzero(np.isnan(e)) == 2 and not np.isnan(e[6:]).any()
    assert tuple(low.point_crush.shape) == (4,) and low.point_crush[3] == 0
    assert tuple(low.window) == (2, 5)
    edge_only = make_nan_burst(6, [0], start=0, stop=1, dtype=np.float64)
    assert tuple(lower_fault_plan(edge_only, n_edges=8, n_points=4,
                                  dtype=np.float64).point_crush.shape) == (4,)
    with pytest.raises(ValueError, match="point_crush"):
        lower_fault_plan(plan, n_edges=8, n_points=2, dtype=np.float64)
    with pytest.raises(ValueError, match="edge_nan"):
        lower_fault_plan(plan, n_edges=4, n_points=4, dtype=np.float64)
    inert = inert_fault_plan(8, 4, np.float64)
    assert tuple(inert.window) == (0, 0)
    closed = close_fault_window(low)
    assert tuple(closed.window) == (0, 0) and torch.isnan(
        closed.edge_nan).any()
    stack = stack_fault_plans([low, inert, closed])
    assert isinstance(stack, FaultPlan)
    assert tuple(stack.edge_nan.shape) == (3, 8)
    assert stack.window.shape == (3, 2) and stack.offset.shape == (3,)
    assert stack.window.tolist() == [[2, 5], [0, 0], [0, 0]]
    with pytest.raises(ValueError):
        stack_fault_plans([])


def test_dispatch_chaos_seeded_determinism_as_jax():
    from megba_tpu.robustness.faults import (
        DispatchChaos as JChaos,
        InjectedDispatchError as JInjected,
    )

    def pattern(chaos, err, bucket, n=32):
        out = []
        for _ in range(n):
            try:
                chaos.before_dispatch(bucket)
                out.append(False)
            except err:
                out.append(True)
        return out

    pa = pattern(DispatchChaos(fail_rate=0.5, seed=3), InjectedDispatchError,
                 "bucket_x")
    assert pa == pattern(JChaos(fail_rate=0.5, seed=3), JInjected,
                         "bucket_x")
    assert any(pa) and not all(pa)
    assert pattern(DispatchChaos(fail_rate=0.5, seed=4),
                   InjectedDispatchError, "bucket_x") != pa
    d = DispatchChaos(fail_first=99, buckets=frozenset({"only_this"}))
    d.before_dispatch("something_else")
    with pytest.raises(InjectedDispatchError):
        d.before_dispatch("only_this")
    assert d.dispatches("only_this") == 1
    with pytest.raises(ValueError):
        DispatchChaos(fail_rate=1.5)


def test_fleet_stats_counters_as_jax():
    a, b = FleetStats(), js.FleetStats()
    for s in (a, b):
        s.record_batch("b1", lanes=4, n_real=3, edges_real=300,
                       edge_bucket=2048, wall_s=0.5)
        s.record_batch("b2", lanes=1, n_real=1, edges_real=2048,
                       edge_bucket=2048, wall_s=0.5)
        s.record_pool(True)
        s.record_pool(False)
        s.record_shed(2)
        s.record_deadline_miss()
        for rung in (1, 1, 2):
            s.record_retry(rung)
        s.record_reject()
        for ev in ("trip", "probe", "recover", "fast_fail"):
            s.record_breaker(ev)
        s.record_depth(5)
        s.record_depth(3)
        s.record_triage("repaired", {"points_fixed": 2, "edges_masked": 1})
    assert a.as_dict() == b.as_dict()
    assert a.report() == b.report()
    d = a.as_dict()
    assert d["problems_per_sec"] == pytest.approx(4.0)
    assert d["retries_by_rung"] == {"1": 2, "2": 1}
    with pytest.raises(ValueError):
        a.record_breaker("nope")


# ---------------------------------------------------------------------------
# The queue (real CPU solves)
# ---------------------------------------------------------------------------


def test_queue_validation():
    with pytest.raises(ValueError):
        FleetQueue(OPT64, max_batch=0)
    with pytest.raises(ValueError):
        FleetQueue(OPT64, max_wait_s=-1.0)
    with pytest.raises(ValueError):
        FleetQueue(OPT64, max_pending=0)
    with pytest.raises(ValueError) as t:
        FleetQueue(dataclasses.replace(OPT64, world_size=2))
    with pytest.raises(ValueError) as j:
        js.FleetQueue(JProblemOption(world_size=2))
    assert str(t.value) == str(j.value)


def test_deadline_shed_before_dispatch():
    stats = FleetStats()
    with FleetQueue(OPT64, max_batch=64, max_wait_s=30.0,
                    stats=stats) as q:
        fut = q.submit(_mk(0), deadline_s=0.0)
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded, match="shed before dispatch"):
            fut.result(timeout=10)
        assert time.monotonic() - t0 < 5.0
        with pytest.raises(ValueError):
            q.submit(_mk(0), deadline_s=-1.0)
    assert stats.sheds == 1 and stats.problems == 0


def test_admission_control_reject_raise_and_block():
    stats = FleetStats()
    with FleetQueue(OPT64, max_batch=64, max_wait_s=30.0, stats=stats,
                    max_pending=2) as q:
        f1 = q.submit(_mk(1), deadline_s=0.2)
        f2 = q.submit(_mk(2), deadline_s=0.2)
        with pytest.raises(QueueRejected, match="max_pending=2"):
            q.submit(_mk(3), deadline_s=0.2)
        for f in (f1, f2):
            with pytest.raises(DeadlineExceeded):
                f.result(timeout=10)
    assert stats.rejected == 1 and stats.queue_depth_peak == 2
    stats = FleetStats()
    with FleetQueue(OPT64, max_batch=64, max_wait_s=30.0, stats=stats,
                    max_pending=1, reject_policy=RejectPolicy.BLOCK,
                    block_timeout_s=0.15) as q:
        f1 = q.submit(_mk(1), deadline_s=30.0)
        t0 = time.monotonic()
        with pytest.raises(QueueRejected, match="for 0.15s"):
            q.submit(_mk(2))
        assert time.monotonic() - t0 >= 0.15
        assert f1.cancel()  # a cancel before dispatch frees the slot
        with pytest.raises(DeadlineExceeded):
            q.submit(_mk(3), deadline_s=0.0).result(timeout=10)
    assert stats.rejected == 1 and stats.problems == 0


def test_breaker_trips_fails_fast_and_half_open_probe_recovers():
    stats = FleetStats()
    chaos = DispatchChaos(fail_first=2)
    with FleetQueue(OPT64, max_batch=1, max_wait_s=0.0, stats=stats,
                    chaos=chaos,
                    breaker=BreakerPolicy(trip_after=2,
                                          cooldown_s=0.3)) as q:
        bucket = str(q._key_for(_mk(3, 32), 0)[0])
        for seed in (1, 2):
            with pytest.raises(InjectedDispatchError):
                q.submit(_mk(seed, 32)).result(timeout=10)
        assert q.breaker.state(bucket) is BreakerState.OPEN
        t0 = time.monotonic()
        with pytest.raises(BucketTripped, match="InjectedDispatchError"):
            q.submit(_mk(5, 32))
        assert time.monotonic() - t0 < 1.0
        time.sleep(0.35)
        r = q.submit(_mk(3, 32)).result(timeout=120)  # the probe
        assert np.isfinite(float(r.cost))
        assert q.breaker.state(bucket) is BreakerState.CLOSED
    assert (stats.breaker_trips, stats.breaker_probes,
            stats.breaker_recoveries, stats.breaker_fast_fails) == (1, 1, 1, 1)
    assert chaos.dispatches(bucket) == 3


def test_flush_close_drain_and_failed_batch_keeps_serving():
    chaos = DispatchChaos(fail_first=1)
    q = FleetQueue(OPT64, max_batch=64, max_wait_s=600.0, chaos=chaos)
    try:
        f0 = q.submit(_mk(1))
        q.flush()  # ignores the 10-minute batch wait
        with pytest.raises(InjectedDispatchError):
            f0.result(timeout=10)
        assert not q._force and q._pending == {}
        f1 = q.submit(_mk(3, 32))
        q.flush()
        assert f1.result(timeout=120).status in TERMINAL
        f2 = q.submit(_mk(7, 29))
    finally:
        q.close()  # drains f2
    assert f2.result(timeout=120).status in TERMINAL
    assert q._thread.is_alive() is False
    q.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        q.submit(_mk(5))


def test_deadline_missed_result_is_flagged_and_miss_on_failure():
    stats = FleetStats()
    with FleetQueue(OPT64, max_batch=1, max_wait_s=0.0, stats=stats,
                    chaos=DispatchChaos(delay_s=0.4)) as q:
        r = q.submit(_mk(3, 32), deadline_s=0.2).result(timeout=120)
    assert r.deadline_missed and r.latency_s >= 0.2
    assert np.isfinite(float(r.cost))
    assert stats.deadline_misses == 1 and stats.sheds == 0
    stats = FleetStats()
    with FleetQueue(OPT64, max_batch=1, max_wait_s=0.0, stats=stats,
                    chaos=DispatchChaos(fail_first=9, delay_s=0.3)) as q:
        with pytest.raises(InjectedDispatchError):
            q.submit(_mk(1), deadline_s=0.1).result(timeout=10)
    assert stats.deadline_misses == 1 and stats.sheds == 0


def test_queue_escalation_heals_poisoned_problem_bitwise_mates():
    """Rung 0 (guards off) leaves the poisoned problem STALLED with a NaN
    cost; it is requeued at rung 1 (guards, inflated damping) and ends
    RECOVERED with attempts == 2.  Its clean batch-mates are bitwise the
    closed-window `solve_many` control's, and a dispatch error rides the
    same ladder."""
    clean0, clean1 = _mk(3, 32), _mk(7, 29)
    poisoned = _poison(_mk(11, 31))
    stats = FleetStats()
    with FleetQueue(OPT64, max_batch=8, max_wait_s=30.0, stats=stats,
                    escalation=EscalationPolicy(backoff_base_s=0.01,
                                                seed=0)) as q:
        futs = [q.submit(p) for p in (clean0, poisoned, clean1)]
        q.flush()
        got = [f.result(timeout=120) for f in futs]
    control = solve_many(
        [clean0, dataclasses.replace(
            poisoned, fault_plan=close_fault_window(poisoned.fault_plan)),
         clean1], OPT64)
    for g, c in ((got[0], control[0]), (got[2], control[2])):
        assert g.attempts == 1 and g.rung == 0 and g.history == []
        assert _bits(g) == _bits(c)
    healed = got[1]
    assert healed.status == int(SolveStatus.RECOVERED)
    assert healed.attempts == 2 and healed.rung == 1
    assert healed.history[0]["rung"] == 0
    assert healed.history[0]["status"] == int(SolveStatus.STALLED)
    assert healed.history[0]["error"] is None
    assert np.isfinite(float(healed.cost))
    assert stats.retries == 1 and stats.retries_by_rung == {1: 1}

    stats = FleetStats()
    with FleetQueue(OPT64, max_batch=1, max_wait_s=0.0, stats=stats,
                    chaos=DispatchChaos(fail_first=1),
                    escalation=EscalationPolicy(backoff_base_s=0.01)) as q:
        r = q.submit(_mk(3, 32)).result(timeout=120)
    assert r.attempts == 2 and r.rung == 1
    assert "InjectedDispatchError" in r.history[0]["error"]
    assert np.isfinite(float(r.cost)) and stats.retries == 1


def test_queue_batches_match_solve_many_bitwise_from_many_threads():
    """Twelve same-bucket problems from twelve submitter threads (more
    than this machine's cores, with a short switch interval) through a
    max_batch=4 queue: every future resolves, the counts add up, the
    dispatcher survives, and each result is bitwise what `solve_many`
    gives the problem (lane independence: the batch-mates do not
    matter)."""
    probs = [_mk(100 + i, 29 + (i % 4)) for i in range(12)]
    ref = solve_many(probs, OPT64)
    stats = FleetStats()
    results = [None] * len(probs)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with FleetQueue(OPT64, max_batch=4, max_wait_s=0.05,
                        stats=stats) as q:
            def submit(i):
                results[i] = q.submit(probs[i]).result(timeout=300)

            threads = [threading.Thread(target=submit, args=(i,))
                       for i in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
            assert q._thread.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert all(r is not None for r in results)
    assert stats.problems == 12
    assert sum(b["problems"] for b in stats.per_bucket.values()) == 12
    for r, c in zip(results, ref):
        assert r.lanes <= 4 and r.latency_s > 0.0
        assert _bits(r) == _bits(c)


def test_submit_triage_reject_resolves_with_no_dispatch():
    bad_scene = make_synthetic_bal(num_cameras=4, num_points=30, seed=2,
                                   n_orphan_points=3)
    bad = FleetProblem.from_synthetic(bad_scene, name="orphans")
    stats = FleetStats()
    with FleetQueue(OPT64, max_batch=4, max_wait_s=30.0, stats=stats) as q:
        f = q.submit(bad, triage=TriagePolicy())
        assert f.done()
        with pytest.raises(ProblemRejected):
            f.result(timeout=1)
        assert q._pending == {}
        warn = q.submit(bad, triage=TriagePolicy(
            on_degenerate=TriageAction.WARN))
        q.flush()
        r = warn.result(timeout=120)
    assert stats.triage_rejected == 1 and stats.triage_warned == 1
    assert stats.batches == 1 and stats.problems == 1
    assert r.health is not None and r.health["degenerate"]

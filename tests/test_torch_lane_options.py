"""The lane-batched fleet's EXPLICIT and fused-kernel paths and the
metrics plane on the solve entry points, against the JAX package.

- `solve_many` with EXPLICIT, fused IMPLICIT and fused EXPLICIT at
  float64 against the JAX package's `solve_many` with the same option on
  the same `make_fleet` problems, LM-capped before the cost floor: trial
  costs at rtol 1e-9 with equal counts, accepts and status.  JAX's bucket
  program runs `fused_kernels` on its unfused XLA path (plans=None), so
  the port's fused kernels are held to JAX's unfused solve;
- each path's lanes bitwise alone and batched, at another lane count;
- the compile pool gives each path a program of its own;
- the options the batch once refused: each is accepted now, and
  TWO_LEVEL / MULTILEVEL raise the JAX package's ValueError;
- `solve_many` and `flat_solve` with `metrics=True` feed the same
  `megba_solve_*` / `megba_fleet_*` series values as JAX's, and give
  results bitwise equal to the unarmed run (the whole plane armed too).

The JAX references compile one vmapped program per option (12-16 s
each), computed once per module (`lru_cache`); the metrics references
ride the same solves.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import megba_tpu.serving as js
from megba_tpu.common import (
    AlgoOption as JAlgoOption,
    ComputeKind as JComputeKind,
    JacobianMode as JJacobianMode,
    ProblemOption as JProblemOption,
    SolverOption as JSolverOption,
)
from megba_tpu.observability import metrics as j_metrics
from megba_tpu.ops.residuals import make_residual_jacobian_fn
from megba_tpu.solve import flat_solve as j_flat_solve

import megba_tpu_torch as mt
import megba_tpu_torch.serving as ts
from megba_tpu_torch.algo.lanes import check_lane_option
from megba_tpu_torch.common import (
    AlgoOption,
    ComputeKind,
    Device,
    JacobianMode,
    PrecondKind,
    PreconditionerKind,
    ProblemOption,
    SolverOption,
)
from megba_tpu_torch.observability import flight, metrics, spans
from megba_tpu_torch.observability.trace import TRACE_FIELDS

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

LM_CAP = 4
PATHS = {
    "explicit": (ComputeKind.EXPLICIT, False),
    "fused_implicit": (ComputeKind.IMPLICIT, True),
    "fused_explicit": (ComputeKind.EXPLICIT, True),
}
SERIES = ("megba_solve_lm_iterations", "megba_solve_pcg_iterations",
          "megba_solve_status_total", "megba_fleet_batches_total",
          "megba_fleet_problems_total", "megba_fleet_lane_fill_ratio",
          "megba_fleet_edge_fill_ratio")


def _opt(path, **kw):
    kind, fk = (ComputeKind.IMPLICIT, False) if path == "implicit" else (
        PATHS[path])
    return ProblemOption(dtype=np.float64, device=Device.CPU,
                         compute_kind=kind,
                         algo_option=AlgoOption(max_iter=LM_CAP),
                         solver_option=SolverOption(fused_kernels=fk), **kw)


def _jopt(path, **kw):
    kind, fk = PATHS[path]
    return JProblemOption(dtype=np.float64,
                          compute_kind=JComputeKind[kind.name],
                          algo_option=JAlgoOption(max_iter=LM_CAP),
                          solver_option=JSolverOption(fused_kernels=fk),
                          **kw)


def _fleet():
    """Six BAL problems of one bucket (6 lanes padded to 8)."""
    fl = mt.io.synthetic.make_fleet(6, size_range=(17, 30), seed=0)
    return [ts.FleetProblem.from_synthetic(s, name=f"bal{i}")
            for i, s in enumerate(fl)]


def _to_jax(p):
    return js.FleetProblem(cameras=p.cameras, points=p.points, obs=p.obs,
                           cam_idx=p.cam_idx, pt_idx=p.pt_idx, name=p.name,
                           factor=p.factor)


def _series(snapshot):
    """The compared series of a snapshot: everything but the wall-clock
    latency histogram."""
    m = snapshot["metrics"]
    return {k: m[k] for k in SERIES if k in m}


@functools.lru_cache(maxsize=None)
def _jax_run(path):
    """JAX's `solve_many` of the fleet under `path` with `metrics=True`:
    its results and the registry's series."""
    j_metrics.reset_default_registry()
    res = js.solve_many([_to_jax(p) for p in _fleet()],
                        _jopt(path, metrics=True))
    jax.block_until_ready([r.cost for r in res])
    snap = j_metrics.default_registry().snapshot()
    j_metrics.reset_default_registry()
    return res, _series(snap)


@functools.lru_cache(maxsize=None)
def _port_run(path):
    return ts.solve_many(_fleet(), _opt(path))


def _bits(r):
    return ([r.cameras.tobytes(), r.points.tobytes(), r.cost.tobytes(),
             r.initial_cost.tobytes(), r.iterations, r.accepted,
             r.pcg_iterations, r.status, r.recoveries]
            + [getattr(r.trace, f).numpy().tobytes() for f in TRACE_FIELDS])


@pytest.mark.parametrize("path", list(PATHS))
def test_solve_many_matches_jax(path):
    want, _ = _jax_run(path)
    got = _port_run(path)
    assert len(got) == len(want) == 6
    for t, j in zip(got, want):
        k = t.iterations
        assert k == int(j.iterations) == LM_CAP
        assert (t.accepted, t.pcg_iterations, t.status, t.recoveries) == (
            int(j.accepted), int(j.pcg_iterations), int(j.status),
            int(j.recoveries))
        assert (t.lane, t.lanes, str(t.shape)) == (j.lane, j.lanes,
                                                   str(j.shape))
        np.testing.assert_array_equal(t.trace.accept[:k].numpy(),
                                      np.asarray(j.trace.accept)[:k])
        np.testing.assert_array_equal(t.trace.pcg_iters[:k].numpy(),
                                      np.asarray(j.trace.pcg_iters)[:k])
        np.testing.assert_allclose(t.trace.cost[:k].numpy(),
                                   np.asarray(j.trace.cost)[:k], rtol=1e-9)
        np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=1e-9)
        np.testing.assert_allclose(t.cameras, np.asarray(j.cameras),
                                   rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("path", list(PATHS))
def test_lanes_bitwise_alone_and_batched(path):
    """A lane's bits do not depend on its batch-mates or on the lane
    count: each problem alone (1 lane), the fleet (8 lanes) and the
    fleet's first three (4 lanes)."""
    probs = _fleet()
    batched = _port_run(path)
    three = ts.solve_many(probs[:3], _opt(path))
    assert {r.lanes for r in batched} == {8}
    assert {r.lanes for r in three} == {4}
    for i in (0, 2, 5):
        alone = ts.solve_many([probs[i]], _opt(path))[0]
        assert alone.lanes == 1
        assert _bits(alone) == _bits(batched[i])
    for a, b in zip(three, batched):
        assert _bits(a) == _bits(b)


def test_paths_share_the_implicit_answer():
    """On the CPU the kernels' plain versions are the same arithmetic:
    the fused paths are bitwise their unfused ones, and EXPLICIT agrees
    with IMPLICIT to rounding."""
    implicit = ts.solve_many(_fleet(), _opt("implicit"))
    for fused, unfused in (("fused_implicit", None),
                           ("fused_explicit", "explicit")):
        ref = implicit if unfused is None else _port_run(unfused)
        for a, b in zip(_port_run(fused), ref):
            assert _bits(a) == _bits(b)
    for a, b in zip(_port_run("explicit"), implicit):
        np.testing.assert_allclose(a.trace.cost[:LM_CAP].numpy(),
                                   b.trace.cost[:LM_CAP].numpy(), rtol=1e-12)


def test_each_path_gets_its_own_program():
    """The compile pool keys every non-observability option field: the
    three paths and IMPLICIT each build a bucket program of their own."""
    from megba_tpu_torch.factors import engine_for
    from megba_tpu_torch.serving import BucketLadder, FleetStats, classify
    from megba_tpu_torch.serving.compile_pool import (
        CompilePool,
        batched_solve_program,
        reset_process_cache,
    )

    engine = engine_for("bal", JacobianMode.AUTODIFF)
    p = _fleet()[0]
    shape = classify(*p.dims(), np.float64, BucketLadder())
    opts = [_opt(path) for path in ["implicit", *PATHS]]
    programs = [batched_solve_program(engine, o) for o in opts]
    assert len({id(x) for x in programs}) == 4
    assert [(x.option.compute_kind, x.option.solver_option.fused_kernels)
            for x in programs[1:]] == list(PATHS.values())
    assert batched_solve_program(
        engine, dataclasses.replace(opts[1], metrics=True)) is programs[1]
    reset_process_cache()
    stats = FleetStats()
    pool = CompilePool(stats=stats)
    for o in opts:
        pool.program(engine, o, shape, 8, 9, 3, 2, device="cpu")
    assert stats.pool_misses == 4 and stats.pool_hits == 0
    assert len(pool.entries()) == 4


@pytest.mark.parametrize("case,kw", [
    ("use_schur", dict(use_schur=False)),
    ("mixed_precision_pcg", dict(mixed_precision_pcg=True)),
    ("solver_option.bf16", dict(dtype=np.float32,
                                solver_option=SolverOption(bf16=True))),
    ("solver_option.preconditioner", dict(solver_option=SolverOption(
        preconditioner=PreconditionerKind.SCHUR_DIAG))),
    ("solver_option.precond", dict(solver_option=SolverOption(
        precond=PrecondKind.NEUMANN))),
    ("solver_option.precond", dict(solver_option=SolverOption(
        fused_kernels=True, precond=PrecondKind.TWO_LEVEL))),
    ("solver_option.precond", dict(
        compute_kind=ComputeKind.EXPLICIT,
        solver_option=SolverOption(precond=PrecondKind.MULTILEVEL))),
])
def test_still_refused_options_name_themselves(case, kw):
    """The options the batch refused before it ran them: each batched one
    passes the gate, solves and queues; TWO_LEVEL / MULTILEVEL raise the
    JAX package's ValueError word for word (its `lm_solve`'s, which its
    vmapped bucket program reaches without a cluster plan) from the gate
    and `solve_many`, and from a future of a queue that constructs."""
    opt = dataclasses.replace(_opt("explicit"), **kw)
    precond = opt.solver_option.precond
    if precond not in (PrecondKind.TWO_LEVEL, PrecondKind.MULTILEVEL):
        check_lane_option(opt)
        res = ts.solve_many(_fleet()[:1], opt)[0]
        assert np.isfinite(float(res.cost)) and res.cost <= res.initial_cost
        ts.FleetQueue(opt).close()
        return
    want = (f"SolverOption.precond={precond.name} needs a camera-cluster "
            "plan operand: solve through flat_solve (which plans + caches "
            "it) or pass cluster_plan=ops.segtiles.device_cluster_plan(...) "
            "/ device_multilevel_plan(...)")
    for call in (lambda: check_lane_option(opt),
                 lambda: ts.solve_many(_fleet()[:1], opt)):
        with pytest.raises(ValueError) as got:
            call()
        assert str(got.value) == want
    with ts.FleetQueue(opt) as q:
        fut = q.submit(_fleet()[0])
        q.flush()
        with pytest.raises(ValueError) as got:
            fut.result(timeout=60)
    assert str(got.value) == want


@pytest.mark.parametrize("path", list(PATHS))
def test_solve_many_metrics_match_jax(path):
    """`metrics=True` feeds the JAX package's series with its values."""
    _, want = _jax_run(path)
    metrics.reset_default_registry()
    try:
        res = ts.solve_many(_fleet(), _opt(path, metrics=True))
        got = _series(metrics.default_registry().snapshot())
    finally:
        metrics.reset_default_registry()
    assert set(got) == set(SERIES)
    assert got == want
    for a, b in zip(res, _port_run(path)):
        assert _bits(a) == _bits(b)


def test_flat_solve_metrics_match_jax():
    s = mt.make_synthetic_bal(num_cameras=4, num_points=30,
                              obs_per_point=3, seed=5, param_noise=1e-2)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    algo = dict(max_iter=LM_CAP)
    j_metrics.reset_default_registry()
    j_flat_solve(make_residual_jacobian_fn(mode=JJacobianMode.ANALYTICAL),
                 *args, JProblemOption(
                     jacobian_mode=JJacobianMode.ANALYTICAL, metrics=True,
                     algo_option=JAlgoOption(**algo)))
    want = j_metrics.default_registry().snapshot()["metrics"]
    j_metrics.reset_default_registry()
    opt = ProblemOption(jacobian_mode=JacobianMode.ANALYTICAL,
                        device=Device.CPU, algo_option=AlgoOption(**algo))
    plain = mt.flat_solve(None, *args, opt)
    metrics.reset_default_registry()
    try:
        armed = mt.flat_solve(None,
                              *args, dataclasses.replace(opt, metrics=True))
        got = metrics.default_registry().snapshot()["metrics"]
    finally:
        metrics.reset_default_registry()
    assert got == want
    assert set(got) == {"megba_solve_lm_iterations",
                        "megba_solve_pcg_iterations",
                        "megba_solve_status_total"}
    for f in ("cameras", "points", "cost"):
        assert getattr(armed, f).numpy().tobytes() == (
            getattr(plain, f).numpy().tobytes())


@pytest.mark.parametrize("path", ["implicit", "fused_explicit"])
def test_armed_plane_is_bitwise_the_unarmed_run(path, monkeypatch,
                                                tmp_path):
    """MEGBA_METRICS, MEGBA_TRACE and MEGBA_FLIGHT armed together change
    no bit of a fleet's results; the plane sees every problem and bucket."""
    opt = _opt(path)
    plain = ts.solve_many(_fleet(), opt)
    monkeypatch.setenv("MEGBA_METRICS", "1")
    monkeypatch.setenv("MEGBA_TRACE", "1")
    monkeypatch.setenv("MEGBA_FLIGHT", str(tmp_path / "flight.jsonl"))
    metrics.reset_default_registry()
    spans.reset_default_recorder()
    flight.reset_default_recorder()
    try:
        armed = ts.solve_many(_fleet(), opt)
        snap = metrics.default_registry().snapshot()["metrics"]
        buckets = [s for s in mt.observability.span_recorder().spans()
                   if s["name"] == "solve_bucket"]
    finally:
        metrics.reset_default_registry()
        spans.reset_default_recorder()
        flight.reset_default_recorder()
    for a, b in zip(armed, plain):
        assert _bits(a) == _bits(b)
    assert sum(snap["megba_fleet_problems_total"]["series"].values()) == 6
    assert sum(snap["megba_fleet_batches_total"]["series"].values()) == 1
    assert len(buckets) == 1
    hist = snap["megba_solve_lm_iterations"]["series"]
    assert sum(h["count"] for h in hist.values()) == 6

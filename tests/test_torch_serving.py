"""The port's serving layer (megba_tpu_torch/serving/, algo/lanes.py)
against the JAX package's.

- `make_fleet`, `classify` and `pad_to_class` array-equal to JAX's;
- `solve_many` at float64 against JAX's `solve_many` problem by problem
  on a mixed fleet (a BAL bucket and a rig bucket, both with lane
  padding), LM-capped before the cost floor: trial costs at rtol 1e-9,
  equal LM / PCG / accept counts, status and lane placement;
- bitwise lane independence (alone, in a batch, at another lane count)
  at float32 and float64, also under guards, Huber, forcing and warm
  starts;
- faulted batches: the poisoned lane RECOVERED under guards as in JAX,
  its batch-mates bitwise equal to the closed-window control;
- every option the JAX package's fleet runs is accepted, TWO_LEVEL /
  MULTILEVEL raise JAX's ValueError from `solve_many` and from a queue
  future, `world_size=2` JAX's ValueError; the compile pool's manifests
  round-trip and name the fields that drift;
- no module of the serving slice imports jax.

The JAX references compile one vmapped program per bucket (several
seconds each), so they are computed once per module (`lru_cache`).
"""

import dataclasses
import functools
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import megba_tpu.serving as js
from megba_tpu.common import (
    AlgoOption as JAlgoOption,
    ProblemOption as JProblemOption,
    RobustOption as JRobustOption,
)
from megba_tpu.io.synthetic import make_fleet as j_make_fleet
from megba_tpu.robustness.faults import make_nan_burst as j_make_nan_burst

import megba_tpu_torch.serving as ts
from megba_tpu_torch.common import (
    AlgoOption,
    ComputeKind,
    Device,
    PrecondKind,
    PreconditionerKind,
    ProblemOption,
    RobustKind,
    RobustOption,
    SolverOption,
    SolveStatus,
)
from megba_tpu_torch.convert import fleet_problem_to_torch
from megba_tpu_torch.factors.rig import make_synthetic_rig
from megba_tpu_torch.io.synthetic import make_fleet
from megba_tpu_torch.observability.trace import TRACE_FIELDS
from megba_tpu_torch.robustness.faults import (
    close_fault_window,
    make_nan_burst,
)
from megba_tpu_torch.serving.compile_pool import (
    CompilePool,
    ManifestMismatch,
    batched_solve_program,
    reset_process_cache,
)

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

LM_CAP = 4  # the small scenes reach their cost floor later
OPT64 = ProblemOption(dtype=np.float64, device=Device.CPU,
                      algo_option=AlgoOption(max_iter=LM_CAP))
JOPT64 = JProblemOption(dtype=np.float64,
                        algo_option=JAlgoOption(max_iter=LM_CAP))
GUARDED = dict(robust_option=RobustOption(guards=True))
J_GUARDED = dict(robust_option=JRobustOption(guards=True))


def _bal_fleet():
    """Five BAL problems in one bucket (5 lanes padded to 8) and three rig
    problems in another (padded to 4 lanes)."""
    fl = make_fleet(5, size_range=(17, 30), seed=0)
    probs = [ts.FleetProblem.from_synthetic(s, name=f"bal{i}")
             for i, s in enumerate(fl)]
    for i in range(3):
        s = make_synthetic_rig(num_bodies=4, num_points=20 + 4 * i,
                               seed=10 + i)
        probs.append(ts.FleetProblem.from_synthetic(s, name=f"rig{i}",
                                                    factor="rig"))
    return probs


def _to_jax(p: ts.FleetProblem, fault_plan=None) -> js.FleetProblem:
    return js.FleetProblem(
        cameras=p.cameras, points=p.points, obs=p.obs, cam_idx=p.cam_idx,
        pt_idx=p.pt_idx, name=p.name, factor=p.factor,
        fault_plan=fault_plan)


@functools.lru_cache(maxsize=None)
def _jax_mixed():
    return js.solve_many([_to_jax(p) for p in _bal_fleet()], JOPT64)


@functools.lru_cache(maxsize=None)
def _port_mixed():
    return ts.solve_many(_bal_fleet(), OPT64)


def _compare(t, j, rtol=1e-9):
    k = t.iterations
    assert k == int(j.iterations)
    assert t.accepted == int(j.accepted)
    assert t.pcg_iterations == int(j.pcg_iterations)
    assert t.status == int(j.status)
    assert t.recoveries == int(j.recoveries)
    assert (t.lane, t.lanes) == (j.lane, j.lanes)
    assert str(t.shape) == str(j.shape)
    np.testing.assert_array_equal(t.trace.accept[:k].numpy(),
                                  np.asarray(j.trace.accept)[:k])
    np.testing.assert_array_equal(t.trace.pcg_iters[:k].numpy(),
                                  np.asarray(j.trace.pcg_iters)[:k])
    np.testing.assert_array_equal(t.trace.recovery[:k].numpy(),
                                  np.asarray(j.trace.recovery)[:k])
    np.testing.assert_allclose(t.trace.cost[:k].numpy(),
                               np.asarray(j.trace.cost)[:k], rtol=rtol)
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=rtol)
    np.testing.assert_allclose(float(t.initial_cost), float(j.initial_cost),
                               rtol=rtol)


def _bits(r):
    return ([r.cameras.tobytes(), r.points.tobytes(), r.cost.tobytes(),
             r.initial_cost.tobytes(), r.iterations, r.accepted,
             r.pcg_iterations, r.status, r.recoveries]
            + [getattr(r.trace, f).numpy().tobytes() for f in TRACE_FIELDS])


# ---------------------------------------------------------------------------
# Generators and bucketing
# ---------------------------------------------------------------------------


def test_make_fleet_array_equal_to_jax_and_prefix_stable():
    a = make_fleet(6, size_range=(12, 96), seed=3, dtype=np.float32)
    b = j_make_fleet(6, size_range=(12, 96), seed=3, dtype=np.float32)
    for x, y in zip(a, b):
        for f in ("cameras_gt", "points_gt", "cameras0", "points0", "obs",
                  "cam_idx", "pt_idx"):
            gx, gy = getattr(x, f), getattr(y, f)
            assert gx.dtype == gy.dtype and np.array_equal(gx, gy), f
    for x, y in zip(make_fleet(3, size_range=(12, 96), seed=3,
                               dtype=np.float32), a):
        assert np.array_equal(x.obs, y.obs)
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    sa = make_fleet(5, seed=1, rng=rng_a)
    sb = j_make_fleet(5, seed=1, rng=rng_b)
    assert all(np.array_equal(x.obs, y.obs) for x, y in zip(sa, sb))
    with pytest.raises(ValueError):
        make_fleet(0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_classify_and_pad_to_class_match_jax(dtype):
    ladder, jladder = ts.BucketLadder(), js.BucketLadder()
    rng = np.random.default_rng(0)
    for n in [(1, 1, 1), (5, 17, 2049), (130, 1000, 5000), (3, 40, 90)]:
        assert (ts.classify(*n, dtype, ladder).to_dict()
                == js.classify(*n, dtype, jladder).to_dict())
    for seed, s in enumerate(make_fleet(4, size_range=(12, 60), seed=2)):
        n_e = s.obs.shape[0]
        # A shuffle makes the camera sort (and its permutation) real.
        perm = rng.permutation(n_e) if seed % 2 else np.arange(n_e)
        args = (s.cameras0, s.points0, s.obs[perm], s.cam_idx[perm],
                s.pt_idx[perm])
        kw = dict(edge_mask=(rng.random(n_e) > 0.1).astype(float),
                  cam_fixed=rng.random(s.cameras0.shape[0]) > 0.7,
                  pt_fixed=rng.random(s.points0.shape[0]) > 0.9)
        shape = ts.classify(s.cameras0.shape[0], s.points0.shape[0], n_e,
                            dtype, ladder)
        jshape = js.ShapeClass.from_dict(shape.to_dict())
        a = ts.pad_to_class(*args, shape, **kw)
        b = js.pad_to_class(*args, jshape, **kw)
        for f in ("cameras", "points", "obs", "cam_idx", "pt_idx", "mask",
                  "cam_fixed", "pt_fixed", "perm"):
            x, y = getattr(a, f), getattr(b, f)
            if y is None:
                assert x is None
                continue
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert (a.n_cam, a.n_pt, a.n_edge) == (b.n_cam, b.n_pt, b.n_edge)


def test_bucket_ladder_validation_as_jax():
    for kw in (dict(cam_floor=0), dict(edge_floor=1000)):
        with pytest.raises(ValueError) as j:
            js.BucketLadder(**kw)
        with pytest.raises(ValueError) as t:
            ts.BucketLadder(**kw)
        assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="degenerate"):
        ts.classify(0, 10, 10, np.float64, ts.BucketLadder())


# ---------------------------------------------------------------------------
# solve_many against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(8))
def test_solve_many_matches_jax_f64(i):
    """Problem i of the mixed fleet (bal0-4 in a BAL bucket padded from
    5 lanes to 8; rig0-2 in a rig bucket padded to 4)."""
    t, j = _port_mixed()[i], _jax_mixed()[i]
    assert t.name == j.name
    _compare(t, j)
    np.testing.assert_allclose(t.cameras, np.asarray(j.cameras),
                               rtol=1e-7, atol=1e-9)


def test_mixed_fleet_buckets_and_padding():
    res = _port_mixed()
    groups = {}
    for r in res:
        groups.setdefault((str(r.shape), r.name[:3]), []).append(r)
    assert len(groups) == 2
    assert any(r.lanes > len(g) for g in groups.values() for r in g), \
        "no bucket padded its lanes"
    assert {r.name[:3] for r in res} == {"bal", "rig"}
    for r in res:
        assert r.status in (int(SolveStatus.MAX_ITER),
                            int(SolveStatus.CONVERGED))
        assert np.isfinite(float(r.cost)) and r.cost <= r.initial_cost


# ---------------------------------------------------------------------------
# Bitwise lane independence
# ---------------------------------------------------------------------------


LANE_OPTIONS = {
    "default": {},
    "guards_huber_forcing_warm": dict(
        robust_kind=RobustKind.HUBER, robust_delta=2.0, **GUARDED,
        solver_option=SolverOption(forcing=True, warm_start=True)),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", list(LANE_OPTIONS))
def test_lane_results_bitwise_independent(dtype, case):
    """A problem solved alone, in its batch, and at 16 lanes gives the
    same bits: cameras, points, costs, counts, status and every trace
    field."""
    opt = dataclasses.replace(OPT64, dtype=dtype,
                              algo_option=AlgoOption(max_iter=6),
                              **LANE_OPTIONS[case])
    fl = make_fleet(5, size_range=(17, 30), seed=1, dtype=dtype)
    probs = [ts.FleetProblem.from_synthetic(s, name=f"p{i}")
             for i, s in enumerate(fl)]
    batch = ts.solve_many(probs, opt)
    wide = ts.solve_many(probs, opt, ladder=ts.BucketLadder(lane_floor=16))
    assert max(r.lanes for r in batch) > 1
    assert all(r.lanes == 16 for r in wide)
    for i in (0, 4):
        alone = ts.solve_many([probs[i]], opt)[0]
        assert alone.lanes == 1
        assert _bits(alone) == _bits(batch[i]) == _bits(wide[i])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lane_sum_is_per_row(dtype):
    from megba_tpu_torch.algo.lanes import lane_sum

    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.standard_normal((5, 777)).astype(dtype))
    got = lane_sum(rows)
    assert got.dtype == rows.dtype
    for k in range(5):
        assert torch.equal(lane_sum(rows[k:k + 1])[0], got[k])
    np.testing.assert_allclose(got.numpy(),
                               rows.double().sum(1).numpy().astype(dtype),
                               rtol=1e-6 if dtype == np.float32 else 1e-13)


def test_block_inv_rows_matches_cholesky_inverse():
    from megba_tpu_torch.algo.lanes import block_inv_rows
    from megba_tpu_torch.ops.fused import block_diag_rows
    from megba_tpu_torch.solver.precond import block_inv

    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 9, 9))
    H = torch.from_numpy(a @ a.transpose(0, 2, 1) + 9 * np.eye(9))
    H[4, 2, 2] = -50.0  # not positive definite: all NaN, as block_inv
    got = block_inv_rows(block_diag_rows(H))
    want = block_diag_rows(block_inv(H))
    ok = [0, 1, 2, 3, 5]
    torch.testing.assert_close(got[:, ok], want[:, ok], rtol=1e-12,
                               atol=1e-14)
    assert torch.isnan(got[:, 4]).all() and torch.isnan(want[:, 4]).all()
    # Each block's bits depend on that block alone.
    assert torch.equal(block_inv_rows(block_diag_rows(H[1:3])), got[:, 1:3])


# ---------------------------------------------------------------------------
# Faulted batches
# ---------------------------------------------------------------------------


def _faulted_fleet():
    probs = _bal_fleet()[:5]
    big = [0, 1, 2, 3, 4]  # the BAL bucket of _bal_fleet
    plan = make_nan_burst(probs[big[0]].obs.shape[0], [1, 5], start=0,
                          stop=1, n_points=probs[big[0]].points.shape[0],
                          dtype=np.float64)
    probs[big[0]] = dataclasses.replace(probs[big[0]], fault_plan=plan)
    return probs, big


@functools.lru_cache(maxsize=None)
def _jax_faulted():
    probs, big = _faulted_fleet()
    j = []
    for p in probs:
        jp = None
        if p.fault_plan is not None:
            jp = j_make_nan_burst(p.obs.shape[0], [1, 5], start=0, stop=1,
                                  n_points=p.points.shape[0],
                                  dtype=np.float64)
        j.append(_to_jax(p, jp))
    # The faulted bucket alone: one faulted JAX program.
    jprobs = [j[i] for i in big]
    return js.solve_many(jprobs, dataclasses.replace(JOPT64, **J_GUARDED))


def test_faulted_batch_matches_jax_and_isolates_lanes():
    probs, big = _faulted_fleet()
    opt = dataclasses.replace(OPT64, **GUARDED)
    port = ts.solve_many([probs[i] for i in big], opt)
    jres = _jax_faulted()
    assert port[0].status == int(SolveStatus.RECOVERED) == int(jres[0].status)
    assert port[0].recoveries > 0
    for t, j in zip(port, jres):
        _compare(t, j)
    # Batch-mates bitwise equal to the closed-window control.
    control = [dataclasses.replace(
        probs[i], fault_plan=close_fault_window(probs[i].fault_plan))
        if probs[i].fault_plan is not None else probs[i] for i in big]
    ctrl = ts.solve_many(control, opt)
    for t, c in zip(port[1:], ctrl[1:]):
        assert _bits(t) == _bits(c)
    assert port[0].status != ctrl[0].status
    # Unguarded, the poisoned lane never accepts: STALLED, NaN cost.
    stalled = ts.solve_many([probs[i] for i in big], OPT64)[0]
    assert stalled.status == int(SolveStatus.STALLED)
    assert not np.isfinite(float(stalled.cost))


def test_fleet_problem_to_torch_carries_fault_plan():
    s = make_fleet(1, size_range=(12, 20), seed=4)[0]
    plan = j_make_nan_burst(s.obs.shape[0], [2], start=1, stop=3,
                            n_points=s.points0.shape[0], dtype=np.float64)
    jp = js.FleetProblem.from_synthetic(s, name="x")
    jp = dataclasses.replace(jp, fault_plan=plan,
                             edge_mask=np.ones(s.obs.shape[0]),
                             health={"structural": False})
    tp = fleet_problem_to_torch(jp)
    assert isinstance(tp, ts.FleetProblem) and tp.name == "x"
    assert np.array_equal(tp.obs, jp.obs) and tp.factor == "bal"
    assert tp.fault_plan.window == (1, 3) and tp.fault_plan.offset == 0
    assert torch.isnan(tp.fault_plan.edge_nan[2])
    assert tp.health == {"structural": False}


# ---------------------------------------------------------------------------
# Option surface
# ---------------------------------------------------------------------------


REFUSED = {
    "use_schur": dict(use_schur=False),
    "compute_kind": dict(compute_kind=ComputeKind.EXPLICIT),
    "fused_kernels": dict(solver_option=SolverOption(fused_kernels=True)),
    "mixed_precision_pcg": dict(mixed_precision_pcg=True),
    "bf16": dict(dtype=np.float32, solver_option=SolverOption(bf16=True)),
    "preconditioner": dict(solver_option=SolverOption(
        preconditioner=PreconditionerKind.SCHUR_DIAG)),
    "precond-NEUMANN": dict(solver_option=SolverOption(
        precond=PrecondKind.NEUMANN)),
    "precond-TWO_LEVEL": dict(solver_option=SolverOption(
        precond=PrecondKind.TWO_LEVEL)),
    "precond-MULTILEVEL": dict(solver_option=SolverOption(
        precond=PrecondKind.MULTILEVEL)),
}


# Every option the JAX package's fleet runs is batched
# (tests/test_torch_lane_options.py, test_torch_lane_rungs.py and
# test_torch_lane_precond.py hold them against JAX): their cases check
# the option is accepted.  TWO_LEVEL / MULTILEVEL raise what JAX's
# bucket program raises, a ValueError: from solve_many, and from the
# future of a queue that constructs.
BATCHED = set(REFUSED) - {"precond-TWO_LEVEL", "precond-MULTILEVEL"}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_options_raise_not_implemented(case):
    opt = dataclasses.replace(OPT64, **REFUSED[case])
    p = _bal_fleet()[0]
    if case in BATCHED:
        res = ts.solve_many([p], opt)[0]
        assert np.isfinite(float(res.cost))
        ts.FleetQueue(opt).close()
        return
    kind = case.split("-")[1]
    want = f"SolverOption.precond={kind} needs a camera-cluster plan operand"
    with pytest.raises(ValueError, match=want):
        ts.solve_many([p], opt)
    with ts.FleetQueue(opt) as q:
        fut = q.submit(p)
        q.flush()
        with pytest.raises(ValueError, match=want):
            fut.result(timeout=60)


def test_world_size_raises_jax_value_error():
    p = _bal_fleet()[0]
    with pytest.raises(ValueError) as j:
        js.solve_many([_to_jax(p)], dataclasses.replace(JOPT64,
                                                        world_size=2))
    with pytest.raises(ValueError) as t:
        ts.solve_many([p], dataclasses.replace(OPT64, world_size=2))
    assert str(t.value) == str(j.value)


def test_entry_points_default_to_cuda():
    p = _bal_fleet()[0]
    opt = dataclasses.replace(OPT64, device=Device.CUDA)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.solve_many([p], opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.FleetQueue(opt)
    # device="cpu" wins over the option.
    assert ts.solve_many([p], opt, device="cpu")[0].iterations == LM_CAP


# ---------------------------------------------------------------------------
# Compile pool and manifests
# ---------------------------------------------------------------------------


def test_compile_pool_manifest_round_trip(tmp_path):
    from megba_tpu_torch.factors import engine_for

    reset_process_cache()
    stats = ts.FleetStats()
    pool = CompilePool(stats=stats)
    probs = _bal_fleet()[:3]
    first = ts.solve_many(probs, OPT64, pool=pool, stats=stats)
    assert stats.pool_misses == len({str(r.shape) for r in first})
    path = str(tmp_path / "manifest.json")
    pool.save_manifest(path, dataclasses.replace(OPT64, telemetry="x.jsonl"))
    doc = json.loads(open(path).read())
    assert doc["schema"] == "megba_tpu.fleet_manifest/v1"
    assert {"shape", "lanes", "cd", "pd", "od", "factor"} <= set(
        doc["entries"][0])
    assert doc["option_config"]["telemetry"] is None
    engine = engine_for("bal", OPT64.jacobian_mode)
    reset_process_cache()
    fresh = CompilePool(stats=ts.FleetStats())
    assert fresh.warm_from_manifest(path, engine, OPT64) == len(
        doc["entries"])
    assert fresh.warm_from_manifest(path, engine, OPT64) == 0
    again = ts.solve_many(probs, OPT64, pool=fresh, stats=fresh._stats)
    assert fresh._stats.pool_hits == len(doc["entries"])
    assert fresh._stats.pool_misses == 0
    assert [_bits(a) for a in again] == [_bits(b) for b in first]
    # One program object per configuration, however it is spelled.
    assert (batched_solve_program(engine, OPT64)
            is batched_solve_program(engine, option=OPT64, faulted=False)
            is batched_solve_program(engine, dataclasses.replace(
                OPT64, telemetry="y.jsonl")))


def test_manifest_mismatch_names_fields(tmp_path):
    from megba_tpu_torch.factors import engine_for

    pool = CompilePool()
    ts.solve_many(_bal_fleet()[:1], OPT64, pool=pool)
    path = str(tmp_path / "m.json")
    pool.save_manifest(path, OPT64)
    other = dataclasses.replace(
        OPT64, robust_kind=RobustKind.HUBER,
        solver_option=SolverOption(max_iter=7))
    engine = engine_for("bal", other.jacobian_mode)
    with pytest.raises(ManifestMismatch) as e:
        pool.warm_from_manifest(path, engine, other, strict=True)
    assert e.value.fields == ["robust_kind", "solver_option.max_iter"]
    with pytest.warns(UserWarning, match="solver_option.max_iter"):
        pool.warm_from_manifest(path, engine, other)
    # Telemetry is not drift.
    pool.warm_from_manifest(path, engine, dataclasses.replace(
        OPT64, telemetry="t.jsonl"), strict=True)
    # An artifact store is taken, by path too (serving/artifacts.py), and
    # the strict warm from the matching manifest builds from it.
    from megba_tpu_torch.serving import ArtifactStore

    stored = CompilePool(artifacts=str(tmp_path / "store"))
    assert isinstance(stored.artifacts, ArtifactStore)
    assert stored.artifacts.root == str(tmp_path / "store")
    stored.warm_from_manifest(path, engine, OPT64, strict=True)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "x"}))
    with pytest.raises(ValueError, match="not a fleet warmup manifest"):
        pool.warm_from_manifest(str(bad), engine, OPT64)


# ---------------------------------------------------------------------------
# No JAX in the port
# ---------------------------------------------------------------------------


SLICE_MODULES = [
    "megba_tpu_torch.serving", "megba_tpu_torch.serving.batcher",
    "megba_tpu_torch.serving.compile_pool", "megba_tpu_torch.serving.queue",
    "megba_tpu_torch.serving.resilience",
    "megba_tpu_torch.serving.shape_class", "megba_tpu_torch.serving.stats",
    "megba_tpu_torch.algo.lanes", "megba_tpu_torch.observability.report",
    "megba_tpu_torch.observability.summarize",
    "megba_tpu_torch.utils.memo", "megba_tpu_torch.utils.meminfo",
]


def test_slice_modules_import_no_jax():
    code = ("import sys, importlib\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'megba_tpu' or "
            "m.startswith('megba_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)

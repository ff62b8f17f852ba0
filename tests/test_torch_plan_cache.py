"""The port's host plan cache (ops/segtiles.cached_*) vs the JAX package's.

- the LRU's capacity knob, its `ValueError`s and its eviction counter
  (tests/test_serving.py:470), content keys (copied arrays hit, a knob
  change misses; tests/test_precond.py:417) and every aggregation knob
  in the coarse plans' keys (tests/test_multilevel.py:448);
- `flat_solve` twice is bitwise the same solve, and over one call
  sequence (IMPLICIT twice, TWO_LEVEL twice, IMPLICIT on two graphs
  under a capacity of 1) it counts the JAX package's `plan_cache_hit`,
  `plan_cache_evict` and `cluster_plan_cache_hit` events (JAX's tiled
  lowering, the one that plans through its cache, is float32 only);
- the chunks of `solve_checkpointed` after the first hit;
- plans built for one CPU shard never serve a world-2 `["cpu"] * 2`
  solve (nor the other way round), and the cached host arrays are
  read-only;
- a fused solve's hit leaves a later unfused solve bitwise a fresh one.

CPU only, small scenes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import megba_tpu.common as jc
from megba_tpu.io.synthetic import make_synthetic_bal as j_make_synthetic_bal
from megba_tpu.ops import segtiles as jseg
from megba_tpu.ops.residuals import make_residual_jacobian_fn as j_engine
from megba_tpu.solve import flat_solve as j_flat_solve
from megba_tpu.utils.timing import PhaseTimer as JPhaseTimer

import megba_tpu_torch as mt
from megba_tpu_torch.ops import segtiles
from megba_tpu_torch.utils.timing import PhaseTimer

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

EVENTS = ("plan_cache_hit", "plan_cache_evict", "cluster_plan_cache_hit")


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch):
    monkeypatch.delenv("MEGBA_PLAN_CACHE", raising=False)
    segtiles.clear_plan_cache()
    jseg._PLAN_CACHE.clear()
    yield
    segtiles.clear_plan_cache()
    jseg._PLAN_CACHE.clear()


def _scene(dtype=np.float64, seed=3, **kw):
    return mt.make_synthetic_bal(num_cameras=8, num_points=60,
                                 obs_per_point=4, seed=seed, dtype=dtype,
                                 **kw)


def _arrays(s):
    return s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx


def _option(dtype=np.float64, **skw):
    return mt.ProblemOption(
        dtype=dtype, jacobian_mode=mt.JacobianMode.ANALYTICAL,
        algo_option=mt.AlgoOption(max_iter=3),
        solver_option=mt.SolverOption(**skw))


def _solve(s, opt, device="cpu", **kw):
    timer = PhaseTimer()
    res = mt.flat_solve(None,
                        *_arrays(s), opt, device=device, timer=timer, **kw)
    return res, {k: timer.counts.get(k, 0) for k in EVENTS}


def _bitwise(a, b):
    assert torch.equal(a.cameras, b.cameras)
    assert torch.equal(a.points, b.points)
    assert torch.equal(a.trace.cost, b.trace.cost)
    assert (a.iterations, a.accepted, a.pcg_iterations) == (
        b.iterations, b.accepted, b.pcg_iterations)


def test_plan_cache_capacity_env_and_evictions(monkeypatch):
    """MEGBA_PLAN_CACHE resizes the LRU; evictions count (JAX
    tests/test_serving.py:470)."""

    def graph(seed):
        r = np.random.default_rng(seed)
        cam = np.sort(r.integers(0, 4, size=32)).astype(np.int32)
        pt = r.integers(0, 16, size=32).astype(np.int32)
        return cam, pt

    monkeypatch.setenv("MEGBA_PLAN_CACHE", "2")
    base_ev = segtiles.plan_cache_evictions()
    for seed in range(4):  # 4 distinct graphs through a capacity-2 LRU
        cam, pt = graph(seed)
        _, hit = segtiles.cached_dual_plans(cam, pt, 4, 16, device="cpu")
        assert not hit
    assert len(segtiles._PLAN_CACHE) == 2
    assert segtiles.plan_cache_evictions() - base_ev == 2
    # LRU order: the two newest graphs are hits, the oldest was evicted.
    cam, pt = graph(3)
    _, hit = segtiles.cached_dual_plans(cam, pt, 4, 16, device="cpu")
    assert hit
    cam, pt = graph(0)
    _, hit = segtiles.cached_dual_plans(cam, pt, 4, 16, device="cpu")
    assert not hit

    for bad in ("zero", "0"):
        monkeypatch.setenv("MEGBA_PLAN_CACHE", bad)
        with pytest.raises(ValueError, match="MEGBA_PLAN_CACHE") as tinfo:
            segtiles.plan_cache_capacity()
        with pytest.raises(ValueError, match="MEGBA_PLAN_CACHE") as jinfo:
            jseg.plan_cache_capacity()
        assert str(tinfo.value) == str(jinfo.value)
    monkeypatch.delenv("MEGBA_PLAN_CACHE")
    assert segtiles.plan_cache_capacity() == 8 == jseg.plan_cache_capacity()


def test_cluster_plan_rides_content_cache():
    """Copied arrays hit, another target misses (JAX
    tests/test_precond.py:417)."""
    s = mt.make_synthetic_bal(num_cameras=8, num_points=40, obs_per_point=4,
                              seed=7)
    (p1, d1), hit1 = segtiles.cached_cluster_plan(s.cam_idx, s.pt_idx, 8,
                                                  40, devices=["cpu"])
    (p2, d2), hit2 = segtiles.cached_cluster_plan(
        s.cam_idx.copy(), s.pt_idx.copy(), 8, 40, devices=["cpu"])
    assert not hit1 and hit2
    assert p1 is p2 and d1 is d2
    (_, _), hit3 = segtiles.cached_cluster_plan(s.cam_idx, s.pt_idx, 8, 40,
                                                4, devices=["cpu"])
    assert not hit3
    # The same plan as JAX's at world size 1.
    (jp, _), _ = jseg.cached_cluster_plan(s.cam_idx, s.pt_idx, 8, 40)
    np.testing.assert_array_equal(p1.cluster, jp.cluster)
    assert p1.num_clusters == jp.num_clusters


def test_plan_cache_keys_on_every_aggregation_knob():
    """Every aggregation knob is in the coarse keys (JAX
    tests/test_multilevel.py:448), and so are the shards."""
    s = mt.make_synthetic_bal(num_cameras=12, num_points=60,
                              obs_per_point=3, seed=9, locality="ring")
    kw = dict(coarsen_factor=2.0, max_levels=3, smooth_omega=0.0,
              devices=["cpu"])
    (_, d1), h1 = segtiles.cached_multilevel_plan(s.cam_idx, s.pt_idx, 12,
                                                  60, **kw)
    (_, d2), h2 = segtiles.cached_multilevel_plan(
        s.cam_idx.copy(), s.pt_idx.copy(), 12, 60, **kw)
    assert not h1 and h2 and d1 is d2
    for flip in (dict(kw, coarsen_factor=3.0), dict(kw, max_levels=4),
                 dict(kw, smooth_omega=0.5)):
        (_, _), hit = segtiles.cached_multilevel_plan(s.cam_idx, s.pt_idx,
                                                      12, 60, **flip)
        assert not hit, flip
    (_, _), c1 = segtiles.cached_cluster_plan(s.cam_idx, s.pt_idx, 12, 60,
                                              devices=["cpu"])
    (_, _), c2 = segtiles.cached_cluster_plan(s.cam_idx, s.pt_idx, 12, 60,
                                              smooth_omega=0.7,
                                              devices=["cpu"])
    assert not c1 and not c2
    n = s.cam_idx.shape[0]
    halves = [np.arange(n // 2), np.arange(n // 2, n)]
    (_, ds), c3 = segtiles.cached_cluster_plan(
        s.cam_idx, s.pt_idx, 12, 60, devices=["cpu"] * 2, shards=halves)
    assert not c3 and len(ds.shards) == 2
    (_, _), c4 = segtiles.cached_cluster_plan(
        s.cam_idx, s.pt_idx, 12, 60, devices=["cpu"] * 2,
        shards=[halves[0][:-1], np.arange(n // 2 - 1, n)])
    assert not c4


def test_second_flat_solve_is_bitwise_and_counts_jax_events(monkeypatch):
    """One call sequence through both packages' flat_solve: IMPLICIT
    twice, TWO_LEVEL twice (the second a hit of both plans), then under
    a capacity of 1 IMPLICIT on another graph (evicting both entries) and
    on the first graph again (evicting that one).  float32: JAX plans
    through its cache on the tiled lowering only, which is float32
    only."""
    scenes = [(_scene(np.float32, seed=k),
               j_make_synthetic_bal(num_cameras=8, num_points=60,
                                    obs_per_point=4, seed=k,
                                    dtype=np.float32)) for k in (3, 4)]
    for t, j in scenes:
        np.testing.assert_array_equal(j.cam_idx, t.cam_idx)
    f = j_engine(mode=jc.JacobianMode.ANALYTICAL)
    jbase = jc.ProblemOption(dtype=np.float32,
                             jacobian_mode=jc.JacobianMode.ANALYTICAL,
                             algo_option=jc.AlgoOption(max_iter=3))
    jtwo = dataclasses.replace(jbase, solver_option=jc.SolverOption(
        precond=jc.PrecondKind.TWO_LEVEL))
    tbase = _option(np.float32)
    ttwo = _option(np.float32, precond=mt.PrecondKind.TWO_LEVEL)
    steps = [(jbase, tbase, None, 0), (jbase, tbase, None, 0),
             (jtwo, ttwo, None, 0), (jtwo, ttwo, None, 0),
             (jbase, tbase, "1", 1), (jbase, tbase, "1", 0)]
    runs = []
    for jopt, topt, cap, k in steps:
        if cap is not None:
            monkeypatch.setenv("MEGBA_PLAN_CACHE", cap)
        s, js = scenes[k]
        jt = JPhaseTimer()
        jres = j_flat_solve(f, js.cameras0, js.points0, js.obs, js.cam_idx,
                            js.pt_idx, jopt, use_tiled=True, timer=jt)
        tres, tev = _solve(s, topt)
        jev = {e: jt.counts.get(e, 0) for e in EVENTS}
        assert tev == jev, (topt.solver_option.precond, cap, k)
        np.testing.assert_allclose(float(tres.cost), float(jres.cost),
                                   rtol=1e-4)
        runs.append((tres, tev))
    assert [r[1]["plan_cache_hit"] for r in runs] == [0, 1, 1, 1, 0, 0]
    assert [r[1]["cluster_plan_cache_hit"] for r in runs] == [
        0, 0, 0, 1, 0, 0]
    assert [r[1]["plan_cache_evict"] for r in runs] == [0, 0, 0, 0, 2, 1]
    _bitwise(runs[0][0], runs[1][0])
    _bitwise(runs[2][0], runs[3][0])
    _bitwise(runs[0][0], runs[5][0])
    # A hit's coarse_plan_seconds is the lookup's.
    assert runs[3][0].coarse_plan_seconds is not None


@pytest.mark.parametrize("precond", ["JACOBI", "MULTILEVEL"])
def test_f64_second_solve_bitwise(precond):
    s = _scene()
    opt = _option(precond=getattr(mt.PrecondKind, precond))
    a, ea = _solve(s, opt)
    b, eb = _solve(s, opt)
    assert ea == dict.fromkeys(EVENTS, 0)
    assert eb["plan_cache_hit"] == 1
    assert eb["cluster_plan_cache_hit"] == (precond != "JACOBI")
    _bitwise(a, b)


def test_checkpointed_chunks_hit(tmp_path):
    s = _scene()
    opt = dataclasses.replace(_option(), algo_option=mt.AlgoOption(
        max_iter=6, epsilon1=1e-12, epsilon2=1e-15))
    timer = PhaseTimer()
    res = mt.solve_checkpointed(None,
        *_arrays(s), opt, checkpoint_path=str(tmp_path / "snap.npz"),
        checkpoint_every=2, device="cpu", timer=timer)
    chunks = timer.counts["dispatch"]
    assert chunks == 3 and res.iterations == 6
    assert timer.counts.get("plan_cache_hit", 0) == chunks - 1


def test_cpu_plans_never_serve_a_world2_solve():
    s = _scene()
    one = _option()
    two = dataclasses.replace(one, world_size=2)
    _, e1 = _solve(s, one)
    w2a, e2 = _solve(s, two, device=["cpu"] * 2)
    assert e1["plan_cache_hit"] == 0 and e2["plan_cache_hit"] == 0
    w2b, e3 = _solve(s, two, device=["cpu"] * 2)
    assert e3["plan_cache_hit"] == 1
    _bitwise(w2a, w2b)
    _, e4 = _solve(s, one)
    assert e4["plan_cache_hit"] == 1
    # The keys hold the devices: one shard and two shards never share.
    (p1, _), h1 = segtiles.cached_sharded_dual_plans(
        s.cam_idx, s.pt_idx, 8, 60, ["cpu"])
    (p2, _), h2 = segtiles.cached_sharded_dual_plans(
        s.cam_idx, s.pt_idx, 8, 60, ["cpu", "cpu"])
    assert h1 and h2 and len(p1) == 1 and len(p2) == 2
    # A cached plan's host arrays are read-only.
    with pytest.raises(ValueError):
        p2[0][0] = 0


def test_fused_hit_leaves_unfused_solve_fresh():
    s = _scene()
    plain = _option()
    fused = _option(fused_kernels=True)
    fresh, _ = _solve(s, plain)
    fused_a, ef = _solve(s, fused)
    assert ef["plan_cache_hit"] == 1
    again, ea = _solve(s, plain)
    assert ea["plan_cache_hit"] == 1
    _bitwise(fresh, again)
    (_, plans), _ = segtiles.cached_sharded_dual_plans(
        s.cam_idx, s.pt_idx, 8, 60, ["cpu"])
    assert plans[0].fused_to_pt is None and plans[0].fused_to_cam is None
    segtiles.clear_plan_cache()
    fused_b, eb = _solve(s, fused)
    assert eb["plan_cache_hit"] == 0
    _bitwise(fused_a, fused_b)

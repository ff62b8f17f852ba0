"""The port's native host runtime (megba_tpu_torch/native/) vs the JAX
package's, built here with g++.

- the native BAL parse is `array_equal` to JAX's `parse_bal_native`, to
  the port's NumPy tokenizer and to the parse of a `.bz2` archive of the
  same file; a truncated file gives JAX's error; a semantic error is
  raised as it is, a syntax error by the NumPy tokenizer;
- `sort_edges_by_camera`, `degree_stats` and `partition_bounds` equal
  JAX's and `np.argsort(kind="stable")`;
- the four sites that now sort through the counting sort give the plans
  an `np.argsort(kind="stable")` gives: `build_seg_plan` (both sides of
  `make_dual_plans`), `make_sharded_dual_plans`, `flat_solve`'s coarse
  plan and `serving/shape_class.pad_to_class`.

CPU only.
"""

import bz2

import numpy as np
import pytest
import torch

from megba_tpu import native as jnative
from megba_tpu.io.bal import BALFile as JBALFile
from megba_tpu.io.bal import save_bal as j_save_bal
from megba_tpu.io.synthetic import make_synthetic_bal as j_make_synthetic_bal

import megba_tpu_torch as mt
from megba_tpu_torch import native
from megba_tpu_torch.io import bal as tbal
from megba_tpu_torch.ops import segtiles
from megba_tpu_torch.serving import shape_class

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

FIELDS = ("cameras", "points", "obs", "cam_idx", "pt_idx")


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native library unavailable (g++ build failed)")
    return lib


def _equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y)


def _bal_file(tmp_path, seed=9):
    s = j_make_synthetic_bal(num_cameras=5, num_points=40, obs_per_point=3,
                             seed=seed)
    p = str(tmp_path / "prob.txt")
    j_save_bal(p, JBALFile(cameras=s.cameras0, points=s.points0, obs=s.obs,
                           cam_idx=s.cam_idx, pt_idx=s.pt_idx))
    return p


def test_native_builds_outside_the_package(lib):
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "megba_tpu_torch"
    assert path.parent.parent.name == "build"
    assert not list(native._DIR.glob("*.so"))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_native_parse_matches_jax_and_numpy(lib, tmp_path, dtype):
    p = _bal_file(tmp_path)
    t = native.parse_bal_native(p, dtype)
    j = jnative.parse_bal_native(p, dtype)
    assert j is not None
    _equal(t, j)
    with open(p, "rb") as f:
        tokens = np.fromfile(f, sep=" ")
    _equal(t, tbal._assemble(tokens, dtype))
    _equal(t, tbal.load_bal(p, dtype))
    arch = tmp_path / "prob.txt.bz2"
    arch.write_bytes(bz2.compress(open(p, "rb").read()))
    _equal(t, tbal.load_bal(str(arch), dtype))
    # The expanded temp file is gone.
    assert sorted(x.name for x in tmp_path.iterdir()) == [
        "prob.txt", "prob.txt.bz2"]


def test_save_bal_round_trips_through_both_parsers(lib, tmp_path):
    s = mt.make_synthetic_bal(num_cameras=5, num_points=40,
                              obs_per_point=3, seed=2)
    bal = tbal.BALFile(cameras=s.cameras0, points=s.points0, obs=s.obs,
                       cam_idx=s.cam_idx, pt_idx=s.pt_idx)
    p = str(tmp_path / "mine.txt")
    tbal.save_bal(p, bal)
    q = str(tmp_path / "jax.txt")
    j_save_bal(q, JBALFile(**{f: getattr(bal, f) for f in FIELDS}))
    assert open(p, "rb").read() == open(q, "rb").read()
    _equal(native.parse_bal_native(p), bal)


def test_native_parse_rejects_truncated(lib, tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("2 2 3\n0 0 1.0 2.0\n")
    with pytest.raises(ValueError, match="parse failed") as tinfo:
        native.parse_bal_native(str(p))
    with pytest.raises(ValueError, match="parse failed") as jinfo:
        jnative.parse_bal_native(str(p))
    assert str(tinfo.value) == str(jinfo.value)
    # load_bal leaves the last word to the NumPy tokenizer.
    with pytest.raises(ValueError, match="token count mismatch"):
        tbal.load_bal(str(p))


def test_semantic_error_is_raised_from_the_native_parse(lib, tmp_path):
    p = tmp_path / "dup.txt"
    p.write_text("1 1 2\n0 0 1.0 2.0\n0 0 1.0 2.0\n"
                 + "0\n" * 9 + "0\n0\n-1\n")
    with pytest.raises(ValueError, match="BAL semantic error"):
        tbal.load_bal(str(p))


def test_numpy_fallback_without_the_library(monkeypatch, tmp_path):
    p = _bal_file(tmp_path)
    ref = native.parse_bal_native(p)
    cam = np.random.default_rng(1).integers(0, 30, 500).astype(np.int32)
    pt = np.random.default_rng(2).integers(0, 70, 500).astype(np.int32)
    want = (native.sort_edges_by_camera(cam, 30),
            native.degree_stats(np.sort(cam), pt, 30, 70),
            native.partition_bounds(10, 4))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert not native.available()
    assert native.parse_bal_native(p) is None
    _equal(tbal.load_bal(p), ref)
    np.testing.assert_array_equal(native.sort_edges_by_camera(cam, 30),
                                  want[0])
    got = native.degree_stats(np.sort(cam), pt, 30, 70)
    np.testing.assert_array_equal(got[0], want[1][0])
    np.testing.assert_array_equal(got[1], want[1][1])
    assert got[2] == want[1][2]
    np.testing.assert_array_equal(native.partition_bounds(10, 4), want[2])


@pytest.mark.parametrize("num_keys", [1, 50, 4096])
def test_sort_edges_matches_jax_and_argsort(lib, num_keys):
    rng = np.random.default_rng(num_keys)
    key = rng.integers(0, num_keys, size=5000).astype(np.int32)
    perm = native.sort_edges_by_camera(key, num_keys)
    assert perm.dtype == np.int64
    np.testing.assert_array_equal(perm, np.argsort(key, kind="stable"))
    np.testing.assert_array_equal(perm,
                                  jnative.sort_edges_by_camera(key, num_keys))
    with pytest.raises(ValueError, match="sort_edges failed"):
        native.sort_edges_by_camera(key, num_keys - 1 if num_keys > 1 else 0)


def test_degree_stats_and_partition_bounds_match_jax(lib):
    rng = np.random.default_rng(0)
    cam = np.sort(rng.integers(0, 20, 400)).astype(np.int32)
    pt = rng.integers(0, 90, 400).astype(np.int32)
    for c in (cam, cam[::-1].copy()):
        t = native.degree_stats(c, pt, 20, 90)
        j = jnative.degree_stats(c, pt, 20, 90)
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
        assert t[2] == j[2]
    assert native.degree_stats(cam[::-1].copy(), pt, 20, 90)[2][2] == -1
    for n, w in ((10, 4), (8, 4), (0, 3), (7, 1)):
        np.testing.assert_array_equal(native.partition_bounds(n, w),
                                      jnative.partition_bounds(n, w))


def _argsort_seg_plan(idx, num_segments):
    idx = np.asarray(idx).astype(np.int64)
    order = np.argsort(idx, kind="stable")
    seg = idx[order]
    seg_ptr = np.zeros(num_segments + 1, np.int64)
    np.cumsum(np.bincount(seg, minlength=num_segments), out=seg_ptr[1:])
    return order, seg, seg_ptr


def test_replaced_sorts_give_unchanged_plans(lib):
    s = mt.make_synthetic_bal(num_cameras=9, num_points=70, obs_per_point=4,
                              seed=5)
    rng = np.random.default_rng(5)
    shuffle = rng.permutation(s.cam_idx.shape[0])
    cam, pt = s.cam_idx[shuffle], s.pt_idx[shuffle]
    # build_seg_plan, both sides of make_dual_plans.
    plan_c, dp = segtiles.make_dual_plans(cam, pt, 9, 70, "cpu")
    order, seg, ptr = _argsort_seg_plan(cam, 9)
    np.testing.assert_array_equal(plan_c.perm, order)
    np.testing.assert_array_equal(plan_c.seg, seg)
    np.testing.assert_array_equal(plan_c.seg_ptr, ptr)
    p_order, p_seg, p_ptr = _argsort_seg_plan(pt[order], 70)
    np.testing.assert_array_equal(dp.pt.inv.numpy(), p_order)
    np.testing.assert_array_equal(dp.pt.seg.numpy(), p_seg)
    np.testing.assert_array_equal(dp.pt.seg_ptr.numpy(), p_ptr)
    # make_sharded_dual_plans.
    perms, _ = segtiles.make_sharded_dual_plans(cam, pt, 9, 70,
                                                ["cpu"] * 3)
    n = cam.shape[0]
    bounds = [(k * n) // 3 for k in range(4)]
    for k, perm in enumerate(perms):
        sel = order[bounds[k]:bounds[k + 1]]
        np.testing.assert_array_equal(
            perm, sel[np.argsort(cam[sel], kind="stable")])
    # serving/shape_class.pad_to_class.
    shape = shape_class.classify(9, 70, n, np.float64,
                                   shape_class.BucketLadder())
    padded = shape_class.pad_to_class(s.cameras0, s.points0,
                                      s.obs[shuffle], cam, pt, shape)
    np.testing.assert_array_equal(padded.perm, order)


def test_coarse_plan_sort_gives_unchanged_plan(lib):
    """flat_solve's coarse plan over the counting sort's canonical stream
    equals the plan over np.argsort's."""
    s = mt.make_synthetic_bal(num_cameras=9, num_points=70, obs_per_point=4,
                              seed=6, locality="ring")
    rng = np.random.default_rng(6)
    shuffle = rng.permutation(s.cam_idx.shape[0])
    cam, pt = s.cam_idx[shuffle], s.pt_idx[shuffle]
    segtiles.clear_plan_cache()
    opt = mt.ProblemOption(
        algo_option=mt.AlgoOption(max_iter=1),
        solver_option=mt.SolverOption(precond=mt.PrecondKind.TWO_LEVEL))
    from megba_tpu_torch.solve import _coarse_plan
    from megba_tpu_torch.utils.timing import PhaseTimer

    order = np.argsort(cam, kind="stable")
    plan, _ = _coarse_plan(opt, cam, pt, np.ones(cam.shape[0]), 9, 70,
                           ["cpu"], [order], PhaseTimer())
    ref = segtiles.build_cluster_plan(cam[order], pt[order], 9, 70)
    got = plan.shards[0]
    np.testing.assert_array_equal(got.cluster.numpy(), ref.cluster)
    assert got.num_clusters == ref.num_clusters and got.n_pc == ref.n_pc
    np.testing.assert_array_equal(got.pc_pt.numpy(), ref.pc_pt)
    np.testing.assert_array_equal(got.ec_slot.numpy(), ref.ec_slot)
    segtiles.clear_plan_cache()

"""The port's camera-cluster planners (ops/segtiles.py) vs the JAX
package's.

- `build_camera_clusters` is `array_equal` to JAX's on expander, ring and
  grid scenes, with and without an edge mask and a cluster target;
- `build_cluster_plan` over the port's stream (the camera slots of a
  shuffled scene) against JAX's over its own (the stable camera sort,
  padded and masked as its unfused lowering plans it): equal `cluster`,
  `pc_slot` (real edges), `pc_pt`, `n_pc` and `n_ec`, and equal sets of
  edge-incidence triples with the edges mapped back to the caller's ids;
- `build_multilevel_plan`'s `level_sizes` and `assign` equal JAX's, with
  the same ValueErrors;
- the ports of tests/test_precond.py:356 and :371 and
  tests/test_multilevel.py:429, and the device plan's segment plans and
  pair chunks.

Host NumPy and the CPU only.
"""

import numpy as np
import pytest
import torch

from megba_tpu.core.fm import EDGE_QUANTUM
from megba_tpu.core.types import pad_edges
from megba_tpu.ops import segtiles as jseg

import megba_tpu_torch as mt
from megba_tpu_torch.ops import segtiles as tseg

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

_SCENES = {
    "expander": dict(num_cameras=20, num_points=150, obs_per_point=4,
                     seed=5),
    "ring": dict(num_cameras=24, num_points=160, obs_per_point=4, seed=1,
                 locality="ring"),
    "grid": dict(num_cameras=18, num_points=140, obs_per_point=3.5, seed=2,
                 locality="grid"),
}


def _scene(name):
    return mt.make_synthetic_bal(**_SCENES[name])


def _mask(n, seed=4):
    """A seeded edge mask with ~15 % of the edges soft-deleted."""
    return (np.random.default_rng(seed).random(n) > 0.15).astype(np.float64)


def _streams(s, shuffle_seed=7):
    """The caller's edges in a seeded order; the port's stream (its camera
    slots) and JAX's (the stable camera sort, padded) with the caller ids
    of their edges (-1 on padding)."""
    n = s.cam_idx.shape[0]
    order = np.random.default_rng(shuffle_seed).permutation(n)
    ci, pi = s.cam_idx[order], s.pt_idx[order]
    mask = _mask(n)
    plan_c, _ = tseg.make_dual_plans(ci, pi, s.cameras0.shape[0],
                                     s.points0.shape[0], "cpu")
    port = (ci[plan_c.perm], pi[plan_c.perm], mask[plan_c.perm],
            plan_c.perm)
    jperm = np.argsort(ci, kind="stable")
    _, jci, jpi, pad_mask = pad_edges(np.zeros((n, 2)), ci[jperm],
                                      pi[jperm], EDGE_QUANTUM)
    jmask = pad_mask * np.concatenate([mask[jperm],
                                       np.zeros(jci.shape[0] - n)])
    jids = np.concatenate([jperm, -np.ones(jci.shape[0] - n, np.int64)])
    return port, (jci, jpi, jmask, jids)


@pytest.mark.parametrize("target", [0, 5])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("name", list(_SCENES))
def test_camera_clusters_match_jax(name, masked, target):
    s = _scene(name)
    (ci, pi, mask, _), _ = _streams(s)
    m = mask if masked else None
    nc = s.cameras0.shape[0]
    got = tseg.build_camera_clusters(ci, pi, nc, target, m)
    want = jseg.build_camera_clusters(ci, pi, nc, target, m)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.max() + 1 >= (target or int(np.ceil(np.sqrt(nc))))


@pytest.mark.parametrize("name", list(_SCENES))
def test_cluster_plan_matches_jax(name):
    s = _scene(name)
    nc, npt = s.cameras0.shape[0], s.points0.shape[0]
    (ci, pi, mask, ids), (jci, jpi, jmask, jids) = _streams(s)
    got = tseg.build_cluster_plan(ci, pi, nc, npt, mask=mask)
    want = jseg.build_cluster_plan(jci, jpi, nc, npt, mask=jmask)
    np.testing.assert_array_equal(got.cluster, want.cluster)
    assert (got.num_clusters, got.n_pc, got.n_ec) == (
        want.num_clusters, want.n_pc, want.n_ec)
    np.testing.assert_array_equal(got.pc_pt, want.pc_pt)
    # Each real edge's incidence, by caller id; masked edges are inert.
    real = mask > 0
    by_id = np.full(ids.shape[0], -1)
    by_id[ids[real]] = got.pc_slot[real]
    jreal = jmask > 0
    jby_id = np.full(ids.shape[0], -1)
    jby_id[jids[jreal]] = want.pc_slot[jreal]
    np.testing.assert_array_equal(by_id, jby_id)
    assert (got.pc_slot[~real] == got.n_pc).all()

    def triples(edge_ids, plan):
        return sorted(zip(edge_ids[plan.ec_edge].tolist(),
                          plan.ec_slot.tolist(), plan.ec_seg.tolist()))

    assert triples(ids, got) == triples(jids, want)
    assert len(triples(ids, got)) == got.n_ec
    # The port's pairs are stably sorted by segment.
    assert (np.diff(got.ec_seg) >= 0).all()
    for seg in np.unique(got.ec_seg)[:5]:
        edges = got.ec_edge[got.ec_seg == seg]
        assert (np.diff(edges) >= 0).all()


@pytest.mark.parametrize("knobs", [dict(), dict(coarsen_factor=2.0,
                                                max_levels=5),
                                   dict(target=8, coarsen_factor=3.0,
                                        max_levels=4)])
@pytest.mark.parametrize("name", ["ring", "grid"])
def test_multilevel_plan_matches_jax(name, knobs):
    s = _scene(name)
    nc, npt = s.cameras0.shape[0], s.points0.shape[0]
    (ci, pi, mask, _), (jci, jpi, jmask, _) = _streams(s)
    got = tseg.build_multilevel_plan(ci, pi, nc, npt, mask=mask, **knobs)
    want = jseg.build_multilevel_plan(jci, jpi, nc, npt, mask=jmask,
                                      **knobs)
    assert got.level_sizes == want.level_sizes
    assert len(got.assign) == len(want.assign)
    for a, b in zip(got.assign, want.assign):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.base.cluster, want.base.cluster)


@pytest.mark.parametrize("bad,match", [
    (dict(coarsen_factor=1.0), "coarsen_factor must be > 1"),
    (dict(max_levels=1), "max_levels must be >= 2")])
def test_multilevel_plan_value_errors_match_jax(bad, match):
    s = _scene("ring")
    args = (s.cam_idx, s.pt_idx, s.cameras0.shape[0], s.points0.shape[0])
    with pytest.raises(ValueError, match=match):
        tseg.build_multilevel_plan(*args, **bad)
    with pytest.raises(ValueError, match=match):
        jseg.build_multilevel_plan(*args, **bad)


# ------------------------------------------------- ports of the JAX tests


def test_camera_clusters_partition_and_cap():
    """tests/test_precond.py:356."""
    s = mt.make_synthetic_bal(num_cameras=20, num_points=120,
                              obs_per_point=4, seed=5)
    cluster = tseg.build_camera_clusters(s.cam_idx, s.pt_idx, 20)
    assert cluster.shape == (20,)
    C = int(cluster.max()) + 1
    target = int(np.ceil(np.sqrt(20)))
    assert C >= target
    _, counts = np.unique(cluster, return_counts=True)
    assert counts.max() <= -(-20 // target)
    assert np.all(cluster >= 0)


def test_cluster_plan_index_streams_are_consistent():
    """tests/test_precond.py:371 on one device, with the port's sorted
    streams and segment plans; masked edges take the padding's place."""
    s = mt.make_synthetic_bal(num_cameras=9, num_points=50, obs_per_point=4,
                              seed=6)
    nE = len(s.cam_idx)
    mask = np.ones(nE)
    mask[[3, 17, 40]] = 0.0
    cam_idx, pt_idx = s.cam_idx, s.pt_idx
    plan = tseg.build_cluster_plan(cam_idx, pt_idx, 9, 50, mask=mask)
    C = plan.num_clusters
    for e in range(nE):
        slot = plan.pc_slot[e]
        if mask[e] == 0:
            assert slot == plan.n_pc
            continue
        assert slot < plan.n_pc and plan.pc_pt[slot] == pt_idx[e]
    slot_cluster = np.full(plan.n_pc, -1)
    for e in np.flatnonzero(mask):
        slot_cluster[plan.pc_slot[e]] = plan.cluster[cam_idx[e]]
    assert plan.ec_edge.shape == (plan.n_ec,)
    for ge, slot, seg in zip(plan.ec_edge, plan.ec_slot, plan.ec_seg):
        assert mask[ge] == 1
        assert plan.pc_pt[slot] == pt_idx[ge]
        assert seg == cam_idx[ge] * C + slot_cluster[slot]
    # Σ_e k_{pt(e)} pairs over the real edges.
    k_of_pt = np.bincount(plan.pc_pt, minlength=50)
    assert plan.n_ec == int(k_of_pt[pt_idx[mask > 0]].sum())
    # pc_order: the real edges stably sorted by incidence.
    np.testing.assert_array_equal(
        plan.pc_order, np.flatnonzero(mask)[np.argsort(
            plan.pc_slot[mask > 0], kind="stable")])


def test_multilevel_plan_shrinks_and_partitions():
    """tests/test_multilevel.py:429."""
    s = mt.make_synthetic_bal(num_cameras=40, num_points=300,
                              obs_per_point=4, seed=0, locality="grid")
    mp = tseg.build_multilevel_plan(s.cam_idx, s.pt_idx, 40, 300,
                                    coarsen_factor=2.0, max_levels=5)
    sizes = mp.level_sizes
    assert all(sizes[i + 1] < sizes[i] for i in range(len(sizes) - 1))
    assert len(sizes) == len(mp.assign) + 1
    for i, a in enumerate(mp.assign):
        assert a.shape == (sizes[i],)
        assert set(np.unique(a)) == set(range(sizes[i + 1]))
    top = mp.base.cluster.copy()
    for a in mp.assign:
        top = a[top]
    assert top.shape == (40,) and top.max() < sizes[-1]


@pytest.mark.parametrize("chunk", [tseg.EC_CHUNK_PAIRS, 64, 1])
def test_device_cluster_plan_segments_and_chunks(chunk, monkeypatch):
    s = _scene("grid")
    nc, npt = s.cameras0.shape[0], s.points0.shape[0]
    mask = _mask(s.cam_idx.shape[0])
    plan = tseg.build_cluster_plan(s.cam_idx, s.pt_idx, nc, npt, mask=mask)
    monkeypatch.setattr(tseg, "EC_CHUNK_PAIRS", chunk)
    dp = tseg.device_cluster_plan(plan, torch.device("cpu"))
    # Incidence plan: the real edges in incidence order, CSR offsets.
    assert dp.pc.num_segments == plan.n_pc
    np.testing.assert_array_equal(dp.pc.inv.numpy(), plan.pc_order)
    np.testing.assert_array_equal(dp.pc.seg.numpy(),
                                  plan.pc_slot[plan.pc_order])
    counts = np.bincount(plan.pc_slot[mask > 0], minlength=plan.n_pc)
    np.testing.assert_array_equal(np.diff(dp.pc.seg_ptr.numpy()), counts)
    # Pair chunks tile the pairs and the segments, each ending on a
    # segment boundary and holding at most `chunk` pairs unless a single
    # segment is longer.
    n_seg = nc * plan.num_clusters
    p_end = s_end = 0
    for p0, p1, s0, sp in dp.ec_chunks:
        assert (p0, s0) == (p_end, s_end)
        assert sp.n_slots == p1 - p0
        assert p1 - p0 <= chunk or sp.num_segments == 1
        np.testing.assert_array_equal(sp.seg.numpy() + s0,
                                      plan.ec_seg[p0:p1])
        np.testing.assert_array_equal(sp.inv.numpy(), plan.ec_edge[p0:p1])
        assert int(sp.seg_ptr[0]) == 0 and int(sp.seg_ptr[-1]) == p1 - p0
        p_end, s_end = p1, s0 + sp.num_segments
    assert (p_end, s_end) == (plan.n_ec, n_seg)
    if chunk == 1 << 25:
        assert len(dp.ec_chunks) == 1

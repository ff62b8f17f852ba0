"""The coarse spaces and SCHUR_DIAG on the port's edge-sharded mesh vs the
JAX package, on the CPU, float64.

- the plans: the port's cluster plan over a stream and its split over
  two contiguous shards (`ops.segtiles.shard_cluster_plan`) against
  JAX's `build_cluster_plan(world_size=2)`: cluster ids, incidences and
  pc-slots `array_equal`, and each shard's pairs equal to JAX's shard
  group with its padding stripped, in the port's order (stably sorted
  by segment; the JAX groups keep edge order); the same for
  `build_multilevel_plan`, assignments included.  JAX's grouping needs
  equal shards (it raises otherwise); the port's split takes the shard
  bounds, so shards of other lengths are checked against one plan over
  the whole stream;
- the cluster ids of `flat_solve`'s coarse plan, which every mesh plans
  over the camera-sorted real edges (the world-1 stream), equal those
  JAX plans over its padded world-2 stream; shards that are not
  contiguous pieces of the stream (the 2-D mesh's device blocks) split
  the same plan;
- `flat_solve` at world 2 with TWO_LEVEL on IMPLICIT (and fixed
  cameras on EXPLICIT), MULTILEVEL smoothed on EXPLICIT and SCHUR_DIAG
  on IMPLICIT against JAX's world-2 solve: trial costs at rtol 1e-9,
  equal accept pattern, LM / PCG counts, status and `precond_fallback`
  traces; against the port's world-1 solve at rtol 1e-9; and TWO_LEVEL
  on the 2 x 2 mesh against the port's world 1 (the same coarse space:
  the JAX package would plan the 2-D mesh's over its 2-D stream, whose
  order can merge other cameras).

CPU only.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from megba_tpu.core.types import pad_edges as j_pad_edges
from megba_tpu.ops import segtiles as jseg

import megba_tpu_torch as mt
from megba_tpu_torch.ops import segtiles as tseg

from test_torch_guards import _args, _jax_solve, _options, compare_robust

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

TWO, MULTI = mt.PrecondKind.TWO_LEVEL, mt.PrecondKind.MULTILEVEL


def _scene():
    return mt.make_synthetic_bal(num_cameras=16, num_points=120,
                                 obs_per_point=4, seed=0, locality="ring")


def _stream(s):
    """The scene's camera-sorted edges, cut to an even count."""
    order = np.argsort(s.cam_idx, kind="stable")
    n = order.shape[0] // 4 * 4
    ci, pi = s.cam_idx[order][:n], s.pt_idx[order][:n]
    mask = np.ones(n)
    mask[::7] = 0.0  # soft-deleted edges take no incidence
    return ci, pi, mask


def _pieces(bounds):
    return [np.arange(bounds[k], bounds[k + 1])
            for k in range(len(bounds) - 1)]


def _jax_group(plan, k, ws):
    """JAX shard group k of the pairs, padding stripped, stably sorted by
    segment (the port's order)."""
    L = plan.ec_edge.shape[0] // ws
    sl = slice(k * L, (k + 1) * L)
    e, sl_, sg = plan.ec_edge[sl], plan.ec_slot[sl], plan.ec_seg[sl]
    real = sg < plan.num_cameras * plan.num_clusters
    order = np.argsort(sg[real], kind="stable")
    return e[real][order], sl_[real][order], sg[real][order]


@pytest.mark.parametrize("ws", [2, 4])
def test_cluster_plan_shards_match_jax_grouping(ws):
    s = _scene()
    ci, pi, mask = _stream(s)
    nc, npt = 16, 120
    j = jseg.build_cluster_plan(ci, pi, nc, npt, 0, mask=mask,
                                world_size=ws)
    t = tseg.build_cluster_plan(ci, pi, nc, npt, 0, mask=mask)
    np.testing.assert_array_equal(t.cluster, j.cluster)
    np.testing.assert_array_equal(t.pc_slot, j.pc_slot)
    np.testing.assert_array_equal(t.pc_pt, j.pc_pt)
    assert (t.n_pc, t.n_ec, t.num_clusters) == (j.n_pc, j.n_ec,
                                               j.num_clusters)
    n = ci.shape[0]
    bounds = [k * n // ws for k in range(ws + 1)]
    shards = tseg.shard_cluster_plan(t, _pieces(bounds))
    assert sum(p.n_ec for p in shards) == t.n_ec
    for k, p in enumerate(shards):
        e, sl, sg = _jax_group(j, k, ws)
        np.testing.assert_array_equal(p.ec_edge, e)
        np.testing.assert_array_equal(p.ec_slot, sl)
        np.testing.assert_array_equal(p.ec_seg, sg)
        np.testing.assert_array_equal(p.pc_slot, t.pc_slot[bounds[k]:
                                                           bounds[k + 1]])
        assert ((p.pc_order >= 0) & (p.pc_order < bounds[k + 1]
                                     - bounds[k])).all()


def test_multilevel_plan_shards_match_jax():
    s = _scene()
    ci, pi, mask = _stream(s)
    j = jseg.build_multilevel_plan(ci, pi, 16, 120, 0, mask=mask,
                                   world_size=2, coarsen_factor=2.0,
                                   max_levels=4)
    t = tseg.build_multilevel_plan(ci, pi, 16, 120, 0, mask=mask,
                                   coarsen_factor=2.0, max_levels=4)
    assert t.level_sizes == j.level_sizes and len(t.level_sizes) >= 3
    for a, b in zip(t.assign, j.assign):
        np.testing.assert_array_equal(a, b)
    n = ci.shape[0]
    for k, p in enumerate(tseg.shard_cluster_plan(
            t.base, _pieces([0, n // 2, n]))):
        np.testing.assert_array_equal(p.ec_seg, _jax_group(j.base, k, 2)[2])
    dev = tseg.device_sharded_coarse_plan(t, _pieces([0, n // 2, n]),
                                          ["cpu"] * 2)
    assert dev.level_sizes == t.level_sizes and len(dev.base.shards) == 2


def test_uneven_shards_split_one_plan():
    s = _scene()
    ci, pi, mask = _stream(s)
    t = tseg.build_cluster_plan(ci, pi, 16, 120, 0, mask=mask)
    # Uneven contiguous shards, and shards that interleave the stream.
    for pieces in (_pieces([0, 5, 200, ci.shape[0]]),
                   [np.arange(k, ci.shape[0], 3)[::-1] for k in range(3)]):
        shards = tseg.shard_cluster_plan(t, pieces)
        edges = np.concatenate([pieces[k][p.ec_edge]
                                for k, p in enumerate(shards)])
        np.testing.assert_array_equal(np.sort(edges), np.sort(t.ec_edge))
        for pos, p in zip(pieces, shards):
            np.testing.assert_array_equal(p.pc_slot, t.pc_slot[pos])
            assert (np.diff(p.pc_slot[p.pc_order]) >= 0).all()
            assert (np.diff(p.ec_seg) >= 0).all()
        dev = tseg.device_sharded_coarse_plan(t, pieces, ["cpu"] * 3)
        assert dev.num_clusters == t.num_clusters and len(dev.shards) == 3


def test_flat_solve_stream_clusters_equal_jax_padded_stream():
    s = _scene()
    order = np.argsort(s.cam_idx, kind="stable")
    ci, pi = s.cam_idx[order], s.pt_idx[order]
    _, jci, jpi, jmask = j_pad_edges(s.obs[order], ci, pi, 2 * 2048)
    j = jseg.build_cluster_plan(jci, jpi, 16, 120, 0, mask=jmask,
                                world_size=2)
    t = tseg.build_cluster_plan(ci, pi, 16, 120, 0)
    np.testing.assert_array_equal(t.cluster, j.cluster)


# ---------------------------------------------------------------- flat_solve

_CASES = {
    "two_level": ("IMPLICIT", dict(precond=TWO), ()),
    "two_level_fixed": ("EXPLICIT", dict(precond=TWO), ("fixed",)),
    "multilevel_smoothed": ("EXPLICIT", dict(
        precond=MULTI, coarsen_factor=2.0, max_levels=4,
        smooth_omega=2 / 3), ()),
    "schur_diag": ("IMPLICIT", dict(
        preconditioner=mt.PreconditionerKind.SCHUR_DIAG), ()),
}


def _extras(extras):
    return {"cam_fixed": np.isin(np.arange(16), [0, 5])} if (
        "fixed" in extras) else {}


@functools.lru_cache(maxsize=None)
def _jax_result(name):
    kind, solver, extras = _CASES[name]
    jopt, _ = _options(False, kind=kind, **solver)
    return _jax_solve(_args(_scene()), dataclasses.replace(
        jopt, world_size=2), **_extras(extras))


def _port(name, ws, **mesh):
    kind, solver, extras = _CASES[name]
    _, topt = _options(False, kind=kind, **dict(solver, **mesh))
    return mt.flat_solve(None, *_args(_scene()), dataclasses.replace(
        topt, world_size=ws), device=["cpu"] * ws, **_extras(extras))


@pytest.mark.parametrize("name", list(_CASES))
def test_sharded_preconditioners_match_jax_world2(name):
    tres = _port(name, 2)
    t = compare_robust(_jax_result(name), tres)
    assert not t["trace"]["precond_fallback"].any()
    one = _port(name, 1)
    assert (tres.iterations, tres.pcg_iterations) == (one.iterations,
                                                      one.pcg_iterations)
    np.testing.assert_allclose(tres.trace.cost[:tres.iterations].numpy(),
                               one.trace.cost[:one.iterations].numpy(),
                               rtol=1e-9)


def test_two_level_on_the_2x2_mesh_matches_world1():
    tres = _port("two_level", 4, mesh_2d=True, cam_blocks=2)
    one = _port("two_level", 1)
    assert (tres.iterations, tres.accepted, tres.pcg_iterations) == (
        one.iterations, one.accepted, one.pcg_iterations)
    np.testing.assert_allclose(tres.trace.cost[:tres.iterations].numpy(),
                               one.trace.cost[:one.iterations].numpy(),
                               rtol=1e-9)
    assert torch.equal(tres.trace.precond_fallback, one.trace.precond_fallback)

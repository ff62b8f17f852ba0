"""The fused kernels' slot tiles (ops/fused.slot_tiles), and the plain
fused coupling applies on a heavy-tailed graph vs the JAX package.

- `slot_tiles` / `with_fused_plans`: every output segment is owned once,
  in order, by the tile whose slot range holds its first slot; empty
  segments by their offset, the trailing ones (offset n) by the last
  tile; every owned segment starts within the first kBlock slots of its
  tile's walk, and only the last can reach past them (what the CUDA
  kernel's chunk loop relies on);
- on `io.synthetic.heavy_tailed_graph` (Zipf track lengths, empty points
  at the start, middle and end, a point of exactly one tile and one
  spanning four), `fused_coupling_apply_plain` and
  `fused_coupling_apply_implicit_plain` against the JAX package's XLA
  oracle `reference_coupling_apply` and its Pallas kernels in interpret
  mode, in both directions, with few and with many cameras.

CPU only: the CUDA kernels run the same graph against the same plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megba_tpu.ops import fused as jfused

from megba_tpu_torch.io.synthetic import heavy_tailed_graph
from megba_tpu_torch.ops import fused as tfused
from megba_tpu_torch.ops import segtiles as tseg

KBLOCK = 256  # csrc/segreduce.cuh kBlock: the kernel's chunk of slots

# (cameras, points): few cameras (long camera segments, a block per
# camera) and many (short camera segments, slot tiles on both sides).
GRAPHS = {"few_cameras": (12, 300), "many_cameras": (900, 300)}


def retiled(fplan, tile):
    """The same direction with `tile` slots a tile."""
    return dataclasses.replace(
        fplan, tile_ptr=tfused.slot_tiles(fplan.out.seg_ptr, tile))


def _plans(graph, seed=0):
    nc, npt = GRAPHS[graph]
    cam_idx, pt_idx = heavy_tailed_graph(nc, npt, seed=seed)
    plan_c, plans = tseg.make_dual_plans(cam_idx, pt_idx, nc, npt, "cpu")
    return cam_idx, pt_idx, plan_c, tfused.with_fused_plans(plans)


def _check_ownership(seg_ptr: np.ndarray, tile_ptr: np.ndarray, tile: int):
    n, ns = int(seg_ptr[-1]), seg_ptr.shape[0] - 1
    num_tiles = max(1, -(-n // tile))
    assert tile_ptr.shape == (num_tiles + 1,)
    assert tile_ptr[0] == 0 and tile_ptr[-1] == ns
    assert np.all(np.diff(tile_ptr) >= 0)
    owner = np.repeat(np.arange(num_tiles), np.diff(tile_ptr))
    assert owner.shape == (ns,)  # each segment once, tiles in order
    want = np.minimum(seg_ptr[:-1] // tile, num_tiles - 1)
    np.testing.assert_array_equal(owner, want)
    for b in range(num_tiles):
        lo, hi = tile_ptr[b], tile_ptr[b + 1]
        if lo == hi:
            continue
        # The kernel walks [seg_ptr[lo], seg_ptr[hi]) in chunks of
        # KBLOCK from its first slot: every owned segment but the last
        # ends within the first chunk.
        assert np.all(seg_ptr[lo + 1:hi] <= seg_ptr[lo] + KBLOCK)


def test_heavy_tailed_graph_has_the_edge_cases():
    _, pt_idx = heavy_tailed_graph(12, 300)
    lengths = np.bincount(pt_idx, minlength=300)
    assert lengths[0] == lengths[149] == lengths[150] == lengths[151] == 0
    assert lengths[-1] == lengths[-2] == 0
    assert (lengths[1], lengths[2]) == (1, KBLOCK)
    assert lengths[3] > 3 * KBLOCK
    assert lengths.max() == lengths[3]
    with pytest.raises(ValueError, match="num_points"):
        heavy_tailed_graph(4, 9)


@pytest.mark.parametrize("tile", [1, 7, 32, 224, 256])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_slot_tiles_own_every_segment_once(graph, tile):
    *_, plans = _plans(graph)
    for planned in (plans.fused_to_pt, plans.fused_to_cam):
        fp = retiled(planned, tile)
        assert fp.tile_ptr.dtype == torch.int64
        assert fp.tile_ptr.is_contiguous()
        _check_ownership(fp.out.seg_ptr.numpy(), fp.tile_ptr.numpy(), tile)
        if tile == tfused.SLOT_TILE:
            assert torch.equal(fp.tile_ptr, planned.tile_ptr)


@pytest.mark.parametrize("seg_ptr,tile,want", [
    ([0], 256, [0, 0]),                    # no segment, no slot
    ([0, 0, 0], 256, [0, 2]),              # only empty segments
    ([0, 0, 512, 512], 256, [0, 2, 3]),    # trailing empty at offset n
    ([0, 0, 3, 3, 3, 260, 260, 513, 513], 256, [0, 5, 7, 8]),
    ([0, 5, 10], 4, [0, 1, 2, 2]),         # a tile with no segment start
])
def test_slot_tiles_rule_on_small_offsets(seg_ptr, tile, want):
    got = tfused.slot_tiles(torch.tensor(seg_ptr, dtype=torch.int64), tile)
    assert got.tolist() == want
    _check_ownership(np.array(seg_ptr), got.numpy(), tile)


def test_slot_tiles_refuse_a_tile_beyond_the_block():
    seg_ptr = torch.tensor([0, 3, 9], dtype=torch.int64)
    for tile in (0, tfused.SLOT_TILE + 1):
        with pytest.raises(ValueError, match="slot_tile"):
            tfused.slot_tiles(seg_ptr, tile)


def test_wrappers_refuse_a_plan_whose_tiles_disagree():
    *_, plans = _plans("few_cameras")
    fp = plans.fused_to_pt
    n = fp.out.n_slots
    W = torch.zeros(27, n, dtype=torch.float64)
    table = torch.zeros(9, fp.num_in, dtype=torch.float64)
    # Too few tiles for SLOT_TILE slots each, more tiles than slots, not
    # one-dimensional, not int64.
    assert n > 2 * tfused.SLOT_TILE
    for bad in (dict(tile_ptr=fp.tile_ptr[::2].contiguous()),
                dict(tile_ptr=torch.zeros(n + 2, dtype=torch.int64)),
                dict(tile_ptr=fp.tile_ptr[None]),
                dict(tile_ptr=fp.tile_ptr.int())):
        with pytest.raises(ValueError, match="tile_ptr"):
            tfused.fused_coupling_apply(
                W, table, dataclasses.replace(fp, **bad), True)


def _direction(graph, cam_to_pt, seed=0):
    """The port's plan of one direction on the heavy-tailed graph, the
    caller-order slot of each of its slots, and the edge lists as
    (in, out) with their vertex counts."""
    cam_idx, pt_idx, plan_c, plans = _plans(graph, seed=seed)
    nc, npt = GRAPHS[graph]
    if cam_to_pt:
        order = plan_c.perm[plans.pt.inv.numpy()]
        return plans.fused_to_pt, order, (cam_idx, pt_idx, nc, npt)
    return plans.fused_to_cam, plan_c.perm, (pt_idx, cam_idx, npt, nc)


def _jax_plan(in_idx, out_idx, ni, no):
    mask = np.ones(in_idx.shape[0], np.float32)
    return jfused.device_fused_plan(jfused.build_fused_plan(
        in_idx, out_idx, mask, ni, no, tile=32, in_block=16, out_block=32))


def _err(got, want):
    return np.max(np.abs(got - want)) / (1.0 + np.max(np.abs(want)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cam_to_pt", [True, False],
                         ids=["cam_to_pt", "pt_to_cam"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_plain_coupling_apply_matches_jax_on_heavy_tails(graph, cam_to_pt,
                                                         dtype):
    """Kernel 8's plain version, at test_torch_fused_implicit.py's
    tolerances (1e-5 at f32: a 785-slot track summed in another order
    differs from the JAX sums by up to 1.4e-6 of their scale, over
    test_torch_fused.py's 1e-6 for ~6-slot segments; 1e-12 at f64)."""
    fplan, order, (in_idx, out_idx, ni, no) = _direction(graph, cam_to_pt)
    rng = np.random.default_rng(3)
    d_in, d_out = (9, 3) if cam_to_pt else (3, 9)
    n = in_idx.shape[0]
    W = (0.1 * rng.standard_normal((27, n))).astype(dtype)
    table = rng.standard_normal((d_in, ni)).astype(dtype)
    got = tfused.fused_coupling_apply(
        torch.from_numpy(np.ascontiguousarray(W[:, order])),
        torch.from_numpy(table), fplan, cam_to_pt).numpy()
    assert got.dtype == dtype and got.shape == (d_out, no)
    jplan = _jax_plan(in_idx, out_idx, ni, no)
    jW, jt = jnp.asarray(W), jnp.asarray(table)
    kern = np.asarray(jfused.fused_coupling_apply(
        jfused.permute_rows(jW, jplan), jt, jplan, w_in_major=cam_to_pt,
        interpret=True))
    oracle = np.asarray(jfused.reference_coupling_apply(
        jW, jt, in_idx, out_idx, no, cam_to_pt, d_in))
    tol = 1e-5 if dtype == np.float32 else 1e-12
    for want in (kern, oracle):
        assert _err(got, want) < tol
    empty = np.bincount(out_idx, minlength=no) == 0
    assert empty.any() or not cam_to_pt
    assert np.all(got[:, empty] == 0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cam_to_pt", [True, False],
                         ids=["cam_to_pt", "pt_to_cam"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_plain_implicit_apply_matches_jax_on_heavy_tails(graph, cam_to_pt,
                                                         dtype):
    """Kernel 7's plain version, at test_torch_fused_implicit.py's
    tolerances; the XLA oracle takes W_e = Jin_e^T Jout_e, input-major."""
    fplan, order, (in_idx, out_idx, ni, no) = _direction(graph, cam_to_pt,
                                                         seed=1)
    rng = np.random.default_rng(4)
    d_in, d_out = (9, 3) if cam_to_pt else (3, 9)
    n = in_idx.shape[0]
    Jin = (0.3 * rng.standard_normal((2 * d_in, n))).astype(dtype)
    Jout = (0.3 * rng.standard_normal((2 * d_out, n))).astype(dtype)
    table = rng.standard_normal((d_in, ni)).astype(dtype)

    def rows(a):
        return torch.from_numpy(np.ascontiguousarray(a[:, order]))

    got = tfused.fused_coupling_apply_implicit(
        rows(Jin), rows(Jout), torch.from_numpy(table), fplan).numpy()
    assert got.dtype == dtype and got.shape == (d_out, no)
    jplan = _jax_plan(in_idx, out_idx, ni, no)
    kern = np.asarray(jfused.fused_coupling_apply_implicit(
        jfused.permute_rows(jnp.asarray(Jin), jplan),
        jfused.permute_rows(jnp.asarray(Jout), jplan), jnp.asarray(table),
        jplan, interpret=True))
    W = np.stack([sum(Jin[o * d_in + a] * Jout[o * d_out + b]
                      for o in range(2))
                  for a in range(d_in) for b in range(d_out)])
    oracle = np.asarray(jfused.reference_coupling_apply(
        jnp.asarray(W), jnp.asarray(table), in_idx, out_idx, no, True,
        d_in))
    tol = 1e-5 if dtype == np.float32 else 1e-12
    for want in (kern, oracle):
        assert _err(got, want) < tol

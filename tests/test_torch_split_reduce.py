"""The split-segment launch of kernels 1 and 3: its chunk table and plans.

Where a side's segments are long, `jtj_grad_reduce` and `coupling_reduce`
run one block per chunk (`csrc/segreduce.cuh`,
`reduce_split_segments`): a segment of up to `SPLIT_ABOVE` slots is one
chunk, a longer one is cut into chunks of at most `SPLIT_CHUNK`.  The
chunks are planned on the host (`ops/segtiles.split_chunks`), once per
plan; these tests hold the table to what the kernel relies on: every
slot in exactly one chunk, no chunk across a segment boundary, chunks in
ascending order and of those lengths, a segment's boundaries (relative
to its start) a function of its length alone, an empty segment listed
for its zero row.  CPU only: the kernel itself is held to its plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).  Also the plain versions
of kernels 1 and 3 on the pose prior's one-segment point side, (od, d) =
(6, 3), against the JAX package at float64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megba_tpu.core import fm as jfm
from megba_tpu.ops import segtiles as jseg

from megba_tpu_torch.io.synthetic import heavy_tailed_graph, long_camera_idx
from megba_tpu_torch.ops import fused as tfused
from megba_tpu_torch.ops import segtiles as tseg

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

C = tseg.SPLIT_CHUNK
A = tseg.SPLIT_ABOVE


def _offsets(lengths):
    return np.concatenate([[0], np.cumsum(np.asarray(lengths, np.int64))])


def _zipf_track_lengths():
    _, pt_idx = heavy_tailed_graph(1778, 20_000, seed=0)
    return np.bincount(pt_idx, minlength=20_000)


def _long_camera_lengths():
    return np.bincount(long_camera_idx(64), minlength=64)


LENGTHS = {
    "one_segment_200000": [200_000],
    "edge_lengths": [0, 1, C - 1, C, C + 1, A, A + 1, 7 * C + 3],
    "edge_lengths_shuffled": [7 * C + 3, 0, A + 1, C + 1, 1, 0, C, A,
                              C - 1, 0],
    "zipf_tracks": _zipf_track_lengths,  # heavy_tailed_graph's points
    "long_cameras": _long_camera_lengths,  # 5,000 to 40,000 slots each
    "no_slots": [0, 0, 0],
    "no_segments": [],
}


def _lengths(case):
    lengths = LENGTHS[case]
    return lengths() if callable(lengths) else lengths


@pytest.mark.parametrize("case", list(LENGTHS))
def test_chunk_table_partitions_each_segment(case):
    lengths = np.asarray(_lengths(case), np.int64)
    seg_ptr = _offsets(lengths)
    ns, n = lengths.shape[0], int(seg_ptr[-1])
    chunk_ptr, chunk_seg, seg_chunk = tseg.split_chunks(seg_ptr)
    nc = chunk_seg.shape[0]
    assert chunk_ptr.shape == (nc + 1,) and seg_chunk.shape == (ns + 1,)
    # Ascending chunks that tile the stream: each slot in exactly one.
    assert chunk_ptr[0] == 0 and chunk_ptr[-1] == n
    assert np.all(np.diff(chunk_ptr) >= 0)
    assert np.all(np.diff(chunk_seg) >= 0)
    owner = np.repeat(np.arange(nc), np.diff(chunk_ptr))
    assert owner.shape == (n,)
    # No chunk crosses a segment boundary; a segment of up to A slots is
    # one chunk, a longer one's chunks are at most C slots long.
    assert np.all(seg_ptr[chunk_seg] <= chunk_ptr[:-1])
    assert np.all(chunk_ptr[1:] <= seg_ptr[chunk_seg + 1])
    sizes = np.diff(chunk_ptr)
    assert np.all(sizes <= np.where(lengths[chunk_seg] > A, C, A))
    slot_seg = np.repeat(np.arange(ns), lengths)
    assert np.array_equal(chunk_seg[owner], slot_seg)
    # seg_chunk lists each segment's chunks; every segment has at least
    # one (an empty segment an empty one, for its zero row).
    per_seg = np.diff(seg_chunk)
    assert np.array_equal(per_seg, np.where(lengths > A, -(-lengths // C),
                                            1))
    assert np.array_equal(chunk_seg, np.repeat(np.arange(ns), per_seg))
    empty = np.nonzero(lengths == 0)[0]
    assert np.all(np.diff(chunk_ptr)[seg_chunk[empty]] == 0)
    # A segment's boundaries, relative to its start, depend on its
    # length alone: the same as the segment's table on its own.
    for s in range(ns):
        rel = chunk_ptr[seg_chunk[s]:seg_chunk[s + 1] + 1] - seg_ptr[s]
        alone, _, _ = tseg.split_chunks(np.array([0, lengths[s]]))
        assert np.array_equal(rel, alone)
        sizes = np.diff(rel)
        assert sizes.size == 0 or sizes.max() - sizes.min() <= 1


def test_chunk_boundaries_do_not_depend_on_the_offset():
    """A segment of 7C + 3 slots is cut at the same places after an
    empty segment, after one of 5 slots, and between long ones."""
    L = 7 * C + 3
    cuts = set()
    for before in ([], [0], [5], [C + 1, 3 * C]):
        seg_ptr = _offsets(before + [L, 2])
        chunk_ptr, _, seg_chunk = tseg.split_chunks(seg_ptr)
        s = len(before)
        rel = chunk_ptr[seg_chunk[s]:seg_chunk[s + 1] + 1] - seg_ptr[s]
        cuts.add(tuple(rel.tolist()))
    assert len(cuts) == 1
    (rel,) = cuts
    assert len(rel) == 9 and rel[0] == 0 and rel[-1] == L


def test_split_table_packs_the_table_the_kernel_reads():
    """One int64 array, chunk_ptr | chunk_seg | seg_chunk (the order of
    segreduce.cuh's split_table), zero counters, one per segment."""
    seg_ptr = _offsets([3000, 0, 1, 2 * A + 1])
    t = tseg.split_table(seg_ptr, "cpu")
    chunk_ptr, chunk_seg, seg_chunk = tseg.split_chunks(seg_ptr)
    nc = t.num_chunks
    longest = -(-(2 * A + 1) // C)  # the last segment's chunks
    assert nc == chunk_seg.shape[0] == 1 + 1 + 1 + longest
    table = t.table.numpy()
    assert t.table.dtype == torch.int64 and t.table.is_contiguous()
    assert np.array_equal(table[:nc + 1], chunk_ptr)
    assert np.array_equal(table[nc + 1:2 * nc + 1], chunk_seg)
    assert np.array_equal(table[2 * nc + 1:], seg_chunk)
    assert t.counters.dtype == torch.int32
    assert t.counters.shape == (4,) and not t.counters.any()
    assert t.longest == longest


def test_plans_carry_a_chunk_table_where_segments_are_long():
    """make_dual_plans gives the long side (cameras) its table and the
    short side (points) one without chunks (none of its segments is over
    SPLIT_ABOVE slots; kernel 4's slot tiles sum them); the pose prior's
    one-segment point side and a ring-step bucket plan of long cameras
    get theirs too."""
    rng = np.random.default_rng(0)
    n = 20_000
    cam_idx = rng.integers(0, 6, n).astype(np.int32)
    pt_idx = rng.integers(0, 4000, n).astype(np.int32)
    _, plans = tseg.make_dual_plans(cam_idx, pt_idx, 6, 4000, "cpu")
    assert plans.pt.per_thread and plans.pt.split.num_chunks == 0
    assert plans.pt.tiles is not None and plans.cam.tiles is None
    assert not plans.cam.per_thread
    split = plans.cam.split
    counts = np.bincount(cam_idx, minlength=6)
    assert counts.max() <= A and split.num_chunks == 6  # a chunk a camera
    assert split.longest == 1
    assert np.array_equal(split.table[:split.num_chunks + 1].numpy(),
                          tseg.split_chunks(plans.cam.seg_ptr.numpy())[0])
    # The pose prior's point side: 200,000 slots on one dummy point.
    _, prior = tseg.make_dual_plans(
        np.arange(200_000, dtype=np.int32) // 2,
        np.zeros(200_000, np.int32), 100_000, 1, "cpu")
    chunks = -(-200_000 // C)  # 98 chunks of ~2041 slots
    assert prior.pt.split.num_chunks == chunks
    assert prior.pt.split.longest == chunks
    assert prior.cam.per_thread and prior.cam.split.num_chunks == 0
    # A ring step's output side (cameras of a tile) of long segments.
    ring = tfused.ring_step_plan(rng.integers(0, 50, 5000),
                                 np.sort(rng.integers(0, 3, 5000)),
                                 np.arange(5000), 50, 3, "cpu")
    assert ring.out.split is not None and not ring.out.per_thread
    short = tfused.ring_step_plan(np.zeros(10, np.int64), np.arange(10),
                                  np.arange(10), 1, 10, "cpu")
    assert short.out.per_thread and short.out.split.num_chunks == 0


def test_split_arguments_of_the_launchers():
    """What kernel 1 or 3's wrapper hands its C launcher: nothing on a
    per-thread side; the table, the counters, the chunk count and the
    plan's workspace of `width` values a chunk on a long side; a typed
    refusal for a long side without its table."""
    rng = np.random.default_rng(1)
    cam_idx = rng.integers(0, 3, 9000).astype(np.int32)
    pt_idx = rng.integers(0, 2000, 9000).astype(np.int32)
    _, plans = tseg.make_dual_plans(cam_idx, pt_idx, 3, 2000, "cpu")
    assert plans.cam.split.num_chunks == 3  # a chunk a camera
    dev = torch.device("cpu")
    args = tseg._split_args("coupling_reduce", plans.pt, 3, torch.float64,
                            dev)
    assert args == (None, None, 0, None)
    args = tseg._split_args("jtj_grad_reduce", plans.cam, 54, torch.float32,
                            dev)
    split = plans.cam.split
    work = split.workspace(54, torch.float32)
    assert args == (split.table.data_ptr(), split.counters.data_ptr(),
                    split.num_chunks, work.data_ptr())
    assert work.dtype == torch.float32 and work.numel() == 54 * 3
    # One workspace per width and dtype, reused by every launch.
    again = tseg._split_args("jtj_grad_reduce", plans.cam, 54,
                             torch.float32, dev)
    assert again == args
    assert split.workspace(9, torch.float32).numel() == 9 * 3
    assert split.workspace(54, torch.float64).data_ptr() != work.data_ptr()
    bare = tseg.SegPlan(seg=plans.cam.seg, seg_ptr=plans.cam.seg_ptr,
                        num_segments=3, inv=plans.cam.inv)
    with pytest.raises(ValueError, match="chunk table"):
        tseg._split_args("coupling_reduce", bare, 9, torch.float64, dev)


def test_one_segment_6x3_plain_versions_match_jax_f64():
    """The pose prior's point side at (od, d) = (6, 3), one segment of
    20,000 slots: kernel 1's plain version against the JAX package's
    float64 lowering, kernel 3's against its gather / segment-sum
    composition (the Pallas coupling kernels compute in float32 only),
    as test_torch_segtiles.py holds the other shapes; rtol 1e-12."""
    od, d, n = 6, 3, 20_000
    idx = np.zeros(n, np.int32)
    jplan = jseg.build_tile_plan(idx, 1, 64, 16)
    jdp = jseg.device_plan(jplan)
    hplan = tseg.build_seg_plan(idx, 1)
    tplan = tseg.device_plan(hplan, np.zeros_like(hplan.perm), "cpu")
    assert not tplan.per_thread and tplan.split.num_chunks == -(-n // C)
    rng = np.random.default_rng(6)
    J = 0.1 * rng.standard_normal((od * d, n))
    u = rng.standard_normal((od, n))

    def jax_slots(a):
        return jnp.asarray(a[:, jplan.perm] * jplan.mask)

    def port_slots(a):
        return torch.from_numpy(np.ascontiguousarray(a[:, hplan.perm]))

    jh, jg = jseg.jtj_grad_reduce(jax_slots(J), jax_slots(u), jdp,
                                  use_kernels=False)
    th, tg = tseg.jtj_grad_reduce_plain(port_slots(J), port_slots(u), tplan)
    te = jnp.stack([sum(jnp.asarray(J[o * d + b] * u[o]) for o in range(od))
                    for b in range(d)])
    jred = jfm.segsum_fm(te, jnp.asarray(idx), 1)
    tred = tseg.coupling_reduce_plain(port_slots(J), port_slots(u), tplan, d)
    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **tol)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **tol)
    np.testing.assert_allclose(tred.numpy(), np.asarray(jred), **tol)

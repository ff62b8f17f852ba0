"""Kernel 4 (`seg_reduce`): the tables its launch reads and a numpy model
of the order in which it sums each segment.

The CUDA kernel (csrc/segsum.cu, `seg_reduce_tiles`, and
csrc/segreduce.cuh) runs split chunks on a side of long segments, a
thread per segment on a side of short ones all under 256 slots, and slot
tiles on any other side of short ones.  `schedule` below walks a plan's tables the
way the kernel's blocks do and returns, per segment, how it is summed:

- ("seq", L): one thread adds its L < 256 slots from 0 in ascending
  order (a tile's owner, from the staged values; the rest of one that
  runs past its window by thread 0 in the next, from the partial sums
  carried over);
- ("block", L): the whole block, thread t adding slots t, t + 256, ...
  in order, a warp-shuffle tree and the warps' partials in order
  (`block_segment_sum`; a chunk of a split segment the same way);
- ("chunks", boundaries): the split chunks, each summed as a block, their
  sums added in chunk order;

and, per block, how many slots it reads and, per thread, how many it
adds.  `evaluate` forms the sums in exactly that order in the data's
dtype, so on the card the kernel is bitwise the model
(tests/test_torch_cuda.py).  Here, on the CPU, the model shows on
hypothesis-drawn offsets that a segment's order depends on its length
(and the side's shape) alone, that no block or thread owns more than
`SEG_REDUCE_BOUNDS`, that `seg_reduce_shape` reports what the walk
finds, and that its sums agree with `seg_reduce_plain`; and the tables
of every plan constructor kernel 4 reads, the fleet union's per lane
among them.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from megba_tpu_torch.ops import fused as tfused
from megba_tpu_torch.ops import segtiles as tseg

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

KBLOCK = 256  # csrc/segreduce.cuh kBlock
WARPS = KBLOCK // 32
WINDOWS = 8  # csrc/segsum.cu kSegWindows: tiles a block walks
STEP_BYTES = 40960  # kStepBytes: shared memory a step stages


def step_tiles(width, itemsize):
    """Tiles the kernel stages a step at F = `width` values of `itemsize`
    bytes a slot and an 8-byte offset (csrc/segsum.cu `step_tiles`)."""
    return max(1, min(WINDOWS,
                      STEP_BYTES // ((width * itemsize + 8) * KBLOCK)))
A = tseg.SPLIT_ABOVE


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _tables(plan):
    seg_ptr = plan.seg_ptr.cpu().numpy()
    table = plan.split.table.cpu().numpy()
    nc = plan.split.num_chunks
    chunk_ptr, chunk_seg = table[:nc + 1], table[nc + 1:2 * nc + 1]
    seg_chunk = table[2 * nc + 1:]
    tiles = None if plan.tiles is None else plan.tiles.cpu().numpy()
    return seg_ptr, chunk_ptr, chunk_seg, seg_chunk, tiles


def schedule(plan, step=8):
    """({segment: how the kernel sums it}, slots read per block, slots
    added per thread for one segment), from the plan's tables as the
    kernel's blocks read them: a block of the thread per segment reads
    its 256 segments, a thread each; a block of slot tiles walks WINDOWS tiles
    of 256 slots `step` at a time, staging each tile that owns a segment
    or follows one that does (up to a carried rest's end, in a step that
    owns none); a short segment that runs past its step is carried into
    the next (past the block's last tile, into a step of its own).  Every
    segment must be summed exactly once, and every slot of a short one
    must be staged when its owner adds it."""
    seg_ptr, chunk_ptr, chunk_seg, seg_chunk, tiles = _tables(plan)
    ns, n = seg_ptr.shape[0] - 1, int(seg_ptr[-1])
    how, block_slots, thread_slots = {}, [], []

    def put(s, desc):
        assert s not in how, f"segment {s} summed twice"
        how[s] = desc

    if plan.per_thread and plan.all_short:
        lens = np.diff(seg_ptr)
        for s in range(ns):
            put(s, ("seq", int(lens[s])))
        block_slots = [int(lens[k:k + KBLOCK].sum())
                       for k in range(0, ns, KBLOCK)]
        thread_slots = [int(v) for v in lens]
    elif plan.per_thread:
        num_tiles = tiles.shape[0] - 1
        for w0 in range(0, num_tiles, WINDOWS):
            nw = min(WINDOWS, num_tiles - w0)
            tp = [int(t) for t in tiles[w0:w0 + nw + 1]]
            if tp[0] == tp[nw]:
                continue

            def owns(k):
                return 0 <= k < nw and tp[k] < tp[k + 1]

            read, carry, j0 = 0, None, 0
            while j0 < nw or carry is not None:
                ja, jb = min(j0, nw), min(j0 + step, nw)
                j0 += step
                s_lo, s_hi = tp[ja], tp[jb]
                if s_lo == s_hi and carry is None:
                    continue
                lo = (w0 + ja) * KBLOCK
                end = min((w0 + jb) * KBLOCK, n)
                hi = end if s_lo < s_hi else int(seg_ptr[carry + 1])
                staged = set()
                for k in range(step):
                    t0 = lo + k * KBLOCK
                    if t0 < hi and (owns(ja + k) or (ja + k > 0
                                                     and owns(ja + k - 1))):
                        staged.update(range(t0, min(t0 + KBLOCK, hi)))
                read += len(staged)
                if carry is not None:  # its rest lies in this step
                    rest = range(lo, int(seg_ptr[carry + 1]))
                    assert staged.issuperset(rest)
                carry = None
                for s in range(s_lo, s_hi):
                    a, z = int(seg_ptr[s]), int(seg_ptr[s + 1])
                    # It starts in a tile of the step (the last tile also
                    # owns the trailing empty segments at the stream's
                    # end).
                    assert lo <= a < end or a == z == n
                    if z - a >= KBLOCK:  # a tile's last: the block's
                        if seg_chunk[s + 1] == seg_chunk[s]:
                            put(s, ("block", z - a))
                            read += z - a
                            thread_slots.append(-(-(z - a) // KBLOCK))
                        continue
                    put(s, ("seq", z - a))
                    thread_slots.append(z - a)
                    assert staged.issuperset(range(a, min(z, hi)))
                    if z > hi:
                        assert s == s_hi - 1 and z - hi < KBLOCK
                        carry = s
            block_slots.append(read)
    for s in range(ns):
        c0, c1 = seg_chunk[s], seg_chunk[s + 1]
        if c1 == c0:
            continue
        assert np.all(chunk_seg[c0:c1] == s)
        # A segment's last chunk ends at the segment's end (the listed
        # chunks of a short side have gaps between segments).
        bounds = np.append(chunk_ptr[c0:c1], seg_ptr[s + 1])
        rel = tuple(int(v) for v in bounds - seg_ptr[s])
        sizes = np.diff(rel)
        block_slots.extend(int(v) for v in sizes)
        thread_slots.extend(int(-(-v // KBLOCK)) for v in sizes)
        L = int(seg_ptr[s + 1] - seg_ptr[s])
        put(s, ("block", L) if c1 - c0 == 1 else ("chunks", rel))
    assert sorted(how) == list(range(ns)), "a segment is never summed"
    return how, max(block_slots, default=0), max(thread_slots, default=0)


def expected(L, per_thread):
    """The order a segment of L slots is summed in: its length and the
    side's shape alone."""
    if per_thread and L < KBLOCK:
        return ("seq", L)
    if L <= A:
        return ("block", L)
    m = -(-L // tseg.SPLIT_CHUNK)
    return ("chunks", tuple(k * L // m for k in range(m + 1)))


def _block_sum(x):
    """[F, L] -> [F]: block_segment_sum's order in x's dtype."""
    F, L = x.shape
    acc = np.zeros((F, KBLOCK), x.dtype)
    for k in range(-(-L // KBLOCK)):
        idx = k * KBLOCK + np.arange(KBLOCK)
        valid = idx < L
        acc[:, valid] = acc[:, valid] + x[:, idx[valid]]
    vals = acc.reshape(F, WARPS, 32)
    for off in (16, 8, 4, 2, 1):  # __shfl_down_sync: lane i takes i + off
        new = vals.copy()
        new[..., :32 - off] = vals[..., :32 - off] + vals[..., off:]
        vals = new
    v = vals[..., 0, 0].copy()
    for w in range(1, WARPS):
        v = v + vals[..., w, 0]
    return v


def evaluate(desc, x):
    """The sums [F] of one segment's slots x [F, L] in the order `desc`."""
    kind = desc[0]
    if kind == "seq":
        acc = np.zeros(x.shape[0], x.dtype)
        for i in range(x.shape[1]):
            acc = acc + x[:, i]
        return acc
    if kind == "block":
        return _block_sum(x)
    rel = desc[1]
    v = _block_sum(x[:, rel[0]:rel[1]])
    for a, b in zip(rel[1:-1], rel[2:]):
        v = v + _block_sum(x[:, a:b])
    return v


def model_sums(data, plan):
    """[F, nS] sums of data [F, n] (numpy) in the kernel's order (the
    ("seq", L) segments all at once, slot k of each added at step k)."""
    how, _, _ = schedule(plan)
    seg_ptr = plan.seg_ptr.cpu().numpy()
    out = np.zeros((data.shape[0], seg_ptr.shape[0] - 1), data.dtype)
    seq = np.array([s for s, desc in how.items() if desc[0] == "seq"],
                   np.int64)
    starts, lens = seg_ptr[seq], np.diff(seg_ptr)[seq]
    acc = np.zeros((data.shape[0], seq.shape[0]), data.dtype)
    for k in range(int(lens.max(initial=0))):
        m = lens > k
        acc[:, m] = acc[:, m] + data[:, starts[m] + k]
    out[:, seq] = acc
    for s, desc in how.items():
        if desc[0] != "seq":
            out[:, s] = evaluate(desc, data[:, seg_ptr[s]:seg_ptr[s + 1]])
    return out


def plan_of(lengths, device="cpu"):
    """A device plan of consecutive segments of `lengths` slots."""
    lengths = np.asarray(lengths, np.int64)
    idx = np.repeat(np.arange(lengths.shape[0]), lengths).astype(np.int32)
    hplan = tseg.build_seg_plan(idx, lengths.shape[0])
    return tseg.device_plan(hplan, np.zeros_like(hplan.perm), device)


# ---------------------------------------------------------------------------
# The launch on drawn offsets
# ---------------------------------------------------------------------------

_LENGTH = st.one_of(st.integers(0, 8), st.integers(0, 8),
                    st.integers(250, 262), st.integers(A - 4, A + 4),
                    st.integers(A + 5, 3 * A))


def _check_launch(lengths, dtype=np.float32, seed=0, step=None):
    """Kernel 4's launch on a plan of `lengths`, modelled with `step`
    tiles a step (by default the kernel's at F = 3 in `dtype`)."""
    plan = plan_of(lengths)
    if step is None:
        step = step_tiles(3, np.dtype(dtype).itemsize)
    how, block, thread = schedule(plan, step)
    per_thread = plan.per_thread
    lens = np.diff(plan.seg_ptr.numpy())
    for s, desc in how.items():
        assert desc == expected(int(lens[s]), per_thread), (s, desc)
    shape = tseg.seg_reduce_shape(plan)
    assert shape["shape"] == (
        "split chunks" if not per_thread else "thread per segment"
        if lens.max(initial=0) < KBLOCK else "slot tiles")
    bounds = tseg.SEG_REDUCE_BOUNDS[shape["shape"]]
    assert block <= bounds["block_slots"] and thread <= bounds["thread_slots"]
    # The plan side counts whole tiles where the kernel stages less at
    # the stream's end.
    assert block <= shape["block_slots"] <= bounds["block_slots"]
    assert shape["thread_slots"] == thread
    assert shape["chunks"] == plan.split.num_chunks
    data = np.random.default_rng(seed).standard_normal(
        (3, plan.n_slots)).astype(dtype)
    got = model_sums(data, plan)
    d64 = torch.from_numpy(data.astype(np.float64))
    ref = tseg.seg_reduce_plain(d64, plan).numpy()
    scale = tseg.seg_reduce_plain(d64.abs(), plan).numpy()
    rel = 1e-5 if dtype == np.float32 else 1e-12
    assert np.all(np.abs(got - ref) <= rel * scale)
    assert not got[:, lens == 0].any()
    return plan


@settings(max_examples=40, deadline=None)
@given(st.lists(_LENGTH, min_size=1, max_size=24),
       st.lists(st.integers(0, 8), min_size=0, max_size=3000),
       st.integers(0, 2 ** 16), st.sampled_from([1, 2, 3, 5, 8]))
def test_short_side_order_depends_on_the_length_alone(long_ones, fill, at,
                                                      step):
    """A side of short segments (drawn short fill, the drawn lengths
    spliced in at drawn places: offsets of any residue mod 256), staged
    `step` tiles at a time (the kernel's steps at the widths and dtypes
    it is built for)."""
    # Enough short ones for a short side (mean under 64 slots).
    fill = list(fill) + [3] * max(400, sum(long_ones) // 16)
    rng = np.random.default_rng(at)
    for L in long_ones:
        fill.insert(int(rng.integers(0, len(fill) + 1)), L)
    plan = _check_launch(fill, seed=at, step=step)
    assert plan.per_thread


@settings(max_examples=25, deadline=None)
@given(st.lists(_LENGTH, min_size=1, max_size=12),
       st.lists(st.integers(0, 300), min_size=0, max_size=6))
def test_long_side_order_depends_on_the_length_alone(long_ones, short):
    """A side of long segments (a 9,000-slot segment first keeps the mean
    above the short-side cut), short segments among them."""
    plan = _check_launch([9000] + list(long_ones) + list(short))
    assert not plan.per_thread


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("side", ["short", "long"])
def test_launch_on_edge_lengths(side, dtype):
    """Segments of 0, 1, 255, 256, 257, 4096, 4097 and 10,000 slots, on a
    short side (among 20,000 short segments) and a long one."""
    edge = [0, 1, 255, 256, 257, A, A + 1, 10_000]
    if side == "short":
        rng = np.random.default_rng(5)
        fill = rng.integers(0, 8, 20_000)
        fill[np.sort(rng.choice(fill.shape[0], len(edge), replace=False))] = (
            edge)
        edge = fill
    plan = _check_launch(edge, dtype)
    assert plan.per_thread == (side == "short")


def test_one_segment_of_200000_slots_is_split():
    """The pose prior's point side: 98 chunks, none over SPLIT_CHUNK."""
    plan = _check_launch([200_000])
    assert plan.split.num_chunks == -(-200_000 // tseg.SPLIT_CHUNK)
    assert tseg.seg_reduce_shape(plan)["block_slots"] <= tseg.SPLIT_CHUNK


@pytest.mark.parametrize("longest", [255, 256])
def test_short_segments_sum_in_slot_order(longest):
    """Under 256 slots on a short side the order is the thread-per-segment
    one: from 0, ascending, bitwise a sequential sum, whether every
    segment is under 256 slots (the thread per segment) or one is not
    (slot tiles)."""
    plan = plan_of([0, 1, 7, 255, 3, 200, 0, 5] * 50 + [longest])
    assert tseg.seg_reduce_shape_of(plan) == (
        "thread per segment" if longest < KBLOCK else "slot tiles")
    data = np.random.default_rng(1).standard_normal(
        (4, plan.n_slots)).astype(np.float32)
    got = model_sums(data, plan)
    seg_ptr = plan.seg_ptr.numpy()
    for s in range(seg_ptr.shape[0] - 2):
        acc = np.zeros(4, np.float32)
        for e in range(seg_ptr[s], seg_ptr[s + 1]):
            acc = acc + data[:, e]
        np.testing.assert_array_equal(got[:, s], acc)


# ---------------------------------------------------------------------------
# The tables every plan constructor gives kernel 4
# ---------------------------------------------------------------------------


def _check_tables(plan, what):
    """A short side's slot tiles and long-only chunks, or a long side's
    full chunk table, as kernel 4's wrapper reads them."""
    seg_ptr = plan.seg_ptr.cpu().numpy()
    assert plan.split is not None, what
    want = tseg.split_chunks(seg_ptr, long_only=plan.per_thread)
    nc = plan.split.num_chunks
    table = plan.split.table.cpu().numpy()
    assert np.array_equal(table, np.concatenate(want)), what
    assert nc == want[1].shape[0], what
    if plan.per_thread:
        assert plan.tiles is not None, what
        assert torch.equal(plan.tiles.cpu(),
                           tseg.slot_tiles(plan.seg_ptr.cpu())), what
    else:
        assert plan.tiles is None, what
    assert plan.tiles is None or plan.tiles.device == plan.seg_ptr.device
    assert plan.split.table.device == plan.seg_ptr.device
    assert plan.all_short == bool(
        plan.per_thread and np.diff(seg_ptr).max(initial=0) < KBLOCK), what
    shape = tseg.seg_reduce_shape(plan)
    bounds = tseg.SEG_REDUCE_BOUNDS[shape["shape"]]
    assert shape["block_slots"] <= bounds["block_slots"], what
    assert shape["thread_slots"] <= bounds["thread_slots"], what


def _scene(seed=0, nc=30, npt=900, n=6000):
    rng = np.random.default_rng(seed)
    cam_idx = rng.integers(0, nc, n)
    pt_idx = rng.integers(0, npt, n)
    pt_idx[:5000] = 7  # one point over SPLIT_ABOVE on a short side
    return cam_idx, pt_idx, nc, npt


def test_every_plan_constructor_carries_the_tables():
    """device_plan (both sides: SCHUR_DIAG's camera sums read the camera
    plan), the shard plans, the coarse plans' incidence plan and
    edge-incidence chunks (TWO_LEVEL and MULTILEVEL), the fused and
    ring-step output plans."""
    cam_idx, pt_idx, nc, npt = _scene()
    _, plans = tseg.make_dual_plans(cam_idx, pt_idx, nc, npt, "cpu")
    _check_tables(plans.cam, "cam")
    _check_tables(plans.pt, "pt")
    assert plans.pt.per_thread and plans.pt.split.num_chunks == 3
    fplans = tfused.with_fused_plans(plans)
    for fp in (fplans.fused_to_pt, fplans.fused_to_cam):
        _check_tables(fp.out, "fused")
        if fp.out.per_thread:
            assert fp.tile_ptr is fp.out.tiles
    _, shards = tseg.make_sharded_dual_plans(cam_idx, pt_idx, nc, npt,
                                             ["cpu"] * 3)
    for k, sp in enumerate(shards):
        _check_tables(sp.cam, f"shard {k} cam")
        _check_tables(sp.pt, f"shard {k} pt")
    cplan = tseg.build_cluster_plan(cam_idx, pt_idx, nc, npt, target=4)
    dcp = tseg.device_cluster_plan(cplan, "cpu")
    _check_tables(dcp.pc, "coarse pc")
    for p0, p1, s0, ec in dcp.ec_chunks:
        _check_tables(ec, "coarse ec chunk")
    ml = tseg.device_multilevel_plan(
        tseg.build_multilevel_plan(cam_idx, pt_idx, nc, npt, target=4),
        "cpu")
    _check_tables(ml.base.pc, "multilevel pc")
    sharded = tseg.device_sharded_coarse_plan(
        cplan, [np.arange(0, 3000), np.arange(3000, 6000)], ["cpu"] * 2)
    for k, sh in enumerate(sharded.shards):
        _check_tables(sh.pc, f"sharded coarse pc {k}")
        for _, _, _, ec in sh.ec_chunks:
            _check_tables(ec, f"sharded coarse ec {k}")
    rng = np.random.default_rng(3)
    for n_out in (3, 400):  # long cameras of a tile, and short ones
        ring = tfused.ring_step_plan(rng.integers(0, 50, 5000),
                                     np.sort(rng.integers(0, n_out, 5000)),
                                     np.arange(5000), 50, n_out, "cpu")
        _check_tables(ring.out, f"ring {n_out}")


def test_seg_reduce_refuses_a_plan_without_its_tables():
    """On a CUDA operand the wrapper names the missing table before any
    launch; nothing falls back.  (Checked through the argument builders,
    which run before the library is loaded.)"""
    plans = tseg.make_dual_plans(*_scene()[:2], 30, 900, "cpu")[1]
    dev = torch.device("cpu")
    bare = tseg.SegPlan(seg=plans.pt.seg, seg_ptr=plans.pt.seg_ptr,
                        num_segments=plans.pt.num_segments,
                        inv=plans.pt.inv)
    with pytest.raises(ValueError, match="slot tiles"):
        tseg._tile_args("seg_reduce", bare, dev)
    with pytest.raises(ValueError, match="chunk table"):
        tseg._chunk_args("seg_reduce", bare, 3, torch.float32, dev)
    wrong = tseg.SegPlan(seg=plans.pt.seg, seg_ptr=plans.pt.seg_ptr,
                         num_segments=plans.pt.num_segments,
                         inv=plans.pt.inv, split=plans.pt.split,
                         tiles=plans.pt.tiles[:-1])
    with pytest.raises(ValueError, match="plan.tiles"):
        tseg._tile_args("seg_reduce", wrong, dev)
    assert tseg._tile_args("seg_reduce", plans.cam, dev) == (None, 0)
    ptr, count = tseg._tile_args("seg_reduce", plans.pt, dev)
    assert ptr == plans.pt.tiles.data_ptr()
    assert count == plans.pt.tiles.shape[0] - 1
    # The plain version needs no table.
    data = torch.ones(2, plans.pt.n_slots)
    assert torch.equal(tseg.seg_reduce(data, bare),
                       tseg.seg_reduce_plain(data, plans.pt))


def test_fleet_union_tables_are_each_lanes_own():
    """On a make_fleet bucket's union (its lanes stacked as lane_lm_solve
    stacks them) every lane's slot tiles and chunks are that lane alone's,
    shifted by its offset: no tile or chunk straddles two lanes (but for
    the owner of a lane's trailing empty segments), and each lane's sums
    are bitwise its own."""
    from megba_tpu_torch import FleetProblem
    from megba_tpu_torch.io.synthetic import make_fleet
    from megba_tpu_torch.serving import BucketLadder, classify, pad_to_class

    probs = [FleetProblem.from_synthetic(s) for s in
             make_fleet(24, size_range=(128, 512), seed=0)]
    groups = {}
    for p in probs:
        groups.setdefault(classify(*p.dims(), np.float64, BucketLadder()),
                          []).append(p)
    shape, members = max(groups.items(), key=lambda kv: len(kv[1]))
    members = members[:4]
    padded = [pad_to_class(p.cameras, p.points, p.obs, p.cam_idx, p.pt_idx,
                           shape) for p in members]
    assert len(padded) >= 2 and shape.n_edge % tseg.SLOT_TILE == 0

    def union(lanes):
        ci = np.concatenate([pp.cam_idx + k * shape.n_cam
                             for k, pp in enumerate(lanes)])
        pi = np.concatenate([pp.pt_idx + k * shape.n_pt
                             for k, pp in enumerate(lanes)])
        return tseg.make_dual_plans(ci, pi, len(lanes) * shape.n_cam,
                                    len(lanes) * shape.n_pt, "cpu")[1]

    whole = union(padded)
    for side, n_seg in (("cam", shape.n_cam), ("pt", shape.n_pt)):
        u = getattr(whole, side)
        tiles_per_lane = shape.n_edge // tseg.SLOT_TILE
        u_tab = tseg.split_chunks(u.seg_ptr.numpy(), u.per_thread)
        u_ends = tseg.chunk_ends(u.seg_ptr.numpy(), *u_tab)
        for k, lane in enumerate(padded):
            alone = getattr(union([lane]), side)
            assert alone.per_thread == u.per_thread
            if u.per_thread:
                # The tiles inside a lane own what they own alone; at a
                # lane boundary, the lane before's trailing empty segments
                # (offset n_edge) belong to this lane's first tile, which
                # stores their zeros.
                got = u.tiles[k * tiles_per_lane:(k + 1) * tiles_per_lane + 1]
                off = k * n_seg
                assert torch.equal(got[1:-1] - off, alone.tiles[1:-1])
                owned = np.arange(int(got[0]), int(got[-1]))
                other = owned[(owned < off) | (owned >= off + n_seg)]
                lens = np.diff(u.seg_ptr.numpy())
                assert not lens[other].any()
            a_ptr, a_seg, a_first = tseg.split_chunks(
                alone.seg_ptr.numpy(), alone.per_thread)
            c0 = u_tab[2][k * n_seg]
            c1 = u_tab[2][(k + 1) * n_seg]
            a_ends = tseg.chunk_ends(alone.seg_ptr.numpy(), a_ptr, a_seg,
                                     a_first)
            shift = k * shape.n_edge
            assert np.array_equal(u_tab[0][c0:c1] - shift, a_ptr[:-1])
            assert np.array_equal(u_ends[c0:c1] - shift, a_ends)
            assert np.array_equal(u_tab[1][c0:c1] - k * n_seg, a_seg)
            assert np.array_equal(
                u_tab[2][k * n_seg:(k + 1) * n_seg + 1] - c0, a_first)
            # And the sums: each lane's, bitwise, in the model's order.
            data = np.random.default_rng(k).standard_normal(
                (2, shape.n_edge)).astype(np.float32)
            stacked = np.zeros((2, u.n_slots), np.float32)
            stacked[:, k * shape.n_edge:(k + 1) * shape.n_edge] = data
            got = model_sums(stacked, u)[:, k * n_seg:(k + 1) * n_seg]
            np.testing.assert_array_equal(got, model_sums(data, alone))


def test_window_count_matches_the_kernel_source():
    """The tiles a block walks, a step's budget and the launch shapes'
    codes: the model's, the plan side's and csrc/segsum.cu's kSegWindows,
    kStepBytes and SegShape agree."""
    import re
    from pathlib import Path

    src = (Path(tseg.__file__).resolve().parents[1] / "csrc"
           / "segsum.cu").read_text()
    (windows,) = re.findall(r"constexpr int kSegWindows = (\d+);", src)
    assert int(windows) == tseg.SEG_WINDOWS == WINDOWS
    (budget,) = re.findall(r"constexpr int kStepBytes = (\d+);", src)
    assert int(budget) == STEP_BYTES
    codes = dict(re.findall(r"  k(SplitChunks|SlotTiles|ThreadPerSegment)"
                            r" = (\d),", src))
    assert [int(codes[k]) for k in ("SplitChunks", "SlotTiles",
                                    "ThreadPerSegment")] == [
        tseg.SEG_SHAPES.index(s) for s in ("split chunks", "slot tiles",
                                           "thread per segment")]
    assert tseg.SLOT_TILE == KBLOCK
    # A step: 8 tiles at F = 3 in f32, 1 at F = 16 in f64.
    assert step_tiles(3, 4) == 8 and step_tiles(16, 8) == 1

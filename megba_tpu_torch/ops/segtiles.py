"""Sorted segment reductions and expansions over the edge stream.

Counterpart of the single-device dual-plan lowering of
`megba_tpu/ops/segtiles.py`, and of its five kernels: three on the
implicit-Schur path and the plain segment reduce / expand of the
explicit-Schur path.

Host side (numpy, `build_seg_plan` / `make_dual_plans`): the canonical
edge order is the stable camera sort of the edges; a second, point-sorted
order is planned over that camera-slot stream; `DualPlans.to_pt` /
`to_cam` move per-edge rows between the two orders.  Each side is
described by its sorted segment id per slot and CSR offsets
`seg_ptr[nS + 1]`.  The camera-cluster coarse spaces of TWO_LEVEL and
MULTILEVEL are planned here too (`build_camera_clusters`,
`build_cluster_plan`, `build_multilevel_plan`), over the camera-slot
stream, with the segment plans of their device sums.  The multi-device
solve plans here too: the 1-D mesh's per-shard dual plans
(`make_sharded_dual_plans`), the coarse plans' split
over the shards (`shard_cluster_plan`, `device_sharded_coarse_plan`)
and the 2-D mesh's camera-tile plan (`build_camera_tile_plan`,
`device_camera_tile_plan`).

The TPU plans also padded each block of segments to whole tiles: that
padding existed for the one-hot MXU matmuls (a tile had to touch one
output block) and is DROPPED here.  A CUDA segment reduction walks each
segment's contiguous range of the sorted stream, so the stream holds
exactly the real edges and no mask is needed.  The segment-sum contract
is unchanged: `out[:, s]` is the sum over the edges whose segment is s,
and an empty segment sums to zero.

Kernels (`jtj_grad_reduce`, `coupling_expand`, `coupling_reduce`,
`seg_reduce`, `seg_expand`): each has a plain PyTorch version (`*_plain`,
gathers and fixed-order segment sums, `segment_sum_sorted`) and a
hand-written CUDA kernel (`csrc/segtiles.cu`; kernel 4 in
`csrc/segsum.cu`).  The wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises,
and adds one to its `launches` count (and to that of the arm it ran,
`arm_launches`) per launch.  The two coupling kernels take the
precision arms of `csrc/precision.cuh` (ops/kernels.ARMS): bfloat16 J
rows beside a float32 or float64 vector, upcast before each multiply
(the mixed rungs), or with `bf16_operands` multiplied in bfloat16 with
float32 sums (the bf16 rung); `contract` / `operand` are their plain
arithmetic, shared with ops/fused.py.  All five read their
per-edge rows once and are bound by HBM bytes on the H100; see the
source note in `csrc/segtiles.cu`.

Launch shapes (`csrc/segreduce.cuh`, `csrc/segsum.cu`): where
segments are long (`SegPlan.per_thread` false: cameras), the three
reductions run a block per chunk: a segment of more than `SPLIT_ABOVE`
slots is split into chunks of at most `SPLIT_CHUNK`, a shorter one is
one chunk.  On a side of short segments (points), `jtj_grad_reduce` and
`coupling_reduce` run a thread per segment.  `seg_reduce` runs a
thread per segment too where every segment is under `SLOT_TILE` slots
(`SegPlan.all_short`), and otherwise slot tiles (`SLOT_TILE`
consecutive slots each, `SEG_WINDOWS` of them a block, staged a few at a
time; a segment owned by the tile it starts in; one of `SLOT_TILE`
slots or more summed by the whole block) beside the split chunks of the
side's segments over `SPLIT_ABOVE` slots, so that none of its threads
or blocks walks an unbounded run of slots (`seg_reduce_shape` reads the
bounds off a plan).  Every plan carries its tables, built once from the
host offsets (`make_seg_plan`): the chunk table (`SplitTable`: every
segment on a long side, only those over `SPLIT_ABOVE` on a short one)
with the counters that elect the block which adds a segment's chunk sums
in chunk order, and on a short side the tile table (`SegPlan.tiles`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
from typing import TYPE_CHECKING, Optional, Tuple, Union

import numpy as np
import torch

from megba_tpu_torch.native import sort_edges_by_camera
from megba_tpu_torch.ops import kernels as _kernels

if TYPE_CHECKING:
    from megba_tpu_torch.ops.fused import FusedPlan


# (od, d) pairs (od residual rows, d block parameters) the library of
# kernels 1-3 is built for: every registered factor family's camera and
# point blocks, the MEGBA_BLOCK lines of csrc/block_shapes.cuh, the one
# list, which the CUDA dispatch of kernels 1-3 expands as well.
SUPPORTED_BLOCKS = _kernels.listed_shapes("block_shapes.cuh", "MEGBA_BLOCK")
# A shape outside the list, up to this (od, d), gets a library of its own
# built at first use (`_lib`); beyond it the kernels raise.  At d = 16
# the Hessian kernel keeps 152 sums a thread (f64: 304 registers), which
# spill: the cap bounds how far that is allowed to go.
MAX_BUILT_BLOCK = (8, 16)
# Row counts F the plain segment reduce / expand kernels are built for:
# the MEGBA_WIDTH lines of csrc/fused_shapes.cuh (1 to 16: every block
# width up to MAX_BUILT_BLOCK's, and the nine-row groups of the coarse
# builds with their remainders).
SUPPORTED_WIDTHS = tuple(
    f for (f,) in _kernels.listed_shapes("fused_shapes.cuh", "MEGBA_WIDTH"))

# A side whose mean segment length is below this many edges is a side of
# short segments (points: ~5 edges each): a thread per segment in
# jtj_grad_reduce and coupling_reduce, slot tiles in seg_reduce; longer
# segments (cameras: thousands of edges each) run a block per chunk.
PER_THREAD_MAX_MEAN = 64
# The chunks of a split segment: a segment of L slots is one chunk up to
# SPLIT_ABOVE slots (a camera: a block sums it, as a block per segment
# would), and beyond that ceil(L / SPLIT_CHUNK) chunks of near-equal
# length (the pose prior's 200,000-slot point: 98 blocks, where one
# block used one SM of 132).  Timed in turns against one block a segment
# (scripts/torch_split_reduce_turns.py --split, PERF.md §6): splitting
# venice's ~2,800-slot cameras from 2048 slots made kernel 1 13 % slower;
# on cameras of 5,000-40,000 slots chunks of 2048 beat chunks of 1024 (by
# 10-13 points for kernel 1) and 4096-slot chunks from 8192.
SPLIT_CHUNK = 2048
SPLIT_ABOVE = 4096
# Slots per tile of the slot-tile launches (kernel 4 on a short side,
# csrc/segsum.cu `seg_reduce_tiles`; the fused kernels 7 and 8,
# csrc/segreduce.cuh `reduce_slot_tiles`): the kernels' block size,
# kBlock, and the most a tile may hold.
SLOT_TILE = 256
# Tiles one block of kernel 4's slot-tile launch walks: csrc/segsum.cu's
# kSegWindows, which this must match.
SEG_WINDOWS = 8
# Kernel 4's launch shapes, by their code in csrc/segsum.cu (SegShape).
SEG_SHAPES = ("split chunks", "slot tiles", "thread per segment")


def is_per_thread(n_slots: int, num_segments: int) -> bool:
    """Whether a side of `n_slots` slots over `num_segments` segments
    is summed a thread per segment (mean length under
    PER_THREAD_MAX_MEAN)."""
    return n_slots < PER_THREAD_MAX_MEAN * max(num_segments, 1)


# ---------------------------------------------------------------------------
# Host plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HostPlan:
    """Stable sort of edges by segment: `perm[s]` is the source of slot s."""

    perm: np.ndarray  # [n] int64
    seg: np.ndarray  # [n] int32, non-decreasing
    seg_ptr: np.ndarray  # [nS + 1] int64 CSR offsets
    num_segments: int


def build_seg_plan(idx: np.ndarray, num_segments: int) -> HostPlan:
    """Plan the segment-sorted order of edges with segment ids `idx`: the
    stable counting sort of `native.sort_edges_by_camera` (equal to
    `np.argsort(kind="stable")`)."""
    idx = np.asarray(idx).astype(np.int64, copy=False)
    if idx.size and (idx.min() < 0 or idx.max() >= num_segments):
        raise ValueError(
            f"segment ids out of range [0, {num_segments})")
    order = (sort_edges_by_camera(idx, num_segments) if idx.size
             else np.zeros(0, np.int64))
    seg = idx[order]
    counts = np.bincount(seg, minlength=num_segments)
    seg_ptr = np.zeros(num_segments + 1, np.int64)
    np.cumsum(counts, out=seg_ptr[1:])
    return HostPlan(perm=order.astype(np.int64), seg=seg.astype(np.int32),
                    seg_ptr=seg_ptr, num_segments=int(num_segments))


def split_chunks(seg_ptr: np.ndarray, long_only: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The chunks of the split-segment launch over CSR offsets
    `seg_ptr` [nS + 1]: (chunk_ptr [nc + 1] slot offsets, chunk_seg [nc]
    the segment of each chunk, seg_chunk [nS + 1] the first chunk of
    each segment), int64.  A segment of L slots has m = 1 chunk if
    L <= SPLIT_ABOVE, else m = ceil(L / SPLIT_CHUNK); chunk k starts
    k * L // m slots past the segment's start: near-equal lengths, in
    ascending order, placed by L alone.  An empty segment has one empty chunk,
    whose block stores its zero sums.  With `long_only` (a side of short
    segments, which kernel 4 sums in slot tiles) a segment of at most
    SPLIT_ABOVE slots has no chunk, so the listed chunks have gaps
    between them: the last chunk of a segment ends at the segment's end
    (`chunk_ends`), not where the next listed chunk starts."""
    seg_ptr = np.asarray(seg_ptr, np.int64)
    lengths = np.diff(seg_ptr)
    per_seg = np.where(lengths > SPLIT_ABOVE, -(-lengths // SPLIT_CHUNK),
                       0 if long_only else 1)
    seg_chunk = np.zeros(lengths.shape[0] + 1, np.int64)
    np.cumsum(per_seg, out=seg_chunk[1:])
    chunk_seg = np.repeat(np.arange(lengths.shape[0], dtype=np.int64),
                          per_seg)
    k = np.arange(chunk_seg.shape[0], dtype=np.int64) - seg_chunk[chunk_seg]
    chunk_ptr = np.empty(chunk_seg.shape[0] + 1, np.int64)
    chunk_ptr[:-1] = seg_ptr[chunk_seg] + (k * lengths[chunk_seg]
                                           // per_seg[chunk_seg])
    chunk_ptr[-1] = seg_ptr[-1]
    return chunk_ptr, chunk_seg, seg_chunk


def chunk_ends(seg_ptr: np.ndarray, chunk_ptr: np.ndarray,
               chunk_seg: np.ndarray, seg_chunk: np.ndarray) -> np.ndarray:
    """[nc] end of each chunk of a `split_chunks` table: the next chunk's
    start, or its segment's end for a segment's last chunk (what the
    kernel reads)."""
    ends = np.array(chunk_ptr[1:], np.int64)
    last = np.arange(1, ends.shape[0] + 1) == seg_chunk[chunk_seg + 1]
    ends[last] = np.asarray(seg_ptr)[chunk_seg[last] + 1]
    return ends


@dataclasses.dataclass(frozen=True)
class SplitTable:
    """The device chunk table of a side summed as split segments
    (`csrc/segreduce.cuh`, `reduce_split_segments`): `table` holds
    chunk_ptr, chunk_seg and seg_chunk of `split_chunks` end to end;
    `counters` [nS] counts a segment's finished chunks during a launch
    and is zero between launches (each launch's last block of a segment
    resets it), which holds because every launch that reads a plan is
    issued on the device's current stream."""

    table: torch.Tensor  # [2 * num_chunks + 1 + nS + 1] int64
    counters: torch.Tensor  # [nS] int32 ([0] with no chunk), zero between
    # launches
    num_chunks: int
    longest: int  # most chunks of one segment
    # The launches' chunk sums, per (width, dtype): made at first use and
    # reused by every launch, which the stream orders as it does the
    # counters.
    _work: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    def workspace(self, width: int, dtype: torch.dtype) -> torch.Tensor:
        """[num_chunks * width] scratch for a launch's chunk sums."""
        work = self._work.get((width, dtype))
        if work is None:
            work = self._work[(width, dtype)] = torch.empty(
                self.num_chunks * width, dtype=dtype,
                device=self.table.device)
        return work


def split_table(seg_ptr: np.ndarray, device,
                long_only: bool = False) -> SplitTable:
    """Build a side's `SplitTable` on `device` from its host offsets
    (once, with the plan: a launch reads it as it is); `long_only` as in
    `split_chunks`.  A table without chunks needs no counter."""
    chunk_ptr, chunk_seg, seg_chunk = split_chunks(seg_ptr, long_only)
    table = np.concatenate([chunk_ptr, chunk_seg, seg_chunk])
    per_seg = np.diff(seg_chunk)
    num_chunks = int(chunk_seg.shape[0])
    return SplitTable(
        table=torch.from_numpy(table).to(device),
        counters=torch.zeros(seg_chunk.shape[0] - 1 if num_chunks else 0,
                             dtype=torch.int32, device=device),
        num_chunks=num_chunks,
        longest=int(per_seg.max()) if per_seg.size else 0)


def slot_tiles(seg_ptr: torch.Tensor,
               slot_tile: int = SLOT_TILE) -> torch.Tensor:
    """Which segments each tile of `slot_tile` consecutive slots owns:
    [num_tiles + 1] int64 offsets into the segments, num_tiles =
    max(1, ceil(n / slot_tile)) for n = seg_ptr[-1] slots.

    Tile b owns the segments whose first slot lies in [b * slot_tile,
    (b + 1) * slot_tile).  An empty segment counts by its offset
    (seg_ptr[s] = seg_ptr[s + 1]), and the last tile also owns the
    trailing empty segments whose offset is n; so every segment has one
    owner, tiles own consecutive runs in order, and a tile in which no
    segment starts owns none.  The kernels take tiles of at most
    SLOT_TILE slots; smaller ones give the same sums."""
    if not 1 <= slot_tile <= SLOT_TILE:
        raise ValueError(f"slot_tile {slot_tile} outside [1, {SLOT_TILE}]")
    n = int(seg_ptr[-1])
    num_tiles = max(1, -(-n // slot_tile))
    starts = torch.arange(num_tiles, dtype=torch.int64,
                          device=seg_ptr.device) * slot_tile
    owned = torch.searchsorted(seg_ptr[:-1].contiguous(), starts)
    last = torch.full((1,), seg_ptr.shape[0] - 1, dtype=torch.int64,
                      device=seg_ptr.device)
    return torch.cat([owned, last])


@dataclasses.dataclass(frozen=True)
class SegPlan:
    """The device half of one side's plan."""

    seg: torch.Tensor  # [n] int32 segment id per slot (sorted)
    seg_ptr: torch.Tensor  # [nS + 1] int64
    num_segments: int
    # Slot in the OTHER order holding this slot's edge (cross permute).
    inv: torch.Tensor  # [n] int64
    # The chunk table (`plan_split`): on a long side every segment's
    # chunks (kernels 1, 3 and 4), on a per-thread side those of the
    # segments over SPLIT_ABOVE slots (kernel 4).  The slot tiles of a
    # per-thread side (`slot_tiles`; kernel 4, and the fused kernels of
    # an output side), None on a long side.  `make_seg_plan` builds
    # both; a plan without them serves the plain versions only.
    split: Optional[SplitTable] = None
    tiles: Optional[torch.Tensor] = None  # [num_tiles + 1] int64
    # A per-thread side whose every segment is under SLOT_TILE slots:
    # kernel 4 sums it a thread per segment (`seg_reduce_shape_of`).
    all_short: bool = False

    @property
    def n_slots(self) -> int:
        return self.seg.shape[0]

    @functools.cached_property
    def per_thread(self) -> bool:
        return is_per_thread(self.n_slots, self.num_segments)


def plan_split(seg_ptr: np.ndarray, n_slots: int, device) -> SplitTable:
    """The `SegPlan.split` of a side with host offsets `seg_ptr`: every
    segment's chunks where segments are long, only the chunks of those
    over SPLIT_ABOVE slots where they are short."""
    return split_table(seg_ptr, device,
                       long_only=is_per_thread(n_slots, len(seg_ptr) - 1))


def make_seg_plan(seg: np.ndarray, seg_ptr: np.ndarray, num_segments: int,
                  inv: np.ndarray, device) -> SegPlan:
    """One side's device plan from host arrays (segment ids [n], CSR
    offsets [nS + 1], the cross permute `inv` [n]), with the tables its
    kernels read: the chunk table (`plan_split`) and, on a side of short
    segments, the slot tiles (`slot_tiles`) and whether all of them are
    under SLOT_TILE slots.  Every `SegPlan` a kernel reads is built here,
    once."""
    seg_ptr = np.ascontiguousarray(seg_ptr, np.int64)
    n = int(np.asarray(seg).shape[0])
    per_thread = is_per_thread(n, int(num_segments))
    longest = int(np.diff(seg_ptr).max(initial=0))
    return SegPlan(
        seg=torch.from_numpy(np.ascontiguousarray(seg, np.int32)).to(device),
        seg_ptr=torch.from_numpy(seg_ptr).to(device),
        num_segments=int(num_segments),
        inv=torch.from_numpy(np.ascontiguousarray(inv, np.int64)).to(device),
        split=plan_split(seg_ptr, n, device),
        tiles=(slot_tiles(torch.from_numpy(seg_ptr)).to(device)
               if per_thread else None),
        all_short=per_thread and longest < SLOT_TILE)


def seg_reduce_shape_of(plan: SegPlan) -> str:
    """Kernel 4's launch shape on `plan`, one of SEG_SHAPES: split
    chunks on a long side, a thread per segment on a short side whose
    segments are all under SLOT_TILE slots, slot tiles on any other.
    Under SLOT_TILE slots a segment is summed from 0 in ascending order
    in the last two alike, so its sums do not depend on the choice."""
    if not plan.per_thread:
        return "split chunks"
    return "thread per segment" if plan.all_short else "slot tiles"


def seg_reduce_shape(plan: SegPlan) -> dict:
    """Kernel 4's launch on `plan`, read off its tables on the host: its
    shape (`seg_reduce_shape_of`), the tile and chunk counts, and what bounds the work of one block and
    of one thread: `block_slots`, the most slots a block reads, and
    `thread_slots`, the most slots one thread adds for one segment (from
    shared memory in a window, strided in a block-summed segment or a
    chunk).  A block of the slot-tile launch walks SEG_WINDOWS tiles,
    a few at a time: it stages each tile that owns a segment
    or follows one that does, and the rest of a segment carried past its
    last tile, and sums each owned segment of SLOT_TILE to SPLIT_ABOVE
    slots whole.  A block of the thread per segment reads its kBlock
    segments.  `SEG_REDUCE_BOUNDS[shape]` holds whatever the segment
    lengths."""
    seg_ptr = plan.seg_ptr.cpu().numpy()
    n = int(seg_ptr[-1])
    table = plan.split.table.cpu().numpy()
    nc = plan.split.num_chunks
    chunk_ptr, chunk_seg = table[:nc + 1], table[nc + 1:2 * nc + 1]
    seg_chunk = table[2 * nc + 1:]
    chunk_len = (chunk_ends(seg_ptr, chunk_ptr, chunk_seg, seg_chunk)
                 - chunk_ptr[:-1])
    out = dict(shape="split chunks", tiles=0, chunks=nc,
               block_slots=int(chunk_len.max(initial=0)),
               thread_slots=int(-(-chunk_len.max(initial=0) // SLOT_TILE)))
    shape = seg_reduce_shape_of(plan)
    lengths = np.diff(seg_ptr)
    if shape == "thread per segment":
        groups = np.add.reduceat(lengths, np.arange(0, lengths.shape[0],
                                                    SLOT_TILE)) if (
            lengths.shape[0]) else lengths
        return dict(out, shape=shape,
                    block_slots=int(groups.max(initial=0)),
                    thread_slots=int(lengths.max(initial=0)))
    tiles = None if plan.tiles is None else plan.tiles.cpu().numpy()
    if shape == "split chunks" or plan.num_segments == 0:
        return out if tiles is None else dict(
            out, shape=shape, tiles=tiles.shape[0] - 1)
    num_tiles = tiles.shape[0] - 1

    def window(w):  # the slots of tile w, to the stream's end
        return max(0, min(SLOT_TILE, n - w * SLOT_TILE))

    # Each block as the kernel walks it: each of its tiles that owns a
    # segment, or follows one that does, staged (to the stream's end);
    # each owned segment of SLOT_TILE to SPLIT_ABOVE slots read whole;
    # and the rest of its last segment, if that runs on past its tiles.
    # (The kernel stages less at the stream's end, and also reads the
    # offsets of the segments.)
    per_block = []
    for w0 in range(0, num_tiles, SEG_WINDOWS):
        nw = min(SEG_WINDOWS, num_tiles - w0)
        tp = tiles[w0:w0 + nw + 1]
        if tp[0] == tp[nw]:
            continue
        owns = tp[1:] > tp[:-1]
        reads = 0
        for k in range(nw):
            if owns[k] or (k > 0 and owns[k - 1]):
                reads += window(w0 + k)
            last = tp[k + 1] - 1
            if owns[k] and lengths[last] >= SLOT_TILE and (
                    seg_chunk[last + 1] == seg_chunk[last]):
                reads += int(lengths[last])
        last, block_end = tp[nw] - 1, (w0 + nw) * SLOT_TILE
        if owns[-1] and lengths[last] < SLOT_TILE:
            reads += max(0, int(seg_ptr[last + 1]) - block_end)
        per_block.append(reads)
    short = lengths[lengths < SLOT_TILE]
    summed = lengths[(lengths >= SLOT_TILE) & (lengths <= SPLIT_ABOVE)]
    thread = max(int(short.max(initial=0)),
                 int(-(-summed.max(initial=0) // SLOT_TILE)),
                 out["thread_slots"])
    out.update(shape="slot tiles", tiles=int(num_tiles),
               block_slots=max(max(per_block, default=0),
                               out["block_slots"]),
               thread_slots=thread)
    return out


# What `seg_reduce_shape` may report on any plan, by its shape.  A block
# of slot tiles reads at most its SEG_WINDOWS tiles, the rest of a
# segment carried past them (under SLOT_TILE slots) and the segments of
# SLOT_TILE to SPLIT_ABOVE slots that start in its tiles (disjoint: at
# most its tiles' slots and SPLIT_ABOVE past them); a chunk at most
# SPLIT_ABOVE, which 16 strided slots a thread cover; a block of the
# thread per segment its SLOT_TILE segments of under SLOT_TILE slots.  A
# thread adds at most SLOT_TILE - 1 slots of a segment.
SEG_REDUCE_BOUNDS = {
    "slot tiles": dict(
        block_slots=(2 * SEG_WINDOWS + 1) * SLOT_TILE + SPLIT_ABOVE,
        thread_slots=SLOT_TILE - 1),
    "thread per segment": dict(block_slots=SLOT_TILE * (SLOT_TILE - 1),
                               thread_slots=SLOT_TILE - 1),
    "split chunks": dict(block_slots=SPLIT_ABOVE,
                         thread_slots=SPLIT_ABOVE // SLOT_TILE),
}


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """An expand-only plan: the segment id of each slot, in any order.
    It has no offsets, so no segment sum can be asked of it: only the
    expands (`seg_expand`, `coupling_expand`) take it."""

    seg: torch.Tensor  # [n] int32 segment id per slot
    num_segments: int

    @property
    def n_slots(self) -> int:
        return self.seg.shape[0]


# What an expand takes: a reduce plan, or a gather plan alone.
ExpandPlan = Union[SegPlan, GatherPlan]


@dataclasses.dataclass(frozen=True)
class DualPlans:
    """Both edge orderings of one BA problem.  The canonical (slot) order
    of every edge array is `cam`'s; Jp is carried in `pt`'s order."""

    cam: SegPlan
    pt: SegPlan
    # The fused explicit-Schur directions (ops/fused.with_fused_plans),
    # planned only for SolverOption(fused_kernels=True).
    fused_to_pt: Optional[FusedPlan] = None
    fused_to_cam: Optional[FusedPlan] = None

    def to_pt(self, rows_cam: torch.Tensor) -> torch.Tensor:
        return rows_cam.index_select(1, self.pt.inv)

    def to_cam(self, rows_pt: torch.Tensor) -> torch.Tensor:
        return rows_pt.index_select(1, self.cam.inv)


def device_plan(plan: HostPlan, inv: np.ndarray,
                device: torch.device) -> SegPlan:
    """Move one side's host plan to `device`; `inv` is its cross permute.
    With its kernels' tables (`make_seg_plan`)."""
    return make_seg_plan(plan.seg, plan.seg_ptr, plan.num_segments, inv,
                         device)


def make_dual_plans(cam_idx: np.ndarray, pt_idx: np.ndarray,
                    num_cameras: int, num_points: int,
                    device: torch.device) -> Tuple[HostPlan, DualPlans]:
    """Plan both orderings.  Returns (cam host plan, device DualPlans).

    The caller reorders every edge array into the cam plan's slot order
    (`arr[cam_plan.perm]`); the pt plan is built over that camera-slot
    stream, so `pt.inv` indexes cam slots directly.
    """
    plan_c = build_seg_plan(cam_idx, num_cameras)
    pt_of_slot = np.asarray(pt_idx)[plan_c.perm]
    plan_p = build_seg_plan(pt_of_slot, num_points)
    inv_pt = plan_p.perm  # pt slot -> cam slot
    inv_cam = np.empty_like(inv_pt)  # cam slot -> pt slot
    inv_cam[inv_pt] = np.arange(inv_pt.shape[0], dtype=np.int64)

    return plan_c, DualPlans(cam=device_plan(plan_c, inv_cam, device),
                             pt=device_plan(plan_p, inv_pt, device))


def coobservation_edge_order(cam_idx: np.ndarray,
                             pt_idx: np.ndarray) -> np.ndarray:
    """Co-observation-first edge permutation (camera-major, point-minor,
    stable; JAX segtiles.py:1623): edges of one camera become contiguous
    and, within a camera, sorted by point.  A host argsort; applying it
    reorders only sums (results agree at solver tolerance)."""
    return np.lexsort((np.asarray(pt_idx), np.asarray(cam_idx)))


# ---------------------------------------------------------------------------
# Camera-cluster plans (the TWO_LEVEL / MULTILEVEL coarse spaces)
# ---------------------------------------------------------------------------
#
# Host NumPy, as the JAX package plans them (its segtiles.py:1164-1560),
# on one device: no shard grouping of the pairs.  Beside the JAX plan's
# index streams, each plan carries the segment plans that make its device
# sums deterministic on the card: the real edges sorted by their
# (point, cluster) incidence, and the edge-incidence pairs sorted by their
# (camera, cluster) segment.  The coarse build sums both with kernel 4
# (`seg_reduce`), as it sums every other edge-scale reduction.

# Edge-incidence pairs per launch of the coarse build's contraction: a
# chunk of this many pairs holds ~70 rows of transients per pair (the
# gathered coupling rows, their incidence partners and nine product rows),
# ~9.4 GB at float32 and ~19 GB at float64 (venice at float32 has 23.6M
# pairs: one chunk).  Chunks end on segment boundaries, so chunking never
# changes which terms a segment sums, only when the launch runs.
EC_CHUNK_PAIRS = 1 << 25


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """Host half of the camera-cluster coarse-space plan over one edge
    stream (JAX segtiles.py:1164-1185, one device).

    `pc_slot[e]` is edge e's (point, cluster) incidence (`n_pc` on a
    masked edge, which no sum reads); `pc_pt` the point of each incidence.
    The edge-incidence pairs (`ec_edge`, `ec_slot`, `ec_seg`; one per
    real edge e and incidence of its point, segment cam(e) * C + the
    incidence's cluster) are stably sorted by `ec_seg`, and `pc_order`
    lists the real edges stably sorted by incidence.
    """

    num_cameras: int
    num_clusters: int  # actual cluster count C (>= the target)
    n_pc: int  # distinct (point, cluster) incidences
    n_ec: int  # edge-incidence pairs
    cluster: np.ndarray  # [Nc] int32 cluster id per camera
    pc_slot: np.ndarray  # [nE] int32 incidence per edge (n_pc = inert)
    pc_pt: np.ndarray  # [n_pc] int32 point of each incidence
    pc_order: np.ndarray  # [n_real] int64 real edges sorted by incidence
    ec_edge: np.ndarray  # [n_ec] int64 edge of each pair
    ec_slot: np.ndarray  # [n_ec] int32 incidence of each pair
    ec_seg: np.ndarray  # [n_ec] int32 cam * C + cluster, non-decreasing


@dataclasses.dataclass(frozen=True)
class DeviceClusterPlan:
    """Device half of a `ClusterPlan`, on the solve device.

    `pc` sums edge rows (camera-slot order) per incidence: its `inv` is
    the edge of each of its slots.  `ec_chunks` sums pair rows per
    (camera, cluster) segment: each chunk is (first pair, end pair, first
    segment, its plan over those pairs, whose `inv` is the edge of each
    pair); `ec_slot` is the incidence of each pair.
    """

    num_clusters: int
    n_pc: int
    cluster: torch.Tensor  # [Nc] int64
    pc: SegPlan
    pc_pt: torch.Tensor  # [n_pc] int64
    ec_slot: torch.Tensor  # [n_ec] int64
    ec_chunks: Tuple[Tuple[int, int, int, SegPlan], ...]

    @property
    def shards(self) -> Tuple["DeviceClusterPlan", ...]:
        """One device's plan is the one shard of its split (the builds
        read every coarse plan shard by shard, `ShardedClusterPlan`)."""
        return (self,)


def build_camera_clusters(
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    num_cameras: int,
    target: int = 0,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Greedy co-observation-weighted aggregation of the cameras into
    ~target clusters (JAX segtiles.py:1247-1303, the same result).

    target = 0 selects ceil(sqrt(Nc)).  Camera pairs are weighted by the
    points they co-observe (consecutive cameras in each point's list in
    stream order) and merged heaviest first under a size cap of
    ceil(Nc / target) by union-find.  Returns [Nc] int32 cluster ids in
    [0, C); every camera, edge-less ones included, gets one.
    """
    cam_idx = np.asarray(cam_idx, np.int64)
    pt_idx = np.asarray(pt_idx, np.int64)
    if mask is not None:
        keep = np.asarray(mask) > 0
        cam_idx, pt_idx = cam_idx[keep], pt_idx[keep]
    if target <= 0:
        target = max(1, int(np.ceil(np.sqrt(num_cameras))))
    target = min(target, num_cameras)
    cap = max(1, -(-num_cameras // target))

    parent = np.arange(num_cameras, dtype=np.int64)
    size = np.ones(num_cameras, np.int64)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:  # path compression
            parent[i], i = root, parent[i]
        return root

    if cam_idx.size and cap > 1:
        order = np.argsort(pt_idx, kind="stable")
        ps, cs = pt_idx[order], cam_idx[order]
        adj = ps[1:] == ps[:-1]
        a, b = cs[:-1][adj], cs[1:][adj]
        neq = a != b
        a, b = a[neq], b[neq]
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        pairs, counts = np.unique(lo * num_cameras + hi, return_counts=True)
        for key in pairs[np.argsort(-counts, kind="stable")]:
            ra, rb = find(key // num_cameras), find(key % num_cameras)
            if ra != rb and size[ra] + size[rb] <= cap:
                parent[rb] = ra
                size[ra] += size[rb]

    roots = np.asarray([find(i) for i in range(num_cameras)])
    _, cluster = np.unique(roots, return_inverse=True)
    return cluster.astype(np.int32)


def build_cluster_plan(
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    num_cameras: int,
    num_points: int,
    target: int = 0,
    mask: Optional[np.ndarray] = None,
) -> ClusterPlan:
    """Plan the two-level coarse space over the SOLVER's edge stream (JAX
    segtiles.py:1306-1400 at world_size 1): `cam_idx` / `pt_idx` in the
    order of every edge array the solve reads (flat_solve: the camera
    slots), `mask` marking the real edges."""
    cam_idx = np.asarray(cam_idx, np.int64)
    pt_idx = np.asarray(pt_idx, np.int64)
    n_edges = int(cam_idx.shape[0])
    cluster = build_camera_clusters(cam_idx, pt_idx, num_cameras, target,
                                    mask)
    C = int(cluster.max()) + 1 if num_cameras else 1

    real = (np.ones(n_edges, bool) if mask is None
            else np.asarray(mask) > 0)
    key = pt_idx * C + cluster[cam_idx]  # (point, cluster) incidence id
    uniq, inv = np.unique(key[real], return_inverse=True)
    n_pc = int(uniq.shape[0])
    pc_slot = np.full(n_edges, n_pc, np.int32)
    pc_slot[real] = inv.astype(np.int32)
    pc_pt = (uniq // C).astype(np.int32)
    pc_cluster = (uniq % C).astype(np.int32)

    # One pair per real edge e and incidence of pt(e) (the incidences of
    # one point are contiguous in the sorted keys).
    pts, pstarts, pcounts = np.unique(pc_pt, return_index=True,
                                      return_counts=True)
    start_of_pt = np.zeros(max(num_points, 1), np.int64)
    count_of_pt = np.zeros(max(num_points, 1), np.int64)
    start_of_pt[pts] = pstarts
    count_of_pt[pts] = pcounts
    edge_ids = np.nonzero(real)[0]
    k_of_edge = count_of_pt[pt_idx[edge_ids]]
    n_ec = int(k_of_edge.sum())
    ec_edge = np.repeat(edge_ids, k_of_edge)
    off = np.arange(n_ec, dtype=np.int64) - np.repeat(
        np.cumsum(k_of_edge) - k_of_edge, k_of_edge)
    ec_slot = (start_of_pt[pt_idx[ec_edge]] + off).astype(np.int32)
    ec_seg = (cam_idx[ec_edge] * C + pc_cluster[ec_slot]).astype(np.int32)
    by_seg = np.argsort(ec_seg, kind="stable")
    pc_order = edge_ids[np.argsort(pc_slot[edge_ids], kind="stable")]
    return ClusterPlan(
        num_cameras=num_cameras, num_clusters=C, n_pc=max(n_pc, 1),
        n_ec=n_ec, cluster=cluster, pc_slot=pc_slot,
        pc_pt=pc_pt if n_pc else np.zeros(1, np.int32),
        pc_order=pc_order.astype(np.int64), ec_edge=ec_edge[by_seg],
        ec_slot=ec_slot[by_seg], ec_seg=ec_seg[by_seg])


def _csr(seg: np.ndarray, num_segments: int) -> np.ndarray:
    """CSR offsets [nS + 1] of a non-decreasing segment id stream."""
    ptr = np.zeros(num_segments + 1, np.int64)
    np.cumsum(np.bincount(seg, minlength=num_segments), out=ptr[1:])
    return ptr


def device_cluster_plan(plan: ClusterPlan,
                        device: torch.device) -> DeviceClusterPlan:
    """Move a cluster plan to `device`, with the pairs cut into chunks of
    at most `EC_CHUNK_PAIRS` pairs at segment boundaries (a segment longer
    than that is a chunk of its own)."""
    def t(a, dtype=torch.int64):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    pc_seg = plan.pc_slot[plan.pc_order]
    pc = make_seg_plan(pc_seg, _csr(pc_seg, plan.n_pc), plan.n_pc,
                       plan.pc_order, device)
    n_seg = plan.num_cameras * plan.num_clusters
    ptr = _csr(plan.ec_seg, n_seg)
    chunks = []
    s0 = 0
    while s0 < n_seg:
        s1 = int(np.searchsorted(ptr, ptr[s0] + EC_CHUNK_PAIRS,
                                 side="right")) - 1
        s1 = min(max(s1, s0 + 1), n_seg)
        p0, p1 = int(ptr[s0]), int(ptr[s1])
        chunks.append((p0, p1, s0, make_seg_plan(
            plan.ec_seg[p0:p1] - s0, ptr[s0:s1 + 1] - p0, s1 - s0,
            plan.ec_edge[p0:p1], device)))
        s0 = s1
    return DeviceClusterPlan(
        num_clusters=plan.num_clusters, n_pc=plan.n_pc,
        cluster=t(plan.cluster), pc=pc, pc_pt=t(plan.pc_pt),
        ec_slot=t(plan.ec_slot), ec_chunks=tuple(chunks))


@dataclasses.dataclass(frozen=True)
class MultiLevelPlan:
    """Host half of the recursive camera-cluster hierarchy (JAX
    segtiles.py:1441-1456): `base` is level 1, `level_sizes[i]` the
    cluster count of coarse level i+1, `assign[i]` maps level i+1's
    blocks onto level i+2's clusters."""

    base: ClusterPlan
    level_sizes: Tuple[int, ...]
    assign: Tuple[np.ndarray, ...]


@dataclasses.dataclass(frozen=True)
class DeviceMultiLevelPlan:
    """Device half of a `MultiLevelPlan`."""

    base: DeviceClusterPlan
    level_sizes: Tuple[int, ...]
    assign: Tuple[torch.Tensor, ...]  # int64


def build_multilevel_plan(
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    num_cameras: int,
    num_points: int,
    target: int = 0,
    mask: Optional[np.ndarray] = None,
    coarsen_factor: float = 4.0,
    max_levels: int = 3,
) -> MultiLevelPlan:
    """Plan the recursive hierarchy over one edge stream (JAX
    segtiles.py:1516-1560 at world_size 1): level 1 is
    `build_cluster_plan`; each further level aggregates the previous
    level's cluster graph toward ceil(C / coarsen_factor) clusters, up to
    `max_levels` levels (fine included), until the graph stops shrinking
    or has at most 2 blocks."""
    if not coarsen_factor > 1.0:
        raise ValueError(
            f"coarsen_factor must be > 1, got {coarsen_factor}")
    if max_levels < 2:
        raise ValueError(f"max_levels must be >= 2, got {max_levels}")
    base = build_cluster_plan(cam_idx, pt_idx, num_cameras, num_points,
                              target, mask)
    sizes = [base.num_clusters]
    assign: list = []
    edge_cl = base.cluster[np.asarray(cam_idx, np.int64)]
    while len(sizes) + 1 < max_levels and sizes[-1] > 2:
        cur = sizes[-1]
        tgt = max(1, int(np.ceil(cur / coarsen_factor)))
        if tgt >= cur:
            break
        nxt = build_camera_clusters(edge_cl, pt_idx, cur, tgt, mask)
        C = int(nxt.max()) + 1
        if C >= cur:
            break  # aggregation found nothing to merge
        assign.append(nxt.astype(np.int32))
        sizes.append(C)
        edge_cl = nxt[edge_cl]
    return MultiLevelPlan(base=base, level_sizes=tuple(sizes),
                          assign=tuple(assign))


def device_multilevel_plan(plan: MultiLevelPlan,
                           device: torch.device) -> DeviceMultiLevelPlan:
    return DeviceMultiLevelPlan(
        base=device_cluster_plan(plan.base, device),
        level_sizes=plan.level_sizes,
        assign=tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                     for a in plan.assign))


# ---------------------------------------------------------------------------
# Sharded plans (the multi-device solve, parallel/mesh.py)
# ---------------------------------------------------------------------------


def make_sharded_dual_plans(cam_idx: np.ndarray, pt_idx: np.ndarray,
                            num_cameras: int, num_points: int,
                            devices) -> Tuple[list, Tuple[DualPlans, ...]]:
    """Per-shard dual plans for the edge-sharded mesh (JAX
    segtiles.py:896-983).

    The edges are camera-sorted (stable) and cut into len(devices)
    contiguous chunks with bounds (k n) // N, the JAX package's tiled
    partition, which spreads the real edges evenly (its untiled lowering
    pads to N * EDGE_QUANTUM and splits the padded stream instead).  Each
    shard's plans cover all global segments.  Returns (perms, plans):
    shard k's edge arrays are `arr[perms[k]]`, in its camera-slot order,
    and `plans[k]` lives on devices[k].  No padding: the CSR plans need
    none.  A shard of another process (device None, a mesh across
    processes) gets its host order alone and None for its plans.
    """
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    n = int(cam_idx.shape[0])
    ws = len(devices)
    order = (sort_edges_by_camera(cam_idx, num_cameras) if n
             else np.zeros(0, np.int64))
    bounds = [(k * n) // ws for k in range(ws + 1)]
    perms, plans = [], []
    for k in range(ws):
        sel = order[bounds[k]:bounds[k + 1]]
        if devices[k] is None:
            plan_c, dp = build_seg_plan(cam_idx[sel], num_cameras), None
        else:
            plan_c, dp = make_dual_plans(cam_idx[sel], pt_idx[sel],
                                         num_cameras, num_points, devices[k])
        perms.append(sel[plan_c.perm].astype(np.int64))
        plans.append(dp)
    return perms, tuple(plans)


@dataclasses.dataclass(frozen=True)
class ShardedClusterPlan:
    """A device coarse-space plan split over the edge shards: `shards[k]`
    (a `DeviceClusterPlan` on shard k's device) holds the incidence plan
    and the pairs of shard k's edges, with shard-local edge ids; the
    cluster and incidence tables are replicated, read from the first
    shard this process holds (another process's shard is None)."""

    shards: Tuple[Optional[DeviceClusterPlan], ...]

    @property
    def _home(self) -> DeviceClusterPlan:
        return next(s for s in self.shards if s is not None)

    @property
    def num_clusters(self) -> int:
        return self._home.num_clusters

    @property
    def n_pc(self) -> int:
        return self._home.n_pc

    @property
    def cluster(self) -> torch.Tensor:
        return self._home.cluster

    @property
    def pc_pt(self) -> torch.Tensor:
        return self._home.pc_pt

    @property
    def ec_chunks(self) -> tuple:
        """Every local shard's pair chunks, shard by shard."""
        return tuple(c for s in self.shards if s is not None
                     for c in s.ec_chunks)


def shard_cluster_plan(plan: ClusterPlan,
                       shards) -> Tuple[ClusterPlan, ...]:
    """Split a cluster plan over edge shards (the JAX package's
    `world_size > 1` pair grouping, segtiles.py:1359-1396, and its
    `cluster_partition_specs`): `shards[k]` lists the positions, in the
    stream the plan was built over, of shard k's edges in shard k's
    order.  Shard k takes their incidence slots, its real edges sorted
    by incidence, and the pairs of its edges in the plan's segment
    order, with shard-local edge ids.  Shards may differ in length
    (nothing is padded) and need not be contiguous pieces of the stream
    (the 2-D mesh's device blocks are not).  The cluster and incidence
    tables are every shard's."""
    n = plan.pc_slot.shape[0]
    owner = np.full(n, -1, np.int64)
    local = np.zeros(n, np.int64)
    for k, pos in enumerate(shards):
        pos = np.asarray(pos, np.int64)
        owner[pos] = k
        local[pos] = np.arange(pos.shape[0])
    out = []
    for k, pos in enumerate(shards):
        pos = np.asarray(pos, np.int64)
        pc_slot = plan.pc_slot[pos]
        real = np.nonzero(pc_slot < plan.n_pc)[0]
        keep = owner[plan.ec_edge] == k
        out.append(dataclasses.replace(
            plan, n_ec=int(keep.sum()), pc_slot=pc_slot,
            pc_order=real[np.argsort(pc_slot[real], kind="stable")],
            ec_edge=local[plan.ec_edge[keep]],
            ec_slot=plan.ec_slot[keep], ec_seg=plan.ec_seg[keep]))
    return tuple(out)


def device_sharded_coarse_plan(plan, shards, devices):
    """A host `ClusterPlan` or `MultiLevelPlan` split over the edge shards
    (`shard_cluster_plan`) and moved shard by shard (JAX
    `coarse_plan_partition_specs`): a `ShardedClusterPlan`, or a
    `DeviceMultiLevelPlan` whose level 1 is one (the coarser levels'
    assignments are every shard's, JAX `multilevel_partition_specs`); the
    replicated tables live on the first device (across processes: this
    process's first; another process's shard, device None, gets None)."""
    if isinstance(plan, MultiLevelPlan):
        base = device_sharded_coarse_plan(plan.base, shards, devices)
        home = next(d for d in devices if d is not None)
        return DeviceMultiLevelPlan(
            base=base, level_sizes=plan.level_sizes,
            assign=tuple(torch.from_numpy(a.astype(np.int64)).to(home)
                         for a in plan.assign))
    return ShardedClusterPlan(shards=tuple(
        None if d is None else device_cluster_plan(p, d)
        for p, d in zip(shard_cluster_plan(plan, shards), devices)))


# ---------------------------------------------------------------------------
# The 2-D camera x edge plan (JAX segtiles.py:1637-1871)
# ---------------------------------------------------------------------------


def edge_stream_reuse(cam_idx: np.ndarray, pt_idx: np.ndarray,
                      cam_tile: int, pt_tile: int,
                      mask: Optional[np.ndarray] = None) -> dict:
    """Streaming tile-reuse statistics of one edge order (JAX
    segtiles.py:1637): `switches` counts the consecutive edges that need
    another (camera tile, point tile) pair, the first fetch included;
    `reuse_factor` is edges per fetched pair."""
    cam_idx = np.asarray(cam_idx, np.int64)
    pt_idx = np.asarray(pt_idx, np.int64)
    if mask is not None:
        keep = np.asarray(mask) > 0
        cam_idx, pt_idx = cam_idx[keep], pt_idx[keep]
    n = int(cam_idx.shape[0])
    if n == 0:
        return {"edges": 0, "switches": 0, "reuse_factor": 0.0}
    key = (cam_idx // max(1, int(cam_tile)),
           pt_idx // max(1, int(pt_tile)))
    changed = (key[0][1:] != key[0][:-1]) | (key[1][1:] != key[1][:-1])
    switches = int(changed.sum()) + 1
    return {"edges": n, "switches": switches,
            "reuse_factor": float(n) / float(switches)}


@dataclasses.dataclass(frozen=True)
class CameraTilePlan:
    """Host half of the 2-D camera x edge plan (JAX segtiles.py:1670).

    The padded stream (length `n_edges_padded` = cam_blocks *
    column_len) carries caller edge `perm[i]` at position i where
    `mask[i] > 0`; device block b = e * cam_blocks + c is the slice
    [b * chunk, (b + 1) * chunk) and holds edge shard e of camera column
    c, its real edges first.  Bucket e*C*C + c*C + s lists device
    (e, c)'s real edges whose point lies in point shard s: their
    device-local slot, shard-local point and a 1."""

    num_cameras: int
    num_points: int
    edge_shards: int  # E
    cam_blocks: int  # C
    tile_cams: int  # Tc: cameras per tile (C * Tc >= Nc)
    shard_points: int  # Sp: points per shard (C * Sp >= Np)
    n_edges_real: int
    n_edges_padded: int
    bucket_width: int  # Lb
    perm: np.ndarray  # [nE_pad] int64 caller edge per stream slot
    mask: np.ndarray  # [nE_pad] float64 1 = real, 0 = padding
    cam_idx: np.ndarray  # [nE_pad] int32 global camera per slot
    pt_idx: np.ndarray  # [nE_pad] int32 global point per slot
    cam_local: np.ndarray  # [nE_pad] int32 tile-local camera per slot
    bucket_slot: np.ndarray  # [E*C*C, Lb] int32 device-local edge slot
    bucket_ptl: np.ndarray  # [E*C*C, Lb] int32 shard-local point
    bucket_mask: np.ndarray  # [E*C*C, Lb] int32 1 = real pair
    reuse: dict


def build_camera_tile_plan(cam_idx: np.ndarray, pt_idx: np.ndarray,
                           num_cameras: int, num_points: int,
                           edge_shards: int, cam_blocks: int,
                           quantum: int = 0) -> CameraTilePlan:
    """Plan the 2-D camera x edge distribution over a caller edge set
    (JAX segtiles.py:1750-1871, the same arrays).

    Edges go to the camera column owning their camera's tile
    (contiguous tiles of ceil(Nc / cam_blocks) cameras), in
    co-observation order within the column; every column is padded to
    one length, a multiple of edge_shards * quantum (default
    core.fm.EDGE_QUANTUM), so the E * C device chunks are equal.
    Padding slots repeat the column's last real camera and point 0,
    under mask 0.
    """
    from megba_tpu_torch.core.fm import EDGE_QUANTUM

    if quantum <= 0:
        quantum = EDGE_QUANTUM
    E, C = int(edge_shards), int(cam_blocks)
    if E < 1 or C < 1:
        raise ValueError(
            f"edge_shards and cam_blocks must be >= 1, got {E} x {C}")
    cam_idx = np.asarray(cam_idx, np.int64)
    pt_idx = np.asarray(pt_idx, np.int64)
    n_real = int(cam_idx.shape[0])
    Tc = max(1, -(-int(num_cameras) // C))
    Sp = max(1, -(-int(num_points) // C))
    col = np.minimum(cam_idx // Tc, C - 1)

    col_ids = []
    for c in range(C):
        ids = np.nonzero(col == c)[0]
        ids = ids[coobservation_edge_order(cam_idx[ids], pt_idx[ids])]
        col_ids.append(ids)
    Lc = max(1, max(ids.shape[0] for ids in col_ids))
    Lc = -(-Lc // (E * quantum)) * (E * quantum)
    chunk = Lc // E

    perm = np.zeros(C * Lc, np.int64)
    mask = np.zeros(C * Lc, np.float64)
    cam_s = np.zeros(C * Lc, np.int32)
    pt_s = np.zeros(C * Lc, np.int32)
    cam_l = np.zeros(C * Lc, np.int32)
    pos = 0
    for e in range(E):
        for c in range(C):
            ids = col_ids[c]
            seg = ids[e * chunk:(e + 1) * chunk]
            n = seg.shape[0]
            sl = slice(pos, pos + chunk)
            perm[sl][:n] = seg
            mask[pos:pos + n] = 1.0
            if ids.shape[0]:
                pad_cam = int(cam_idx[ids[-1]])
            else:
                pad_cam = min(c * Tc, max(0, int(num_cameras) - 1))
            cams = np.full(chunk, pad_cam, np.int32)
            cams[:n] = cam_idx[seg]
            pts = np.zeros(chunk, np.int32)
            pts[:n] = pt_idx[seg]
            cam_s[sl] = cams
            pt_s[sl] = pts
            cam_l[sl] = np.clip(cams - c * Tc, 0, Tc - 1)
            pos += chunk

    n_dev = E * C
    rows = []
    for d in range(n_dev):
        sl = slice(d * chunk, (d + 1) * chunk)
        ptd, md = pt_s[sl], mask[sl]
        rows.append([np.nonzero((ptd // Sp == s) & (md > 0))[0]
                     for s in range(C)])
    Lb = max(1, max(max((r.shape[0] for r in dev), default=0)
                    for dev in rows))
    b_slot = np.zeros((n_dev * C, Lb), np.int32)
    b_ptl = np.zeros((n_dev * C, Lb), np.int32)
    b_mask = np.zeros((n_dev * C, Lb), np.int32)
    for d, dev in enumerate(rows):
        for s, sel in enumerate(dev):
            n = sel.shape[0]
            b_slot[d * C + s, :n] = sel
            b_ptl[d * C + s, :n] = pt_s[d * chunk + sel] - s * Sp
            b_mask[d * C + s, :n] = 1

    edges_t = switches_t = 0
    for d in range(n_dev):
        sl = slice(d * chunk, (d + 1) * chunk)
        r = edge_stream_reuse(cam_s[sl], pt_s[sl], Tc, Sp, mask=mask[sl])
        edges_t += r["edges"]
        switches_t += r["switches"]
    reuse = {"edges": edges_t, "switches": switches_t,
             "reuse_factor": float(edges_t) / float(max(switches_t, 1))}
    return CameraTilePlan(
        num_cameras=int(num_cameras), num_points=int(num_points),
        edge_shards=E, cam_blocks=C, tile_cams=Tc, shard_points=Sp,
        n_edges_real=n_real, n_edges_padded=C * Lc, bucket_width=Lb,
        perm=perm, mask=mask, cam_idx=cam_s, pt_idx=pt_s,
        cam_local=cam_l, bucket_slot=b_slot, bucket_ptl=b_ptl,
        bucket_mask=b_mask, reuse=reuse)


def tile_plan_shards(plan: CameraTilePlan) -> Tuple[np.ndarray, ...]:
    """The caller edges of each device block, real edges only, in device
    order (JAX `tile_plan_partition_specs`: the stream splits over both
    mesh axes, edge-shard-major).  Each block's real edges are the first
    slots of its chunk, so a slot index means the same in the block and
    in its real edges."""
    n_dev = plan.edge_shards * plan.cam_blocks
    chunk = plan.n_edges_padded // n_dev
    out = []
    for d in range(n_dev):
        m = plan.mask[d * chunk:(d + 1) * chunk] > 0
        n = int(m.sum())
        if not m[:n].all():
            raise AssertionError("a device block's real edges must lead "
                                 "its chunk")
        out.append(plan.perm[d * chunk:d * chunk + n])
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class DeviceCameraTilePlan:
    """Device half of a `CameraTilePlan` (JAX segtiles.py:1705-1735).

    `rings[d][s]` is the ring-step plan of device d's bucket over point
    shard s, on device d: a `FusedPlan` whose input ids are the
    shard-local points, whose output side is a CSR plan over the Tc
    cameras of the tile (segment = tile-local camera, `inv` = the
    device-local slot of each entry, whose rows the step reads) and
    whose slot tiles cover its entries.  The padding entries of the JAX
    buckets (mask 0, rows zeroed there) are left out: they add nothing.
    `in_plans[d][s]` is the same bucket's input side for the unfused
    step's expand, a `GatherPlan` (segment = shard-local point, in entry
    order, not sorted)."""

    edge_shards: int
    cam_blocks: int
    tile_cams: int
    shard_points: int
    rings: Tuple[tuple, ...]
    in_plans: Tuple[tuple, ...]


def device_camera_tile_plan(plan: CameraTilePlan,
                            devices) -> DeviceCameraTilePlan:
    """Move the ring-step buckets of a tile plan to the mesh's devices
    (device-block order).  Over each bucket's real entries the output
    camera must not decrease (each block's stream is camera-major): that
    is what makes its CSR plan valid, and it is checked here."""
    from megba_tpu_torch.ops.fused import ring_step_plan

    E, C = plan.edge_shards, plan.cam_blocks
    Tc, Sp = plan.tile_cams, plan.shard_points
    chunk = plan.n_edges_padded // (E * C)
    rings, in_plans = [], []
    for d in range(E * C):
        dev = devices[d]
        cl = plan.cam_local[d * chunk:(d + 1) * chunk]
        r_d, i_d = [], []
        for s in range(C):
            b = d * C + s
            n = int(plan.bucket_mask[b].sum())
            slot = plan.bucket_slot[b, :n].astype(np.int64)
            ptl = plan.bucket_ptl[b, :n]
            out_cam = cl[slot]
            if n and np.any(np.diff(out_cam) < 0):
                raise AssertionError(
                    f"ring bucket {b}: output cameras decrease")
            r_d.append(ring_step_plan(ptl, out_cam, slot, Sp, Tc, dev))
            i_d.append(GatherPlan(
                seg=torch.from_numpy(ptl.astype(np.int32)).to(dev),
                num_segments=Sp))
        rings.append(tuple(r_d))
        in_plans.append(tuple(i_d))
    return DeviceCameraTilePlan(edge_shards=E, cam_blocks=C, tile_cams=Tc,
                                shard_points=Sp, rings=tuple(rings),
                                in_plans=tuple(in_plans))


# ---------------------------------------------------------------------------
# Host plan cache (JAX segtiles.py:990-1100, 1399, 1561, 1874)
# ---------------------------------------------------------------------------
#
# Planning is host work (sorts and bincounts over the edge axis, the
# coarse spaces' union-find) plus the moves of the index tables to the
# devices, and depends only on the problem GRAPH and the mesh, not on
# parameters or observations.  Repeated solves of one problem (chunked
# drivers, reruns, parameter sweeps) reuse one plan, keyed by a content
# fingerprint of the index arrays: a strong digest (blake2b), not
# Python's hash(), since a collision would silently solve the wrong
# graph.  The JAX key's `use_kernels` gives way to the devices the plan's
# tensors live on: a plan built for the CPU, or for another shard list,
# never serves another solve.  A plan holds integer tensors only (the
# kernels' float scratch, `SplitTable.workspace`, is made per dtype at
# first use), so no float dtype enters the key.
#
# A cached plan is read-only: every host array in it is made
# non-writeable when it is stored, and its device tensors are read by
# the kernels and never written (a split table's counters return to zero
# at the end of every launch).  `with_fused_plans` returns new plans, so
# a fused solve's plans are kept beside the unfused ones in the same
# entry (built on the first fused use) and never change them.  Solves
# that share a cached plan share its split tables' counters and
# scratch, which is safe while their launches run on one stream per
# device (the current stream, as every launch of the port's is).

_PLAN_CACHE: dict = {}
_PLAN_CACHE_DEFAULT_MAX = 8  # LRU bound: plans pin host and device tables
# Monotone eviction counter: a fleet of mixed shape classes churning a
# too-small cache shows up here (flat_solve surfaces the delta as a
# `plan_cache_evict` PhaseTimer event next to `plan_cache_hit`).
_PLAN_CACHE_EVICTIONS = 0
# Monotone lookup counters (hits, misses) of this process, which a
# driver reads around a stretch of solves (`plan_cache_counts`).
_PLAN_CACHE_LOOKUPS = [0, 0]


def plan_cache_capacity() -> int:
    """LRU capacity of the host plan cache.

    `MEGBA_PLAN_CACHE=<n>` overrides the default of
    `_PLAN_CACHE_DEFAULT_MAX` (8): a fleet serving many shape classes
    evicts pathologically at 8, while a single-problem pipeline gains
    nothing from more.  Read at insertion time so tests (and long-lived
    services) can retune without reimporting; `<n> >= 1`.
    """
    env = os.environ.get("MEGBA_PLAN_CACHE")
    if env is None:
        return _PLAN_CACHE_DEFAULT_MAX
    try:
        cap = int(env)
    except ValueError as e:
        raise ValueError(
            f"MEGBA_PLAN_CACHE must be an integer >= 1, got {env!r}") from e
    if cap < 1:
        raise ValueError(
            f"MEGBA_PLAN_CACHE must be an integer >= 1, got {env!r}")
    return cap


def plan_cache_evictions() -> int:
    """Total plan-cache evictions this process (monotone counter)."""
    return _PLAN_CACHE_EVICTIONS


def plan_cache_counts() -> dict:
    """This process's plan-cache lookups so far: {"hits", "misses",
    "evictions"} (monotone counters)."""
    return {"hits": _PLAN_CACHE_LOOKUPS[0], "misses": _PLAN_CACHE_LOOKUPS[1],
            "evictions": _PLAN_CACHE_EVICTIONS}


def clear_plan_cache() -> None:
    """Drop every cached plan (the eviction counter is not reset)."""
    _PLAN_CACHE.clear()


def _array_digest(a: np.ndarray) -> bytes:
    a = np.ascontiguousarray(a)
    h = hashlib.blake2b(digest_size=16)
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.digest()


def _devices_key(devices) -> tuple:
    return tuple("remote" if d is None else str(torch.device(d))
                 for d in devices)


def _members(obj):
    """The direct members of a plan node: tuple and list items, dict
    values, dataclass fields."""
    if isinstance(obj, (tuple, list)):
        return obj
    if isinstance(obj, dict):
        return obj.values()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    return ()


def _freeze(obj) -> None:
    """Make every host array of a plan read-only."""
    if isinstance(obj, np.ndarray):
        obj.flags.writeable = False
        return
    for m in _members(obj):
        _freeze(m)


def _device_storages(obj, out: dict) -> dict:
    """The device (non-CPU) tensors of a plan, by storage: data_ptr ->
    bytes."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "cpu":
            st = obj.untyped_storage()
            out[st.data_ptr()] = st.nbytes()
        return out
    for m in _members(obj):
        _device_storages(m, out)
    return out


def plan_cache_device_bytes() -> int:
    """Bytes of device memory the cached plans hold, each storage counted
    once (the kernels' scratch included)."""
    found: dict = {}
    for entry in _PLAN_CACHE.values():
        _device_storages(entry, found)
    return sum(found.values())


def _plan_cache_get(key):
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        # Refresh LRU position (dicts preserve insertion order).
        _PLAN_CACHE.pop(key)
        _PLAN_CACHE[key] = hit
    return hit


def _plan_cache_put(key, value):
    global _PLAN_CACHE_EVICTIONS
    cap = plan_cache_capacity()
    while len(_PLAN_CACHE) >= cap:
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        _PLAN_CACHE_EVICTIONS += 1
    _PLAN_CACHE[key] = value


def _cached(key, build, fuse=None, fused: bool = False):
    """(value, hit) of the entry `key`, built by `build()` on a miss; with
    `fused`, the entry's fused variant `fuse(value)`, built on its first
    use and kept in the same entry."""
    entry = _plan_cache_get(key)
    hit = entry is not None
    _PLAN_CACHE_LOOKUPS[0 if hit else 1] += 1
    if not hit:
        value = build()
        _freeze(value)
        entry = {False: value}
        _plan_cache_put(key, entry)
    if fused and True not in entry:
        entry[True] = fuse(entry[False])
    return entry[bool(fused)], hit


def _resolved(devices) -> tuple:
    if devices is None:
        from megba_tpu_torch.common import resolve_device

        return (resolve_device(None),)
    if isinstance(devices, (str, torch.device)):
        return (torch.device(devices),)
    return tuple(None if d is None else torch.device(d) for d in devices)


def _fuse_all(plans) -> tuple:
    from megba_tpu_torch.ops.fused import with_fused_plans

    return tuple(None if p is None else with_fused_plans(p) for p in plans)


def cached_dual_plans(cam_idx: np.ndarray, pt_idx: np.ndarray,
                      num_cameras: int, num_points: int, device=None):
    """`make_dual_plans` behind the host plan cache: ((cam host plan,
    DualPlans), cache_hit), the plans on `device` (None: the card)."""
    (dev,) = _resolved(device)
    key = ("single", _array_digest(cam_idx), _array_digest(pt_idx),
           int(num_cameras), int(num_points), _devices_key((dev,)))
    return _cached(key, lambda: make_dual_plans(
        cam_idx, pt_idx, num_cameras, num_points, dev))


def cached_sharded_dual_plans(cam_idx: np.ndarray, pt_idx: np.ndarray,
                              num_cameras: int, num_points: int,
                              devices=None, fused: bool = False):
    """`make_sharded_dual_plans` behind the host plan cache: ((perms,
    per-shard DualPlans), cache_hit) over `devices` (one a shard; None:
    one shard on the card).  The one-device solve is the mesh of one
    shard, so it plans here too.  With `fused` each shard's plans carry
    both fused directions (`ops/fused.with_fused_plans`)."""
    devs = _resolved(devices)
    key = ("sharded", _array_digest(cam_idx), _array_digest(pt_idx),
           int(num_cameras), int(num_points), len(devs), _devices_key(devs))
    return _cached(
        key, lambda: make_sharded_dual_plans(cam_idx, pt_idx, num_cameras,
                                             num_points, devs),
        lambda v: (v[0], _fuse_all(v[1])), fused)


def _block_plans(tplan: "CameraTilePlan", cam_idx, pt_idx, devs):
    """The 2-D mesh's device blocks (`tile_plan_shards`) and each block's
    dual plans on its device; each block is camera-sorted, so its
    camera-slot order is its own."""
    nc, npt = tplan.num_cameras, tplan.num_points
    perms = tile_plan_shards(tplan)
    plans = []
    for p, d in zip(perms, devs):
        plan_c, dp = make_dual_plans(cam_idx[p], pt_idx[p], nc, npt, d)
        if not np.array_equal(plan_c.perm, np.arange(p.shape[0])):
            raise AssertionError("a 2-D device block is not camera-sorted")
        plans.append(dp)
    return perms, tuple(plans)


def cached_camera_tile_plan(cam_idx: np.ndarray, pt_idx: np.ndarray,
                            num_cameras: int, num_points: int,
                            edge_shards: int, cam_blocks: int,
                            quantum: int = 0, devices=None,
                            fused: bool = False):
    """`build_camera_tile_plan` + `device_camera_tile_plan` behind the
    host plan cache, keyed by the index arrays, EVERY geometry knob and
    the devices (edge_shards * cam_blocks of them, in device-block
    order).  Returns ((CameraTilePlan, DeviceCameraTilePlan, perms, block
    DualPlans), cache_hit): the port's 2-D lowering also plans each
    device block's dual plans (`perms[d]`, the caller's edges of block
    d), which ride in the same entry, fused with `fused`."""
    devs = _resolved(devices)
    key = ("mesh2d", _array_digest(np.asarray(cam_idx)),
           _array_digest(np.asarray(pt_idx)), int(num_cameras),
           int(num_points), int(edge_shards), int(cam_blocks), int(quantum),
           _devices_key(devs))

    def build():
        tplan = build_camera_tile_plan(cam_idx, pt_idx, num_cameras,
                                       num_points, edge_shards, cam_blocks,
                                       quantum=quantum)
        perms, plans = _block_plans(tplan, np.asarray(cam_idx),
                                    np.asarray(pt_idx), devs)
        return tplan, device_camera_tile_plan(tplan, devs), perms, plans

    return _cached(key, build,
                   lambda v: (v[0], v[1], v[2], _fuse_all(v[3])), fused)


def _coarse_key(kind: str, cam_idx, pt_idx, mask, num_cameras, num_points,
                devs, shards, knobs: tuple) -> tuple:
    return ((kind, _array_digest(np.asarray(cam_idx)),
             _array_digest(np.asarray(pt_idx)),
             None if mask is None else _array_digest(np.asarray(mask) > 0),
             int(num_cameras), int(num_points), _devices_key(devs),
             None if shards is None
             else tuple(_array_digest(np.asarray(s, np.int64))
                        for s in shards)) + knobs)


def _shards(shards, cam_idx) -> list:
    if shards is None:
        return [np.arange(np.asarray(cam_idx).shape[0], dtype=np.int64)]
    return list(shards)


def cached_cluster_plan(cam_idx: np.ndarray, pt_idx: np.ndarray,
                        num_cameras: int, num_points: int, target: int = 0,
                        mask: Optional[np.ndarray] = None,
                        smooth_omega: float = 0.0, devices=None,
                        shards=None):
    """`build_cluster_plan` + `device_sharded_coarse_plan` behind the host
    plan cache: ((ClusterPlan, ShardedClusterPlan), cache_hit).

    Keyed by a blake2b fingerprint of the index arrays (the stream the
    plan is built over), the mask, EVERY aggregation parameter (target,
    the smoothing omega), the devices and the shards (`shards[k]`: the
    positions in that stream of shard k's edges, as
    `device_sharded_coarse_plan` takes them; None: one shard of every
    edge on the first device).  The JAX key's `world_size` is the number
    of shards here.  `smooth_omega` does not change the plan's content
    (smoothing is a device-side build step over the planned indices), but
    it is part of the key by contract: a SolverOption knob flip must
    never serve a stale plan from the LRU."""
    devs = _resolved(devices)
    parts = _shards(shards, cam_idx)
    key = _coarse_key("cluster", cam_idx, pt_idx, mask, num_cameras,
                      num_points, devs, shards,
                      (int(target), float(smooth_omega)))

    def build():
        plan = build_cluster_plan(cam_idx, pt_idx, num_cameras, num_points,
                                  target, mask)
        return plan, device_sharded_coarse_plan(plan, parts, devs)

    return _cached(key, build)


def cached_multilevel_plan(cam_idx: np.ndarray, pt_idx: np.ndarray,
                           num_cameras: int, num_points: int,
                           target: int = 0,
                           mask: Optional[np.ndarray] = None,
                           coarsen_factor: float = 4.0, max_levels: int = 3,
                           smooth_omega: float = 0.0, devices=None,
                           shards=None):
    """`build_multilevel_plan` + `device_sharded_coarse_plan` behind the
    host plan cache: ((MultiLevelPlan, DeviceMultiLevelPlan), cache_hit).
    The key is `cached_cluster_plan`'s with every further aggregation
    knob (coarsen_factor, max_levels): flipping any SolverOption
    preconditioner knob never serves a stale hierarchy."""
    devs = _resolved(devices)
    parts = _shards(shards, cam_idx)
    key = _coarse_key("multilevel", cam_idx, pt_idx, mask, num_cameras,
                      num_points, devs, shards,
                      (int(target), float(coarsen_factor), int(max_levels),
                       float(smooth_omega)))

    def build():
        plan = build_multilevel_plan(
            cam_idx, pt_idx, num_cameras, num_points, target, mask,
            coarsen_factor=coarsen_factor, max_levels=max_levels)
        return plan, device_sharded_coarse_plan(plan, parts, devs)

    return _cached(key, build)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the reference the kernels are held to)
# ---------------------------------------------------------------------------


def segment_sum_sorted(rows: torch.Tensor,
                       seg_ptr: torch.Tensor) -> torch.Tensor:
    """[F, nS] sums of [F, n] rows over the CSR segments `seg_ptr`
    ([nS + 1] int64) of a segment-sorted stream, each segment summed in
    slot order from its first slot (an empty segment sums to 0).

    `torch.segment_reduce` over the offsets: one fixed order on either
    device, so two runs on the card are bitwise equal, where the CUDA
    atomics of `index_add_` change their order from run to run.
    """
    F = rows.shape[0]
    if rows.shape[1] == 0:
        return torch.zeros((F, seg_ptr.shape[0] - 1), dtype=rows.dtype,
                           device=rows.device)
    offsets = seg_ptr.expand(F, seg_ptr.shape[0]).contiguous()
    return torch.segment_reduce(rows, "sum", offsets=offsets, axis=1,
                                unsafe=True)


def _segment_sum(rows: torch.Tensor, plan: SegPlan) -> torch.Tensor:
    return segment_sum_sorted(rows, plan.seg_ptr)


def jtj_grad_reduce_plain(J: torch.Tensor, r: torch.Tensor,
                          plan: SegPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per segment: rows of sum J_e^T J_e [d*d, nS], -sum J_e^T r_e [d, nS]."""
    od = r.shape[0]
    d = J.shape[0] // od
    h = torch.stack([
        sum(J[o * d + a] * J[o * d + b] for o in range(od))
        for a in range(d) for b in range(d)])
    g = torch.stack([
        -sum(J[o * d + a] * r[o] for o in range(od)) for a in range(d)])
    return _segment_sum(h, plan), _segment_sum(g, plan)


def operand(x: torch.Tensor, bf16_operands: bool) -> torch.Tensor:
    """The vector operand of a product: rounded to bfloat16 in the bf16
    arm, kept in its dtype otherwise."""
    return x.to(torch.bfloat16).to(x.dtype) if bf16_operands else x


def contract(rows, vec, acc_dtype: torch.dtype, bf16_operands: bool):
    """sum_k rows[k] * vec[k] in the accumulator dtype, in ascending k
    from the first term (csrc/precision.cuh).  The bf16 arm rounds each
    product to bfloat16 (its operands already are); otherwise each row is
    upcast first."""
    out = None
    for row, v in zip(rows, vec):
        t = row.to(acc_dtype) * v
        if bf16_operands:
            t = t.to(torch.bfloat16).to(acc_dtype)
        out = t if out is None else out + t
    return out


def coupling_expand_plain(table: torch.Tensor, J: torch.Tensor,
                          plan: ExpandPlan, d: int,
                          bf16_operands: bool = False) -> torch.Tensor:
    """[od, n]: u[o] = sum_a J[o*d+a] * table[a, seg], in the table's
    dtype; the bf16 arm rounds the gathered values, each product and u
    to bfloat16."""
    od = J.shape[0] // d
    pe = operand(table.index_select(1, plan.seg), bf16_operands)
    return torch.stack([
        operand(contract(J[o * d:(o + 1) * d], pe, table.dtype,
                          bf16_operands), bf16_operands)
        for o in range(od)])


def coupling_reduce_plain(J: torch.Tensor, u: torch.Tensor, plan: SegPlan,
                          d: int, bf16_operands: bool = False) -> torch.Tensor:
    """[d, nS]: out[b, s] = sum_{e in s} sum_o J[o*d+b, e] * u[o, e], in
    u's dtype; the bf16 arm rounds u and each product to bfloat16."""
    od = u.shape[0]
    uu = operand(u, bf16_operands)
    te = torch.stack([
        contract([J[o * d + b] for o in range(od)], uu, u.dtype,
                 bf16_operands)
        for b in range(d)])
    return _segment_sum(te, plan)


def seg_reduce_plain(data: torch.Tensor, plan: SegPlan) -> torch.Tensor:
    """[F, nS]: out[:, s] = the sum of data's slots in segment s."""
    return _segment_sum(data, plan)


def seg_expand_plain(table: torch.Tensor, plan: ExpandPlan) -> torch.Tensor:
    """[F, n]: out[:, e] = table[:, seg[e]]."""
    return table.index_select(1, plan.seg)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "megba_jtj_grad_reduce": (
        ctypes.c_int,
        [_I, _I, _I, _P, _P, _P, _P, _P, _L, _P, _P, _L, _L, _I, _P]),
    "megba_coupling_expand": (
        ctypes.c_int, [_I, _I, _I, _P, _P, _P, _P, _L, _L, _P]),
    "megba_coupling_reduce": (
        ctypes.c_int,
        [_I, _I, _I, _P, _P, _P, _P, _P, _L, _P, _P, _L, _L, _I, _P]),
    "megba_seg_expand": (ctypes.c_int, [_I, _I, _P, _P, _P, _L, _L, _P]),
    "megba_error_string": (ctypes.c_char_p, [_I]),
}
# Kernel 4 (`seg_reduce`) has a source and library of its own
# (csrc/segsum.cu), built in parallel with csrc/segtiles.cu's.
SUM_SIGNATURES = {
    "megba_seg_reduce": (
        ctypes.c_int,
        [_I, _I, _P, _P, _P, _L, _P, _P, _L, _P, _P, _L, _L, _I, _P]),
    "megba_error_string": (ctypes.c_char_p, [_I]),
}
KERNEL_SOURCES = ("segtiles", "segsum")


def _lib(shape: Optional[Tuple[int, int]] = None) -> ctypes.CDLL:
    """The library of kernels 1-3 and 5 (`shape` None or listed), or that
    of one other (od, d) shape of kernels 1-3, built at first use."""
    if shape is None or shape in SUPPORTED_BLOCKS:
        return _kernels.load_library("segtiles", _SIGNATURES)
    od, d = shape
    return _kernels.load_library(
        "segtiles", _SIGNATURES,
        defines={"MEGBA_ONE_BLOCK_OD": od, "MEGBA_ONE_BLOCK_D": d})


def _sum_lib() -> ctypes.CDLL:
    """The library of kernel 4 (csrc/segsum.cu)."""
    return _kernels.load_library("segsum", SUM_SIGNATURES)


def kernel_source(name: str) -> str:
    """The CUDA source (csrc/<source>.cu) of this module's kernel
    `name`."""
    return "segsum" if name == "seg_reduce" else "segtiles"


def check_block(name: str, shape: Tuple[int, int]) -> None:
    """Raise the typed refusal of a CUDA call of kernel `name` at an
    (od, d) shape with no kernel: outside the list and beyond
    `MAX_BUILT_BLOCK`.  Nothing falls back to the plain version."""
    if shape in SUPPORTED_BLOCKS:
        return
    if not (1 <= shape[0] <= MAX_BUILT_BLOCK[0]
            and 1 <= shape[1] <= MAX_BUILT_BLOCK[1]):
        raise NotImplementedError(
            f"{name}: no CUDA kernel for block shape (od, d) = {shape}: "
            f"csrc/block_shapes.cuh lists {SUPPORTED_BLOCKS}, and a shape "
            f"outside it is built at first use up to (od, d) <= "
            f"{MAX_BUILT_BLOCK}")


def check_operands(name: str, **tensors: torch.Tensor) -> torch.device:
    """Validate float operands on either device: one device, one float32
    or float64 dtype, contiguous.  Returns the device."""
    first = next(iter(tensors.values()))
    dev = first.device
    for k, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {k} is on {t.device}, expected {dev}")
        if t.dtype != first.dtype or t.dtype not in (torch.float32,
                                                     torch.float64):
            raise TypeError(
                f"{name}: {k} has dtype {t.dtype}; all operands must share "
                "float32 or float64")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    return dev


def check_plan(name: str, plan, dev: torch.device,
               expand: bool = False) -> None:
    """The plan's CSR arrays must be contiguous and on the operands'
    device, with nS + 1 offsets.  Only an `expand` may take a
    `GatherPlan` (segment ids in any order, no offsets)."""
    if isinstance(plan, GatherPlan) and expand:
        arrays = (("plan.seg", plan.seg, torch.int32),)
    elif isinstance(plan, SegPlan):
        arrays = (("plan.seg", plan.seg, torch.int32),
                  ("plan.seg_ptr", plan.seg_ptr, torch.int64))
    else:
        raise TypeError(f"{name} needs a SegPlan (sorted segments and "
                        f"their offsets), got {type(plan).__name__}")
    for k, t, dt in arrays:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"{name}: {k} must be a contiguous {dt} tensor on {dev}")
    if isinstance(plan, SegPlan) and \
            plan.seg_ptr.shape != (plan.num_segments + 1,):
        raise ValueError(f"{name}: plan.seg_ptr has shape "
                         f"{tuple(plan.seg_ptr.shape)}, expected "
                         f"({plan.num_segments + 1},)")


def _check(name: str, width: int, plan, expand: bool = False,
           **tensors: torch.Tensor) -> torch.device:
    """Validate the operands of a plain segment kernel (4, 5) on either
    device, and what the CUDA kernel does not check itself; raise on
    anything it does not take.  `width` is the row count F the call
    needs."""
    dev = check_operands(name, **tensors)
    if dev.type == "cuda" and width not in SUPPORTED_WIDTHS:
        raise NotImplementedError(
            f"{name}: no CUDA kernel for width {width}: "
            f"csrc/fused_shapes.cuh lists {SUPPORTED_WIDTHS}")
    check_plan(name, plan, dev, expand)
    return dev


def _check_coupling(name: str, shape, plan, vector: torch.Tensor,
                    bf16_operands: bool, J: torch.Tensor,
                    expand: bool = False) -> tuple:
    """The checks of a coupling kernel, whose J rows may be bfloat16:
    returns the (code, name) of the precision arm (ops/kernels.ARMS)."""
    arm = _kernels.check_arm(name, vector, bf16_operands, J=J)
    if vector.device.type == "cuda":
        check_block(name, shape)
    check_plan(name, plan, vector.device, expand)
    return arm


def _raise_on(code: int, name: str) -> None:
    _kernels.raise_on(_lib(), code, name)


def _chunk_args(name: str, plan: SegPlan, width: int, dtype: torch.dtype,
                dev: torch.device) -> tuple:
    """The plan's chunk table as its C launcher takes it: the table, the
    counters, the chunk count and the workspace of `width` values a chunk
    (`SplitTable`, made by `split_table`), which must be on `dev`."""
    split = plan.split
    if split is None:
        raise ValueError(
            f"{name}: the plan has no chunk table (SegPlan.split; "
            "make_seg_plan builds it)")
    if split.table.device != dev:
        raise ValueError(f"{name}: plan.split is on {split.table.device}, "
                         f"expected {dev}")
    return (split.table.data_ptr(), split.counters.data_ptr(),
            split.num_chunks, split.workspace(width, dtype).data_ptr())


def _split_args(name: str, plan: SegPlan, width: int, dtype: torch.dtype,
                dev: torch.device) -> tuple:
    """The split-segment arguments of kernel 1 or 3's C launcher
    (`_chunk_args`).  A per-thread side passes none; a side of long
    segments must carry its chunk table on `dev`."""
    if plan.per_thread:
        return None, None, 0, None
    return _chunk_args(name, plan, width, dtype, dev)


def _tile_args(name: str, plan: SegPlan, dev: torch.device) -> tuple:
    """Kernel 4's tile arguments: the slot tiles and their count where it
    runs slot tiles (the plan must carry them on `dev`, one tile per
    SLOT_TILE slots), none in its other shapes."""
    if seg_reduce_shape_of(plan) != "slot tiles":
        return None, 0
    tiles = plan.tiles
    if tiles is None:
        raise ValueError(
            f"{name}: a plan of short segments needs its slot tiles "
            "(SegPlan.tiles; make_seg_plan builds them)")
    want = max(1, -(-plan.n_slots // SLOT_TILE)) + 1
    if (tiles.device != dev or tiles.dtype != torch.int64
            or not tiles.is_contiguous() or tiles.shape != (want,)):
        raise ValueError(
            f"{name}: plan.tiles must be a contiguous int64 tensor of "
            f"{want} offsets on {dev} (a tile per {SLOT_TILE} slots), got "
            f"{tuple(tiles.shape)} {tiles.dtype} on {tiles.device}")
    return tiles.data_ptr(), want - 1


def jtj_grad_reduce(J: torch.Tensor, r: torch.Tensor,
                    plan: SegPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused block-diagonal Hessian + gradient for one vertex kind.

    J [od*d, n], r [od, n] in plan slot order (weighted and masked).
    Returns (h_rows [d*d, nS], g_rows [d, nS]): the rows of
    sum_e J_e^T J_e and -sum_e J_e^T r_e per segment.
    """
    od = r.shape[0]
    d = J.shape[0] // od
    n = r.shape[1]
    if J.shape != (od * d, n) or plan.n_slots != n:
        raise ValueError(
            f"jtj_grad_reduce: J {tuple(J.shape)}, r {tuple(r.shape)} and "
            f"{plan.n_slots} plan slots disagree")
    dev = check_operands("jtj_grad_reduce", J=J, r=r)
    if dev.type == "cuda":
        check_block("jtj_grad_reduce", (od, d))
    check_plan("jtj_grad_reduce", plan, dev)
    if dev.type == "cpu":
        return jtj_grad_reduce_plain(J, r, plan)
    out = torch.empty((d * d + d, plan.num_segments), dtype=J.dtype,
                      device=dev)
    split = _split_args("jtj_grad_reduce", plan, d * (d + 1) // 2 + d,
                        J.dtype, dev)
    with torch.cuda.device(dev):
        code = _lib((od, d)).megba_jtj_grad_reduce(
            int(J.dtype == torch.float64), od, d, J.data_ptr(),
            r.data_ptr(), plan.seg_ptr.data_ptr(), *split, out.data_ptr(), n,
            plan.num_segments, int(plan.per_thread),
            _kernels.current_stream(dev))
    _raise_on(code, "jtj_grad_reduce")
    _kernels.count_launch(jtj_grad_reduce, _kernels.dtype_arm(J.dtype),
                          (od, d))
    return out[: d * d], out[d * d:]


def coupling_expand(table: torch.Tensor, J: torch.Tensor, plan: ExpandPlan,
                    d: int, bf16_operands: bool = False) -> torch.Tensor:
    """u[o] = sum_a J[o*d+a] * table[a, seg] -> [od, n] rows.

    The fused (gather + J.x) half of a coupling product: J [od*d, n] in
    plan slot order, table [d, nS].  J has the table's float32 or float64
    dtype, or is bfloat16 (upcast before each multiply; with
    `bf16_operands` and a float32 table, bfloat16 products and u rounded
    to bfloat16).  u has the table's dtype.
    """
    od = J.shape[0] // d
    n = J.shape[1]
    if J.shape[0] != od * d or table.shape != (d, plan.num_segments) \
            or plan.n_slots != n:
        raise ValueError(
            f"coupling_expand: table {tuple(table.shape)}, J "
            f"{tuple(J.shape)}, d={d} and {plan.n_slots} plan slots "
            "disagree")
    arm_code, arm = _check_coupling("coupling_expand", (od, d), plan,
                                    table, bf16_operands, J, expand=True)
    dev = table.device
    if dev.type == "cpu":
        return coupling_expand_plain(table, J, plan, d, bf16_operands)
    u = torch.empty((od, n), dtype=table.dtype, device=dev)
    with torch.cuda.device(dev):
        code = _lib((od, d)).megba_coupling_expand(
            arm_code, od, d, table.data_ptr(), J.data_ptr(),
            plan.seg.data_ptr(), u.data_ptr(), n, plan.num_segments,
            _kernels.current_stream(dev))
    _raise_on(code, "coupling_expand")
    _kernels.count_launch(coupling_expand, arm, (od, d))
    return u


def coupling_reduce(J: torch.Tensor, u: torch.Tensor, plan: SegPlan,
                    d: int, bf16_operands: bool = False) -> torch.Tensor:
    """out[b, s] = sum_{e in s} sum_o J[o*d+b, e] * u[o, e] -> [d, nS].

    The fused (J^T.u + segment reduce) half of a coupling product.  J
    has u's float32 or float64 dtype, or is bfloat16 (as in
    `coupling_expand`; `bf16_operands` rounds u on read).  The output
    has u's dtype.
    """
    od = u.shape[0]
    n = u.shape[1]
    if J.shape != (od * d, n) or plan.n_slots != n:
        raise ValueError(
            f"coupling_reduce: J {tuple(J.shape)}, u {tuple(u.shape)}, "
            f"d={d} and {plan.n_slots} plan slots disagree")
    arm_code, arm = _check_coupling("coupling_reduce", (od, d), plan, u,
                                    bf16_operands, J)
    dev = u.device
    if dev.type == "cpu":
        return coupling_reduce_plain(J, u, plan, d, bf16_operands)
    out = torch.empty((d, plan.num_segments), dtype=u.dtype, device=dev)
    split = _split_args("coupling_reduce", plan, d, u.dtype, dev)
    with torch.cuda.device(dev):
        code = _lib((od, d)).megba_coupling_reduce(
            arm_code, od, d, J.data_ptr(), u.data_ptr(),
            plan.seg_ptr.data_ptr(), *split, out.data_ptr(), n,
            plan.num_segments, int(plan.per_thread),
            _kernels.current_stream(dev))
    _raise_on(code, "coupling_reduce")
    _kernels.count_launch(coupling_reduce, arm, (od, d))
    return out


def seg_reduce(data: torch.Tensor, plan: SegPlan) -> torch.Tensor:
    """Segment sums of plan-ordered rows: data [F, n] -> [F, nS], where
    out[:, s] sums the slots of segment s (an empty segment sums to 0)."""
    F, n = data.shape
    if plan.n_slots != n:
        raise ValueError(f"seg_reduce: data {tuple(data.shape)} and "
                         f"{plan.n_slots} plan slots disagree")
    dev = _check("seg_reduce", F, plan, data=data)
    if dev.type == "cpu":
        return seg_reduce_plain(data, plan)
    out = torch.empty((F, plan.num_segments), dtype=data.dtype, device=dev)
    tiles = _tile_args("seg_reduce", plan, dev)
    chunks = _chunk_args("seg_reduce", plan, F, data.dtype, dev)
    lib = _sum_lib()
    with torch.cuda.device(dev):
        code = lib.megba_seg_reduce(
            int(data.dtype == torch.float64), F, data.data_ptr(),
            plan.seg_ptr.data_ptr(), *tiles, *chunks, out.data_ptr(), n,
            plan.num_segments, SEG_SHAPES.index(seg_reduce_shape_of(plan)),
            _kernels.current_stream(dev))
    _kernels.raise_on(lib, code, "seg_reduce")
    _kernels.count_launch(seg_reduce, _kernels.dtype_arm(data.dtype), (F,))
    return out


def seg_expand(table: torch.Tensor, plan: ExpandPlan) -> torch.Tensor:
    """Gather of segment rows to plan-ordered slots: table [F, nS] ->
    [F, n], out[:, e] = table[:, seg[e]]."""
    F = table.shape[0]
    if table.shape != (F, plan.num_segments):
        raise ValueError(f"seg_expand: table {tuple(table.shape)} and "
                         f"{plan.num_segments} plan segments disagree")
    dev = _check("seg_expand", F, plan, expand=True,
                 table=table)
    if dev.type == "cpu":
        return seg_expand_plain(table, plan)
    n = plan.n_slots
    out = torch.empty((F, n), dtype=table.dtype, device=dev)
    with torch.cuda.device(dev):
        code = _lib().megba_seg_expand(
            int(table.dtype == torch.float64), F, table.data_ptr(),
            plan.seg.data_ptr(), out.data_ptr(), n, plan.num_segments,
            _kernels.current_stream(dev))
    _raise_on(code, "seg_expand")
    _kernels.count_launch(seg_expand, _kernels.dtype_arm(table.dtype), (F,))
    return out


KERNELS = (jtj_grad_reduce, coupling_expand, coupling_reduce, seg_reduce,
           seg_expand)


def reset_launch_counts() -> None:
    _kernels.reset_counts(KERNELS)


reset_launch_counts()


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def arm_launch_counts() -> dict:
    """Launches per kernel and precision arm, as {"name[arm]": count}."""
    return {f"{k.__name__}[{arm}]": n for k in KERNELS
            for arm, n in k.arm_launches.items()}


def shape_launch_counts() -> dict:
    """Launches per shape, as {"name(od,d)": count} for kernels 1-3 and
    {"name(F)": count} for kernels 4-5."""
    return _kernels.shape_counts(KERNELS)

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
hand-written CUDA kernel
(`csrc/segtiles.cu`).  The wrapper takes the plain version only for
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

Launch shapes (`csrc/segreduce.cuh`): a side of short segments
(`SegPlan.per_thread`: points) is summed a thread per segment.  Where
segments are long, `seg_reduce` gives each one block, and
`jtj_grad_reduce` and `coupling_reduce` a block per chunk: a segment of
more than `SPLIT_ABOVE` slots is split into chunks of at most
`SPLIT_CHUNK`.  The plan carries the chunk table (`SplitTable`, built
once from the host offsets by `split_table`) and the counters that
elect the block which adds a segment's chunk sums in chunk order.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import TYPE_CHECKING, Optional, Tuple, Union

import numpy as np
import torch

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

# A side whose mean segment length is below this many edges reduces with
# one thread per segment (points: ~5 edges each); longer segments get one
# thread block each (cameras: thousands of edges each) in seg_reduce, and
# a block per chunk in jtj_grad_reduce and coupling_reduce.
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
    """Plan the segment-sorted order of edges with segment ids `idx`."""
    idx = np.asarray(idx).astype(np.int64, copy=False)
    if idx.size and (idx.min() < 0 or idx.max() >= num_segments):
        raise ValueError(
            f"segment ids out of range [0, {num_segments})")
    order = np.argsort(idx, kind="stable")
    seg = idx[order]
    counts = np.bincount(seg, minlength=num_segments)
    seg_ptr = np.zeros(num_segments + 1, np.int64)
    np.cumsum(counts, out=seg_ptr[1:])
    return HostPlan(perm=order.astype(np.int64), seg=seg.astype(np.int32),
                    seg_ptr=seg_ptr, num_segments=int(num_segments))


def split_chunks(seg_ptr: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The chunks of the split-segment launch over CSR offsets
    `seg_ptr` [nS + 1]: (chunk_ptr [nc + 1] slot offsets, chunk_seg [nc]
    the segment of each chunk, seg_chunk [nS + 1] the first chunk of
    each segment), int64.  A segment of L slots has m = 1 chunk if
    L <= SPLIT_ABOVE, else m = ceil(L / SPLIT_CHUNK); chunk k starts
    k * L // m slots past the segment's start: near-equal lengths, in
    ascending order, placed by L alone.  An empty segment has one empty chunk,
    whose block stores its zero sums."""
    seg_ptr = np.asarray(seg_ptr, np.int64)
    lengths = np.diff(seg_ptr)
    per_seg = np.where(lengths > SPLIT_ABOVE, -(-lengths // SPLIT_CHUNK), 1)
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
    counters: torch.Tensor  # [nS] int32, zero between launches
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


def split_table(seg_ptr: np.ndarray, device) -> SplitTable:
    """Build a side's `SplitTable` on `device` from its host offsets
    (once, with the plan: a launch reads it as it is)."""
    chunk_ptr, chunk_seg, seg_chunk = split_chunks(seg_ptr)
    table = np.concatenate([chunk_ptr, chunk_seg, seg_chunk])
    per_seg = np.diff(seg_chunk)
    return SplitTable(
        table=torch.from_numpy(table).to(device),
        counters=torch.zeros(seg_chunk.shape[0] - 1, dtype=torch.int32,
                             device=device),
        num_chunks=int(chunk_seg.shape[0]),
        longest=int(per_seg.max()) if per_seg.size else 0)


@dataclasses.dataclass(frozen=True)
class SegPlan:
    """The device half of one side's plan."""

    seg: torch.Tensor  # [n] int32 segment id per slot (sorted)
    seg_ptr: torch.Tensor  # [nS + 1] int64
    num_segments: int
    # Slot in the OTHER order holding this slot's edge (cross permute).
    inv: torch.Tensor  # [n] int64
    # The chunk table of kernels 1 and 3 where segments are long
    # (`plan_split`); None on a per-thread side, and on plans only kernel
    # 4, 5 or the fused kernels read.
    split: Optional[SplitTable] = None

    @property
    def n_slots(self) -> int:
        return self.seg.shape[0]

    @functools.cached_property
    def per_thread(self) -> bool:
        return is_per_thread(self.n_slots, self.num_segments)


def plan_split(seg_ptr: np.ndarray, n_slots: int,
               device) -> Optional[SplitTable]:
    """The `SegPlan.split` of a side with host offsets `seg_ptr`: its
    chunk table where segments are long, None where they are summed a
    thread per segment."""
    if is_per_thread(n_slots, len(seg_ptr) - 1):
        return None
    return split_table(seg_ptr, device)


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
    A side of long segments gets its chunk table (`plan_split`)."""
    return SegPlan(
        seg=torch.from_numpy(plan.seg).to(device),
        seg_ptr=torch.from_numpy(plan.seg_ptr).to(device),
        num_segments=plan.num_segments,
        inv=torch.from_numpy(inv).to(device),
        split=plan_split(plan.seg_ptr, plan.seg.shape[0], device))


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
    pc = SegPlan(seg=t(pc_seg, torch.int32),
                 seg_ptr=t(_csr(pc_seg, plan.n_pc)),
                 num_segments=plan.n_pc, inv=t(plan.pc_order))
    n_seg = plan.num_cameras * plan.num_clusters
    ptr = _csr(plan.ec_seg, n_seg)
    chunks = []
    s0 = 0
    while s0 < n_seg:
        s1 = int(np.searchsorted(ptr, ptr[s0] + EC_CHUNK_PAIRS,
                                 side="right")) - 1
        s1 = min(max(s1, s0 + 1), n_seg)
        p0, p1 = int(ptr[s0]), int(ptr[s1])
        chunks.append((p0, p1, s0, SegPlan(
            seg=t(plan.ec_seg[p0:p1] - s0, torch.int32),
            seg_ptr=t(ptr[s0:s1 + 1] - p0), num_segments=s1 - s0,
            inv=t(plan.ec_edge[p0:p1]))))
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
    none.
    """
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    n = int(cam_idx.shape[0])
    ws = len(devices)
    order = np.argsort(cam_idx, kind="stable")
    bounds = [(k * n) // ws for k in range(ws + 1)]
    perms, plans = [], []
    for k in range(ws):
        sel = order[bounds[k]:bounds[k + 1]]
        plan_c, dp = make_dual_plans(cam_idx[sel], pt_idx[sel], num_cameras,
                                     num_points, devices[k])
        perms.append(sel[plan_c.perm].astype(np.int64))
        plans.append(dp)
    return perms, tuple(plans)


@dataclasses.dataclass(frozen=True)
class ShardedClusterPlan:
    """A device coarse-space plan split over the edge shards: `shards[k]`
    (a `DeviceClusterPlan` on shard k's device) holds the incidence plan
    and the pairs of shard k's edges, with shard-local edge ids; the
    cluster and incidence tables are replicated, read from shard 0."""

    shards: Tuple[DeviceClusterPlan, ...]

    @property
    def num_clusters(self) -> int:
        return self.shards[0].num_clusters

    @property
    def n_pc(self) -> int:
        return self.shards[0].n_pc

    @property
    def cluster(self) -> torch.Tensor:
        return self.shards[0].cluster

    @property
    def pc_pt(self) -> torch.Tensor:
        return self.shards[0].pc_pt

    @property
    def ec_chunks(self) -> tuple:
        """Every shard's pair chunks, shard by shard."""
        return tuple(c for s in self.shards for c in s.ec_chunks)


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
    replicated tables live on devices[0]."""
    if isinstance(plan, MultiLevelPlan):
        base = device_sharded_coarse_plan(plan.base, shards, devices)
        return DeviceMultiLevelPlan(
            base=base, level_sizes=plan.level_sizes,
            assign=tuple(torch.from_numpy(a.astype(np.int64)).to(devices[0])
                         for a in plan.assign))
    return ShardedClusterPlan(shards=tuple(
        device_cluster_plan(p, d)
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
    "megba_seg_reduce": (ctypes.c_int, [_I, _I, _P, _P, _P, _L, _L, _I, _P]),
    "megba_seg_expand": (ctypes.c_int, [_I, _I, _P, _P, _P, _L, _L, _P]),
    "megba_error_string": (ctypes.c_char_p, [_I]),
}
KERNEL_SOURCES = ("segtiles",)


def _lib(shape: Optional[Tuple[int, int]] = None) -> ctypes.CDLL:
    """The library of kernels 1-5 (`shape` None or listed), or that of one
    other (od, d) shape of kernels 1-3, built at first use."""
    if shape is None or shape in SUPPORTED_BLOCKS:
        return _kernels.load_library("segtiles", _SIGNATURES)
    od, d = shape
    return _kernels.load_library(
        "segtiles", _SIGNATURES,
        defines={"MEGBA_ONE_BLOCK_OD": od, "MEGBA_ONE_BLOCK_D": d})


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


def _split_args(name: str, plan: SegPlan, width: int, dtype: torch.dtype,
                dev: torch.device) -> tuple:
    """The split-segment arguments of kernel 1 or 3's C launcher: the
    chunk table, the counters, the chunk count and the workspace of
    `width` values a chunk (`SplitTable`, made by `split_table`).  A
    per-thread side passes none; a side of long segments must carry its
    chunk table on `dev`."""
    if plan.per_thread:
        return None, None, 0, None
    split = plan.split
    if split is None:
        raise ValueError(
            f"{name}: a plan of long segments needs its chunk table "
            "(SegPlan.split; device_plan and plan_split build it)")
    if split.table.device != dev:
        raise ValueError(f"{name}: plan.split is on {split.table.device}, "
                         f"expected {dev}")
    return (split.table.data_ptr(), split.counters.data_ptr(),
            split.num_chunks, split.workspace(width, dtype).data_ptr())


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
    with torch.cuda.device(dev):
        code = _lib().megba_seg_reduce(
            int(data.dtype == torch.float64), F, data.data_ptr(),
            plan.seg_ptr.data_ptr(), out.data_ptr(), n, plan.num_segments,
            int(plan.per_thread), _kernels.current_stream(dev))
    _raise_on(code, "seg_reduce")
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

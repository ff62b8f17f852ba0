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
`seg_ptr[nS + 1]`.

The TPU plans also padded each block of segments to whole tiles: that
padding existed for the one-hot MXU matmuls (a tile had to touch one
output block) and is DROPPED here.  A CUDA segment reduction walks each
segment's contiguous range of the sorted stream, so the stream holds
exactly the real edges and no mask is needed.  The segment-sum contract
is unchanged: `out[:, s]` is the sum over the edges whose segment is s,
and an empty segment sums to zero.

Kernels (`jtj_grad_reduce`, `coupling_expand`, `coupling_reduce`,
`seg_reduce`, `seg_expand`): each has a plain PyTorch version (`*_plain`,
gathers and `index_add_`) and a hand-written CUDA kernel
(`csrc/segtiles.cu`).  The wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises,
and adds one to its `launches` count per launch.  All five read their
per-edge rows once and are bound by HBM bytes on the H100; see the
source note in `csrc/segtiles.cu`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np
import torch

from megba_tpu_torch.ops import kernels as _kernels

if TYPE_CHECKING:
    from megba_tpu_torch.ops.fused import FusedPlan

# (od, d) pairs the CUDA kernels are instantiated for: the BAL camera
# (9) and point (3) blocks with 2-row residuals.
SUPPORTED_BLOCKS = ((2, 9), (2, 3))
# Row counts F the plain segment reduce / expand kernels are built for.
SUPPORTED_WIDTHS = (9, 3)

# A side whose mean segment length is below this many edges reduces with
# one thread per segment (points: ~5 edges each); longer segments get one
# thread block each (cameras: thousands of edges each).
PER_THREAD_MAX_MEAN = 64


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


@dataclasses.dataclass(frozen=True)
class SegPlan:
    """The device half of one side's plan."""

    seg: torch.Tensor  # [n] int32 segment id per slot (sorted)
    seg_ptr: torch.Tensor  # [nS + 1] int64
    num_segments: int
    # Slot in the OTHER order holding this slot's edge (cross permute).
    inv: torch.Tensor  # [n] int64

    @property
    def n_slots(self) -> int:
        return self.seg.shape[0]

    @property
    def per_thread(self) -> bool:
        return self.n_slots < PER_THREAD_MAX_MEAN * max(self.num_segments, 1)


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
    """Move one side's host plan to `device`; `inv` is its cross permute."""
    return SegPlan(
        seg=torch.from_numpy(plan.seg).to(device),
        seg_ptr=torch.from_numpy(plan.seg_ptr).to(device),
        num_segments=plan.num_segments,
        inv=torch.from_numpy(inv).to(device))


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


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the reference the kernels are held to)
# ---------------------------------------------------------------------------


def _segment_sum(rows: torch.Tensor, plan: SegPlan) -> torch.Tensor:
    out = torch.zeros((rows.shape[0], plan.num_segments), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(1, plan.seg, rows)


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


def coupling_expand_plain(table: torch.Tensor, J: torch.Tensor,
                          plan: SegPlan, d: int) -> torch.Tensor:
    """[od, n]: u[o] = sum_a J[o*d+a] * table[a, seg]."""
    od = J.shape[0] // d
    pe = table.index_select(1, plan.seg)
    return torch.stack([
        sum(J[o * d + a] * pe[a] for a in range(d)) for o in range(od)])


def coupling_reduce_plain(J: torch.Tensor, u: torch.Tensor, plan: SegPlan,
                          d: int) -> torch.Tensor:
    """[d, nS]: out[b, s] = sum_{e in s} sum_o J[o*d+b, e] * u[o, e]."""
    od = u.shape[0]
    te = torch.stack([
        sum(J[o * d + b] * u[o] for o in range(od)) for b in range(d)])
    return _segment_sum(te, plan)


def seg_reduce_plain(data: torch.Tensor, plan: SegPlan) -> torch.Tensor:
    """[F, nS]: out[:, s] = the sum of data's slots in segment s."""
    return _segment_sum(data, plan)


def seg_expand_plain(table: torch.Tensor, plan: SegPlan) -> torch.Tensor:
    """[F, n]: out[:, e] = table[:, seg[e]]."""
    return table.index_select(1, plan.seg)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "megba_jtj_grad_reduce": (
        ctypes.c_int, [_I, _I, _I, _P, _P, _P, _P, _L, _L, _I, _P]),
    "megba_coupling_expand": (
        ctypes.c_int, [_I, _I, _I, _P, _P, _P, _P, _L, _L, _P]),
    "megba_coupling_reduce": (
        ctypes.c_int, [_I, _I, _I, _P, _P, _P, _P, _L, _L, _I, _P]),
    "megba_seg_reduce": (ctypes.c_int, [_I, _I, _P, _P, _P, _L, _L, _I, _P]),
    "megba_seg_expand": (ctypes.c_int, [_I, _I, _P, _P, _P, _L, _L, _P]),
    "megba_error_string": (ctypes.c_char_p, [_I]),
}
KERNEL_SOURCES = ("segtiles",)


def _lib() -> ctypes.CDLL:
    return _kernels.load_library("segtiles", _SIGNATURES)


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


def check_plan(name: str, plan: SegPlan, dev: torch.device) -> None:
    """The plan's CSR arrays must be contiguous and on the operands'
    device, with nS + 1 offsets."""
    for k, t, dt in (("plan.seg", plan.seg, torch.int32),
                     ("plan.seg_ptr", plan.seg_ptr, torch.int64)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"{name}: {k} must be a contiguous {dt} tensor on {dev}")
    if plan.seg_ptr.shape != (plan.num_segments + 1,):
        raise ValueError(f"{name}: plan.seg_ptr has shape "
                         f"{tuple(plan.seg_ptr.shape)}, expected "
                         f"({plan.num_segments + 1},)")


def _check(name: str, shape, supported: tuple, plan: SegPlan,
           **tensors: torch.Tensor) -> torch.device:
    """Validate the operands on either device, and what the CUDA kernel
    does not check itself; raise on anything it does not take.  `shape`
    is the block shape the call needs (an (od, d) pair or a row count F),
    `supported` those built."""
    dev = check_operands(name, **tensors)
    if dev.type == "cuda" and shape not in supported:
        raise NotImplementedError(
            f"{name}: no CUDA kernel for shape {shape} (built for "
            f"{supported})")
    check_plan(name, plan, dev)
    return dev


def _raise_on(code: int, name: str) -> None:
    _kernels.raise_on(_lib(), code, name)


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
    dev = _check("jtj_grad_reduce", (od, d), SUPPORTED_BLOCKS, plan,
                 J=J, r=r)
    if dev.type == "cpu":
        return jtj_grad_reduce_plain(J, r, plan)
    out = torch.empty((d * d + d, plan.num_segments), dtype=J.dtype,
                      device=dev)
    with torch.cuda.device(dev):
        code = _lib().megba_jtj_grad_reduce(
            int(J.dtype == torch.float64), od, d, J.data_ptr(),
            r.data_ptr(), plan.seg_ptr.data_ptr(), out.data_ptr(), n,
            plan.num_segments, int(plan.per_thread),
            _kernels.current_stream(dev))
    _raise_on(code, "jtj_grad_reduce")
    jtj_grad_reduce.launches += 1
    return out[: d * d], out[d * d:]


def coupling_expand(table: torch.Tensor, J: torch.Tensor, plan: SegPlan,
                    d: int) -> torch.Tensor:
    """u[o] = sum_a J[o*d+a] * table[a, seg] -> [od, n] rows.

    The fused (gather + J.x) half of a coupling product: J [od*d, n] in
    plan slot order, table [d, nS].
    """
    od = J.shape[0] // d
    n = J.shape[1]
    if J.shape[0] != od * d or table.shape != (d, plan.num_segments) \
            or plan.n_slots != n:
        raise ValueError(
            f"coupling_expand: table {tuple(table.shape)}, J "
            f"{tuple(J.shape)}, d={d} and {plan.n_slots} plan slots "
            "disagree")
    dev = _check("coupling_expand", (od, d), SUPPORTED_BLOCKS, plan,
                 table=table, J=J)
    if dev.type == "cpu":
        return coupling_expand_plain(table, J, plan, d)
    u = torch.empty((od, n), dtype=J.dtype, device=dev)
    with torch.cuda.device(dev):
        code = _lib().megba_coupling_expand(
            int(J.dtype == torch.float64), od, d, table.data_ptr(),
            J.data_ptr(), plan.seg.data_ptr(), u.data_ptr(), n,
            plan.num_segments, _kernels.current_stream(dev))
    _raise_on(code, "coupling_expand")
    coupling_expand.launches += 1
    return u


def coupling_reduce(J: torch.Tensor, u: torch.Tensor, plan: SegPlan,
                    d: int) -> torch.Tensor:
    """out[b, s] = sum_{e in s} sum_o J[o*d+b, e] * u[o, e] -> [d, nS].

    The fused (J^T.u + segment reduce) half of a coupling product.
    """
    od = u.shape[0]
    n = u.shape[1]
    if J.shape != (od * d, n) or plan.n_slots != n:
        raise ValueError(
            f"coupling_reduce: J {tuple(J.shape)}, u {tuple(u.shape)}, "
            f"d={d} and {plan.n_slots} plan slots disagree")
    dev = _check("coupling_reduce", (od, d), SUPPORTED_BLOCKS, plan,
                 J=J, u=u)
    if dev.type == "cpu":
        return coupling_reduce_plain(J, u, plan, d)
    out = torch.empty((d, plan.num_segments), dtype=J.dtype, device=dev)
    with torch.cuda.device(dev):
        code = _lib().megba_coupling_reduce(
            int(J.dtype == torch.float64), od, d, J.data_ptr(), u.data_ptr(),
            plan.seg_ptr.data_ptr(), out.data_ptr(), n, plan.num_segments,
            int(plan.per_thread), _kernels.current_stream(dev))
    _raise_on(code, "coupling_reduce")
    coupling_reduce.launches += 1
    return out


def seg_reduce(data: torch.Tensor, plan: SegPlan) -> torch.Tensor:
    """Segment sums of plan-ordered rows: data [F, n] -> [F, nS], where
    out[:, s] sums the slots of segment s (an empty segment sums to 0)."""
    F, n = data.shape
    if plan.n_slots != n:
        raise ValueError(f"seg_reduce: data {tuple(data.shape)} and "
                         f"{plan.n_slots} plan slots disagree")
    dev = _check("seg_reduce", F, SUPPORTED_WIDTHS, plan, data=data)
    if dev.type == "cpu":
        return seg_reduce_plain(data, plan)
    out = torch.empty((F, plan.num_segments), dtype=data.dtype, device=dev)
    with torch.cuda.device(dev):
        code = _lib().megba_seg_reduce(
            int(data.dtype == torch.float64), F, data.data_ptr(),
            plan.seg_ptr.data_ptr(), out.data_ptr(), n, plan.num_segments,
            int(plan.per_thread), _kernels.current_stream(dev))
    _raise_on(code, "seg_reduce")
    seg_reduce.launches += 1
    return out


def seg_expand(table: torch.Tensor, plan: SegPlan) -> torch.Tensor:
    """Gather of segment rows to plan-ordered slots: table [F, nS] ->
    [F, n], out[:, e] = table[:, seg[e]]."""
    F = table.shape[0]
    if table.shape != (F, plan.num_segments):
        raise ValueError(f"seg_expand: table {tuple(table.shape)} and "
                         f"{plan.num_segments} plan segments disagree")
    dev = _check("seg_expand", F, SUPPORTED_WIDTHS, plan, table=table)
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
    seg_expand.launches += 1
    return out


KERNELS = (jtj_grad_reduce, coupling_expand, coupling_reduce, seg_reduce,
           seg_expand)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}

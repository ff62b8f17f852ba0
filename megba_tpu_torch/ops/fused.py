"""Fused explicit-Schur coupling product and block-diagonal M^-1 apply.

Counterpart of `megba_tpu/ops/fused.py` on the explicit-Schur path with
`SolverOption(fused_kernels=True)`: one gather -> contract -> scatter
kernel per coupling direction (`fused_coupling_apply`, the TPU's
`_fused_w_kernel`), and the block-Jacobi apply as one kernel pass
(`fused_block_diag_apply`, the TPU's `_block_diag_kernel`).

The TPU kernels needed a bucket plan (`build_fused_plan`): both one-hots
had to be block-sized, so every edge tile lived inside one (input block,
output block) bucket, padded to whole tiles.  The CUDA kernel has no
one-hot: it walks the output side's CSR segments of the dual plans
(ops/segtiles.py) and gathers each slot's input vertex by index.  So a
direction's plan (`FusedPlan`) is the output side's `SegPlan` plus one
int32 array, the input vertex of each slot in that order.  The contract
is the TPU kernel's: `out[:, o]` is the sum over the edges with output
vertex o of the contracted W_e . table[:, in(e)].

  cam -> pt: W rows in POINT-slot order (permuted once per PCG solve,
             solver/pcg.py), input = the camera of each point slot,
             W read input-major (`w_in_major=True`);
  pt -> cam: W rows in the canonical camera-slot order, input = the
             point of each camera slot, W read output-major.

W keeps the JAX layout: row a*pd + b holds (Jc^T Jp)[a, b] of each
edge, a the camera dimension and b the point dimension.

Each kernel has a plain PyTorch version (`*_plain`) in this module.  The
wrapper takes it only for tensors on the CPU; for CUDA tensors it
launches the kernel (`csrc/fused.cu`) or raises, and adds one to its
`launches` count per launch.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from megba_tpu_torch.ops import kernels as _kernels
from megba_tpu_torch.ops import segtiles
from megba_tpu_torch.ops.segtiles import DualPlans, SegPlan

# (d_in, d_out, w_in_major) the CUDA coupling kernel is built for: the
# BAL camera (9) and point (3) blocks, one entry per direction.
SUPPORTED_DIRECTIONS = ((9, 3, True), (3, 9, False))
# Block size the CUDA block-diagonal apply is built for (the camera).
SUPPORTED_BLOCK_DIAG = (9,)


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """One fused coupling direction over the output side's slot order."""

    in_idx: torch.Tensor  # [n] int32 input vertex of each output-order slot
    out: SegPlan  # the output side's CSR plan
    num_in: int  # input vertices (columns of the gathered table)


def with_fused_plans(plans: DualPlans) -> DualPlans:
    """Attach both fused directions to the dual plans (once per solve
    problem): the camera of each point slot and the point of each camera
    slot, gathered from the plans' own segment ids."""
    cam, pt = plans.cam, plans.pt
    to_pt = FusedPlan(in_idx=cam.seg.index_select(0, pt.inv).contiguous(),
                      out=pt, num_in=cam.num_segments)
    to_cam = FusedPlan(in_idx=pt.seg.index_select(0, cam.inv).contiguous(),
                       out=cam, num_in=pt.num_segments)
    return dataclasses.replace(plans, fused_to_pt=to_pt, fused_to_cam=to_cam)


def _w_row(a: int, b: int, d_in: int, d_out: int, w_in_major: bool) -> int:
    """W row of input dim a and output dim b."""
    return a * d_out + b if w_in_major else b * d_in + a


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the reference the kernels are held to)
# ---------------------------------------------------------------------------


def fused_coupling_apply_plain(W: torch.Tensor, table: torch.Tensor,
                               fplan: FusedPlan,
                               w_in_major: bool) -> torch.Tensor:
    """[d_out, num_out]: gather table[:, in(e)], contract with W_e,
    segment-sum onto the output vertices."""
    d_in = table.shape[0]
    d_out = W.shape[0] // d_in
    pe = table.index_select(1, fplan.in_idx)
    te = torch.stack([
        sum(W[_w_row(a, b, d_in, d_out, w_in_major)] * pe[a]
            for a in range(d_in))
        for b in range(d_out)])
    return segtiles.seg_reduce_plain(te, fplan.out)


def block_diag_rows(Minv: torch.Tensor) -> torch.Tensor:
    """[Nc, d, d] inverted block diagonal -> feature-major [d*d, Nc] rows
    (row i*d+j holds Minv[:, i, j]); laid out once per PCG solve."""
    d = Minv.shape[-1]
    return Minv.permute(1, 2, 0).reshape(d * d, Minv.shape[0]).contiguous()


def fused_block_diag_apply_plain(Hrows: torch.Tensor,
                                 x: torch.Tensor) -> torch.Tensor:
    """[d, Nc]: out[i, c] = sum_j Hrows[i*d+j, c] * x[j, c]."""
    d = x.shape[0]
    return torch.stack([sum(Hrows[i * d + j] * x[j] for j in range(d))
                        for i in range(d)])


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "megba_fused_coupling_apply": (
        ctypes.c_int, [_I, _I, _I, _I, _P, _P, _P, _P, _P, _L, _L, _L, _I,
                       _P]),
    "megba_block_diag_apply": (ctypes.c_int, [_I, _I, _P, _P, _P, _L, _P]),
    "megba_error_string": (ctypes.c_char_p, [_I]),
}
KERNEL_SOURCES = ("fused",)


def _lib() -> ctypes.CDLL:
    return _kernels.load_library("fused", _SIGNATURES)


def fused_coupling_apply(W: torch.Tensor, table: torch.Tensor,
                         fplan: FusedPlan, w_in_major: bool) -> torch.Tensor:
    """One explicit-Schur coupling direction: table [d_in, num_in] ->
    [d_out, num_out], out[:, o] = sum over the slots e of output vertex o
    of W_e . table[:, in(e)].  `W` [d_in*d_out, n] must be in the output
    side's slot order (`fplan.out`)."""
    d_in = table.shape[0]
    d_out = W.shape[0] // d_in
    n = fplan.out.n_slots
    if (W.shape != (d_in * d_out, n) or table.shape != (d_in, fplan.num_in)
            or fplan.in_idx.shape != (n,)):
        raise ValueError(
            f"fused_coupling_apply: W {tuple(W.shape)}, table "
            f"{tuple(table.shape)}, {tuple(fplan.in_idx.shape)} input ids "
            f"and {n} plan slots disagree")
    dev = segtiles.check_operands("fused_coupling_apply", W=W, table=table)
    shape = (d_in, d_out, bool(w_in_major))
    if dev.type == "cuda" and shape not in SUPPORTED_DIRECTIONS:
        raise NotImplementedError(
            f"fused_coupling_apply: no CUDA kernel for (d_in, d_out, "
            f"w_in_major) = {shape} (built for {SUPPORTED_DIRECTIONS})")
    segtiles.check_plan("fused_coupling_apply", fplan.out, dev)
    t = fplan.in_idx
    if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError("fused_coupling_apply: fplan.in_idx must be a "
                         f"contiguous torch.int32 tensor on {dev}")
    if dev.type == "cpu":
        return fused_coupling_apply_plain(W, table, fplan, w_in_major)
    out = torch.empty((d_out, fplan.out.num_segments), dtype=W.dtype,
                      device=dev)
    with torch.cuda.device(dev):
        code = _lib().megba_fused_coupling_apply(
            int(W.dtype == torch.float64), d_in, d_out, int(w_in_major),
            W.data_ptr(), table.data_ptr(), t.data_ptr(),
            fplan.out.seg_ptr.data_ptr(), out.data_ptr(), n, fplan.num_in,
            fplan.out.num_segments, int(fplan.out.per_thread),
            _kernels.current_stream(dev))
    _kernels.raise_on(_lib(), code, "fused_coupling_apply")
    fused_coupling_apply.launches += 1
    return out


def fused_block_diag_apply(Hrows: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """Block-diagonal apply: Hrows [d*d, Nc] (`block_diag_rows`), x [d, Nc]
    -> [d, Nc], out[:, c] = M_c x[:, c]."""
    d, nc = x.shape
    if Hrows.shape != (d * d, nc):
        raise ValueError(f"fused_block_diag_apply: Hrows "
                         f"{tuple(Hrows.shape)} and x {tuple(x.shape)} "
                         "disagree")
    dev = segtiles.check_operands("fused_block_diag_apply", Hrows=Hrows, x=x)
    if dev.type == "cuda" and d not in SUPPORTED_BLOCK_DIAG:
        raise NotImplementedError(
            f"fused_block_diag_apply: no CUDA kernel for d={d} (built for "
            f"{SUPPORTED_BLOCK_DIAG})")
    if dev.type == "cpu":
        return fused_block_diag_apply_plain(Hrows, x)
    out = torch.empty((d, nc), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        code = _lib().megba_block_diag_apply(
            int(x.dtype == torch.float64), d, Hrows.data_ptr(), x.data_ptr(),
            out.data_ptr(), nc, _kernels.current_stream(dev))
    _kernels.raise_on(_lib(), code, "fused_block_diag_apply")
    fused_block_diag_apply.launches += 1
    return out


KERNELS = (fused_coupling_apply, fused_block_diag_apply)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}

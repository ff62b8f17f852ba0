"""Fused Schur coupling products and block-diagonal M^-1 apply.

Counterpart of `megba_tpu/ops/fused.py` on the Schur path with
`SolverOption(fused_kernels=True)`: one gather -> contract -> scatter
kernel per coupling direction, from the stored coupling rows W on the
explicit path (`fused_coupling_apply`, the TPU's `_fused_w_kernel`) or
from the stored Jacobian rows on the implicit path
(`fused_coupling_apply_implicit`, the TPU's `_fused_j_kernel`), and the
block-Jacobi apply as one kernel pass (`fused_block_diag_apply`, the
TPU's `_block_diag_kernel`).

The TPU kernels needed a bucket plan (`build_fused_plan`): both one-hots
had to be block-sized, so every edge tile lived inside one (input block,
output block) bucket, padded to whole tiles.  The CUDA kernel has no
one-hot: it walks the output side's CSR segments of the dual plans
(ops/segtiles.py) and gathers each slot's input vertex by index.  So a
direction's plan (`FusedPlan`) is the output side's `SegPlan` plus one
int32 array, the input vertex of each slot in that order.  The contract
is the TPU kernel's: `out[:, o]` is the sum over the edges with output
vertex o of the per-edge product applied to table[:, in(e)].

  cam -> pt: rows in POINT-slot order (Jc or W permuted once per PCG
             solve, solver/pcg.py; Jp is carried there), input = the
             camera of each point slot, W read input-major
             (`w_in_major=True`);
  pt -> cam: rows in the canonical camera-slot order (Jp permuted once
             per PCG solve), input = the point of each camera slot, W
             read output-major.

Where the output side's segments are short (`SegPlan.per_thread`: the
points, ~5 slots each), the kernel runs one block per tile of
`SLOT_TILE` consecutive slots, its lanes over the slots, and the plan
carries which output segments each tile owns (`segtiles.slot_tiles`,
computed once per plan, the output plan's own where it carries them);
a side of long segments runs a block per segment.

W keeps the JAX layout: row a*pd + b holds (Jc^T Jp)[a, b] of each
edge, a the camera dimension and b the point dimension.  The implicit
product reads Jin rows o*d_in + a and Jout rows o*d_out + b (od rows).

Shapes: the CUDA kernels are built for every (cd, pd, od) of
csrc/fused_shapes.cuh (the registered factor families' blocks), which
this module reads into `SUPPORTED_DIRECTIONS`, `SUPPORTED_IMPLICIT` and
`SUPPORTED_BLOCK_DIAG`.  Another shape up to `segtiles.MAX_BUILT_BLOCK`
(a Problem edge of the user's own widths) gets a library of its own,
built at first use; beyond it the wrappers raise `NotImplementedError`.

Precision (the JAX kernels' `_contract_rows` / `_acc_dtype`; the arms
of ops/kernels.ARMS): the table is float32 or float64 and the output has
the table's type.  The rows have the table's type, or are bfloat16
beside a float32 or (coupling applies only) float64 table.  With
bfloat16 rows, `bf16_operands=False` upcasts each row value before the
multiply (`mixed_precision_pcg`, at float32 or float64);
`bf16_operands=True` (float32 only) rounds the gathered vector to
bfloat16 and each product to bfloat16, then sums in float32
(`SolverOption.bf16`; the implicit product also rounds u).

The 2-D mesh's ring step (`fused_single_block_apply`, JAX
fused.py:592-626) runs kernels 8 and 7 with one input block, a rotating
point shard, and one output block, a camera tile: a `ring_step_plan` is
a `FusedPlan` over one bucket's entries (pt -> cam, `w_in_major=False`),
and the wrappers `fused_ring_step_apply` / `_implicit` launch the same
kernels under launch counts of their own.

Each kernel has a plain PyTorch version (`*_plain`) in this module.  The
wrapper takes it only for tensors on the CPU; for CUDA tensors it
launches the kernel (`csrc/fused.cu`) or raises, and adds one to its
`launches` count (and to its arm's, `arm_launches`) per launch.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from megba_tpu_torch.analysis import census
from megba_tpu_torch.ops import kernels as _kernels
from megba_tpu_torch.ops import segtiles
from megba_tpu_torch.ops.segtiles import (SLOT_TILE, DualPlans, SegPlan,
                                          contract, make_seg_plan, operand,
                                          slot_tiles)

# (cd, pd, od) of each registered factor family: the MEGBA_COUPLING lines
# of csrc/fused_shapes.cuh, the one list the CUDA dispatch expands too.
SUPPORTED_COUPLINGS = _kernels.listed_shapes("fused_shapes.cuh",
                                             "MEGBA_COUPLING")
# (d_in, d_out, w_in_major) the CUDA coupling kernel (8) is built for:
# cam -> pt input-major and pt -> cam output-major, per (cd, pd).
SUPPORTED_DIRECTIONS = tuple(dict.fromkeys(
    s for cd, pd, _ in SUPPORTED_COUPLINGS
    for s in ((cd, pd, True), (pd, cd, False))))
# (d_in, d_out, od) the CUDA implicit coupling kernel (7) is built for.
SUPPORTED_IMPLICIT = tuple(dict.fromkeys(
    s for cd, pd, od in SUPPORTED_COUPLINGS
    for s in ((cd, pd, od), (pd, cd, od))))
# Block sizes the CUDA block-diagonal apply (6) is built for: the cameras.
SUPPORTED_BLOCK_DIAG = tuple(dict.fromkeys(
    cd for cd, _, _ in SUPPORTED_COUPLINGS))


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """One fused coupling direction over the output side's slot order."""

    in_idx: torch.Tensor  # [n] int32 input vertex of each output-order slot
    out: SegPlan  # the output side's CSR plan
    num_in: int  # input vertices (columns of the gathered table)
    # [num_tiles + 1] int64: tile b owns the output segments
    # [tile_ptr[b], tile_ptr[b + 1]) (`slot_tiles`), read by the slot-tile
    # launch where `out.per_thread`.
    tile_ptr: torch.Tensor


def _fused_plan(in_idx: torch.Tensor, out: SegPlan,
                num_in: int) -> FusedPlan:
    tiles = out.tiles if out.tiles is not None else slot_tiles(out.seg_ptr)
    return FusedPlan(in_idx=in_idx.contiguous(), out=out, num_in=num_in,
                     tile_ptr=tiles)


def with_fused_plans(plans: DualPlans) -> DualPlans:
    """Attach both fused directions to the dual plans (once per solve
    problem): the camera of each point slot and the point of each camera
    slot, gathered from the plans' own segment ids, and each direction's
    slot tiles."""
    cam, pt = plans.cam, plans.pt
    to_pt = _fused_plan(cam.seg.index_select(0, pt.inv), pt,
                        cam.num_segments)
    to_cam = _fused_plan(pt.seg.index_select(0, cam.inv), cam,
                         pt.num_segments)
    return dataclasses.replace(plans, fused_to_pt=to_pt, fused_to_cam=to_cam)


def ring_step_plan(in_local, out_local, slots, num_in: int, num_out: int,
                   device) -> FusedPlan:
    """The fused plan of one 2-D ring step (JAX `fused_single_block_apply`,
    one input block and one output block): entry i reads input
    `in_local[i]` (a point of the rotating shard) and adds onto output
    `out_local[i]` (a camera of the tile, non-decreasing over the
    entries), from the rows of device-local slot `slots[i]` (the output
    plan's `inv`).  Host numpy in, tensors on `device` out."""
    out_local = np.asarray(out_local, np.int64)
    seg_ptr = np.zeros(num_out + 1, np.int64)
    np.cumsum(np.bincount(out_local, minlength=num_out), out=seg_ptr[1:])
    out = make_seg_plan(out_local, seg_ptr, num_out, slots, device)
    return _fused_plan(
        torch.from_numpy(np.asarray(in_local, np.int32)).to(device), out,
        num_in)


def _w_row(a: int, b: int, d_in: int, d_out: int, w_in_major: bool) -> int:
    """W row of input dim a and output dim b."""
    return a * d_out + b if w_in_major else b * d_in + a


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the reference the kernels are held to)
# ---------------------------------------------------------------------------


def fused_coupling_apply_plain(W: torch.Tensor, table: torch.Tensor,
                               fplan: FusedPlan, w_in_major: bool,
                               bf16_operands: bool = False) -> torch.Tensor:
    """[d_out, num_out]: gather table[:, in(e)], contract with W_e,
    segment-sum onto the output vertices."""
    d_in = table.shape[0]
    d_out = W.shape[0] // d_in
    pe = operand(table.index_select(1, fplan.in_idx), bf16_operands)
    te = torch.stack([
        contract([W[_w_row(a, b, d_in, d_out, w_in_major)]
                  for a in range(d_in)], pe, table.dtype, bf16_operands)
        for b in range(d_out)])
    return segtiles.seg_reduce_plain(te, fplan.out)


def fused_coupling_apply_implicit_plain(
        Jin: torch.Tensor, Jout: torch.Tensor, table: torch.Tensor,
        fplan: FusedPlan, bf16_operands: bool = False) -> torch.Tensor:
    """[d_out, num_out]: gather table[:, in(e)], u = Jin_e x, Jout_e^T u,
    segment-sum onto the output vertices."""
    d_in = table.shape[0]
    od = Jin.shape[0] // d_in
    d_out = Jout.shape[0] // od
    acc = table.dtype
    pe = operand(table.index_select(1, fplan.in_idx), bf16_operands)
    u = [operand(contract(Jin[o * d_in:(o + 1) * d_in], pe, acc,
                          bf16_operands), bf16_operands)
         for o in range(od)]
    te = torch.stack([
        contract([Jout[o * d_out + b] for o in range(od)], u, acc,
                 bf16_operands)
        for b in range(d_out)])
    return segtiles.seg_reduce_plain(te, fplan.out)


def block_diag_rows(Minv: torch.Tensor) -> torch.Tensor:
    """[Nc, d, d] inverted block diagonal -> feature-major [d*d, Nc] rows
    (row i*d+j holds Minv[:, i, j]); laid out once per PCG solve."""
    d = Minv.shape[-1]
    return Minv.permute(1, 2, 0).reshape(d * d, Minv.shape[0]).contiguous()


def fused_block_diag_apply_plain(Hrows: torch.Tensor, x: torch.Tensor,
                                 bf16_operands: bool = False) -> torch.Tensor:
    """[d, Nc]: out[i, c] = sum_j Hrows[i*d+j, c] * x[j, c]."""
    d = x.shape[0]
    xs = operand(x, bf16_operands)
    return torch.stack([contract(Hrows[i * d:(i + 1) * d], xs, x.dtype,
                                 bf16_operands)
                        for i in range(d)])


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "megba_fused_coupling_apply": (
        ctypes.c_int, [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _L, _L, _L,
                       _L, _I, _P]),
    "megba_fused_implicit_apply": (
        ctypes.c_int, [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _L, _L,
                       _L, _L, _I, _P]),
    "megba_block_diag_apply": (ctypes.c_int, [_I, _I, _P, _P, _P, _L, _P]),
    "megba_error_string": (ctypes.c_char_p, [_I]),
}
KERNEL_SOURCES = ("fused",)


def kernel_source(name: str) -> str:
    """The CUDA source (csrc/<source>.cu) of this module's kernel
    `name`."""
    return "fused"
# The block-diagonal apply has no mixed64 arm: the mixed rungs apply M^-1
# in the table's dtype.
_BLOCK_DIAG_ARMS = _kernels.ALL_ARMS - {"mixed64"}


def _lib(key=None) -> ctypes.CDLL:
    """The library of the listed shapes (`key` None), or that of one
    other (cd, pd, od) built at first use (pd = 0: kernel 6 alone; od = 0:
    no kernel 7)."""
    if key is None:
        return _kernels.load_library("fused", _SIGNATURES)
    cd, pd, od = key
    return _kernels.load_library(
        "fused", _SIGNATURES, defines={"MEGBA_ONE_FUSED_CD": cd,
                                       "MEGBA_ONE_FUSED_PD": pd,
                                       "MEGBA_ONE_FUSED_OD": od})


def _shape_lib(name: str, shape: tuple, listed: tuple, key: tuple,
               widths: tuple, od: int = 1) -> ctypes.CDLL:
    """The library that holds kernel `name` at `shape`: the listed one, or
    the one-shape library `key` built at first use.  Beyond segtiles'
    cap on kernels 1-3, `MAX_BUILT_BLOCK` (block widths `widths`,
    residual rows `od`), raise the typed refusal; nothing falls back to
    the plain version.  At the cap's d = 16 a pt -> cam slot tile stages
    16 sums of 256 slots (32 KB at f64), within the 48 KB of static
    shared memory."""
    if shape in listed:
        return _lib()
    cap = segtiles.MAX_BUILT_BLOCK
    if not (1 <= od <= cap[0] and all(1 <= w <= cap[1] for w in widths)):
        raise NotImplementedError(
            f"{name}: no CUDA kernel for shape {shape}: "
            f"csrc/fused_shapes.cuh lists {listed}, and a shape outside it "
            f"is built at first use up to (od, d) <= {cap}")
    return _lib(key)


def _check_plan(name: str, fplan: FusedPlan, n: int,
                dev: torch.device) -> None:
    segtiles.check_plan(name, fplan.out, dev)
    t = fplan.in_idx
    if t.shape != (n,):
        raise ValueError(f"{name}: {tuple(t.shape)} input ids and {n} plan "
                         "slots disagree")
    if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: fplan.in_idx must be a contiguous "
                         f"torch.int32 tensor on {dev}")
    # Like seg_ptr's, tile_ptr's values are not read here: that would wait
    # for the device on every launch.  Its length must fit a tiling of n
    # slots by tiles of at most SLOT_TILE.
    tiles = fplan.tile_ptr
    if (tiles.dim() != 1 or not
            max(1, -(-n // SLOT_TILE)) <= tiles.shape[0] - 1 <= max(1, n)):
        raise ValueError(f"{name}: fplan.tile_ptr {tuple(tiles.shape)} does "
                         f"not tile {n} slots by at most {SLOT_TILE}")
    if (tiles.device != dev or tiles.dtype != torch.int64
            or not tiles.is_contiguous()):
        raise ValueError(f"{name}: fplan.tile_ptr must be a contiguous "
                         f"torch.int64 tensor on {dev}")


def _plan_args(fplan: FusedPlan, out: torch.Tensor, n: int) -> tuple:
    """The C launchers' arguments from `in_idx` to `per_thread`."""
    return (fplan.in_idx.data_ptr(), fplan.out.seg_ptr.data_ptr(),
            fplan.tile_ptr.data_ptr(), out.data_ptr(), n, fplan.num_in,
            fplan.out.num_segments, fplan.tile_ptr.shape[0] - 1,
            int(fplan.out.per_thread))


def _coupling_apply(counter, name: str, W: torch.Tensor,
                    table: torch.Tensor, fplan: FusedPlan, w_in_major: bool,
                    bf16_operands: bool) -> torch.Tensor:
    """Check and launch kernel 8 (`megba_fused_coupling_apply`) for the
    wrapper `counter`, or run its plain version on the CPU."""
    d_in = table.shape[0]
    d_out = W.shape[0] // d_in
    n = fplan.out.n_slots
    if W.shape != (d_in * d_out, n) or table.shape != (d_in, fplan.num_in):
        raise ValueError(
            f"{name}: W {tuple(W.shape)}, table "
            f"{tuple(table.shape)} and {n} plan slots disagree")
    arm_code, arm = _kernels.check_arm(name, table, bf16_operands, W=W)
    dev = table.device
    _check_plan(name, fplan, n, dev)
    census.kernel_call(counter.__name__, arm)
    if dev.type == "cpu":
        return fused_coupling_apply_plain(W, table, fplan, w_in_major,
                                          bf16_operands)
    cd, pd = (d_in, d_out) if w_in_major else (d_out, d_in)
    lib = _shape_lib(name, (d_in, d_out, bool(w_in_major)),
                     SUPPORTED_DIRECTIONS, (cd, pd, 0), (cd, pd))
    out = torch.empty((d_out, fplan.out.num_segments), dtype=table.dtype,
                      device=dev)
    with torch.cuda.device(dev):
        code = lib.megba_fused_coupling_apply(
            arm_code, d_in, d_out, int(w_in_major), W.data_ptr(),
            table.data_ptr(), *_plan_args(fplan, out, n),
            _kernels.current_stream(dev))
    _kernels.raise_on(lib, code, name)
    _kernels.count_launch(counter, arm, (d_in, d_out))
    return out


def fused_coupling_apply(W: torch.Tensor, table: torch.Tensor,
                         fplan: FusedPlan, w_in_major: bool,
                         bf16_operands: bool = False) -> torch.Tensor:
    """One explicit-Schur coupling direction: table [d_in, num_in] ->
    [d_out, num_out], out[:, o] = sum over the slots e of output vertex o
    of W_e . table[:, in(e)].  `W` [d_in*d_out, n] must be in the output
    side's slot order (`fplan.out`)."""
    return _coupling_apply(fused_coupling_apply, "fused_coupling_apply", W,
                           table, fplan, w_in_major, bf16_operands)


def _implicit_apply(counter, name: str, Jin: torch.Tensor,
                    Jout: torch.Tensor, table: torch.Tensor,
                    fplan: FusedPlan, bf16_operands: bool) -> torch.Tensor:
    """Check and launch kernel 7 (`megba_fused_implicit_apply`) for the
    wrapper `counter`, or run its plain version on the CPU."""
    d_in = table.shape[0]
    od = Jin.shape[0] // d_in
    d_out = Jout.shape[0] // max(od, 1)
    n = fplan.out.n_slots
    if (od < 1 or Jin.shape != (od * d_in, n)
            or Jout.shape != (od * d_out, n)
            or table.shape != (d_in, fplan.num_in)):
        raise ValueError(
            f"{name}: Jin {tuple(Jin.shape)}, Jout "
            f"{tuple(Jout.shape)}, table {tuple(table.shape)} and {n} plan "
            "slots disagree")
    arm_code, arm = _kernels.check_arm(name, table, bf16_operands, Jin=Jin,
                                       Jout=Jout)
    dev = table.device
    _check_plan(name, fplan, n, dev)
    census.kernel_call(counter.__name__, arm)
    if dev.type == "cpu":
        return fused_coupling_apply_implicit_plain(Jin, Jout, table, fplan,
                                                   bf16_operands)
    # A one-shape library holds both directions: one key for the two.
    shape = (d_in, d_out, od)
    lib = _shape_lib(name, shape, SUPPORTED_IMPLICIT,
                     (max(d_in, d_out), min(d_in, d_out), od),
                     (d_in, d_out), od)
    out = torch.empty((d_out, fplan.out.num_segments), dtype=table.dtype,
                      device=dev)
    with torch.cuda.device(dev):
        code = lib.megba_fused_implicit_apply(
            arm_code, d_in, d_out, od, Jin.data_ptr(), Jout.data_ptr(),
            table.data_ptr(), *_plan_args(fplan, out, n),
            _kernels.current_stream(dev))
    _kernels.raise_on(lib, code, name)
    _kernels.count_launch(counter, arm, shape)
    return out


def fused_coupling_apply_implicit(Jin: torch.Tensor, Jout: torch.Tensor,
                                  table: torch.Tensor, fplan: FusedPlan,
                                  bf16_operands: bool = False
                                  ) -> torch.Tensor:
    """One implicit-Schur coupling direction: table [d_in, num_in] ->
    [d_out, num_out], out[:, o] = sum over the slots e of output vertex o
    of Jout_e^T (Jin_e . table[:, in(e)]).  `Jin` [od*d_in, n] and
    `Jout` [od*d_out, n] must be in the output side's slot order
    (`fplan.out`)."""
    return _implicit_apply(fused_coupling_apply_implicit,
                           "fused_coupling_apply_implicit", Jin, Jout, table,
                           fplan, bf16_operands)


def fused_ring_step_apply(W: torch.Tensor, table: torch.Tensor,
                          fplan: FusedPlan, w_in_major: bool = False,
                          bf16_operands: bool = False) -> torch.Tensor:
    """Kernel 8 in its ring-step call form (`fused_single_block_apply`
    with W rows): the same kernel as `fused_coupling_apply` over a
    `ring_step_plan`, its launches counted apart."""
    return _coupling_apply(fused_ring_step_apply, "fused_ring_step_apply",
                           W, table, fplan, w_in_major, bf16_operands)


def fused_ring_step_apply_implicit(Jin: torch.Tensor, Jout: torch.Tensor,
                                   table: torch.Tensor, fplan: FusedPlan,
                                   bf16_operands: bool = False
                                   ) -> torch.Tensor:
    """Kernel 7 in its ring-step call form (`fused_single_block_apply`
    with Jacobian rows), its launches counted apart."""
    return _implicit_apply(fused_ring_step_apply_implicit,
                           "fused_ring_step_apply_implicit", Jin, Jout,
                           table, fplan, bf16_operands)


def fused_ring_step_apply_plain(W: torch.Tensor, table: torch.Tensor,
                                fplan: FusedPlan, w_in_major: bool = False,
                                bf16_operands: bool = False) -> torch.Tensor:
    """The plain version of `fused_ring_step_apply`."""
    return fused_coupling_apply_plain(W, table, fplan, w_in_major,
                                      bf16_operands)


def fused_ring_step_apply_implicit_plain(
        Jin: torch.Tensor, Jout: torch.Tensor, table: torch.Tensor,
        fplan: FusedPlan, bf16_operands: bool = False) -> torch.Tensor:
    """The plain version of `fused_ring_step_apply_implicit`."""
    return fused_coupling_apply_implicit_plain(Jin, Jout, table, fplan,
                                               bf16_operands)


def fused_single_block_apply(rows: torch.Tensor, table: torch.Tensor,
                             fplan: FusedPlan, w_in_major: bool = False,
                             rows_out=None,
                             bf16_operands: bool = False) -> torch.Tensor:
    """The 2-D mesh's ring-step contraction (JAX fused.py:592-626): one
    input block (the rotating point shard `table` [d_in, Sp]) and one
    output block (the camera tile, `fplan.out.num_segments` cameras).
    `rows` are in the plan's entry order; with `rows_out` it is the
    implicit two-stage product Jout^T (Jin x), rows = Jin."""
    if rows_out is None:
        return fused_ring_step_apply(rows, table, fplan, w_in_major,
                                     bf16_operands)
    return fused_ring_step_apply_implicit(rows, rows_out, table, fplan,
                                          bf16_operands)


def fused_block_diag_apply(Hrows: torch.Tensor, x: torch.Tensor,
                           bf16_operands: bool = False) -> torch.Tensor:
    """Block-diagonal apply: Hrows [d*d, Nc] (`block_diag_rows`), x [d, Nc]
    -> [d, Nc], out[:, c] = M_c x[:, c]."""
    d, nc = x.shape
    if Hrows.shape != (d * d, nc):
        raise ValueError(f"fused_block_diag_apply: Hrows "
                         f"{tuple(Hrows.shape)} and x {tuple(x.shape)} "
                         "disagree")
    arm_code, arm = _kernels.check_arm("fused_block_diag_apply", x,
                                       bf16_operands, _BLOCK_DIAG_ARMS,
                                       Hrows=Hrows)
    dev = x.device
    census.kernel_call("fused_block_diag_apply", arm)
    if dev.type == "cpu":
        return fused_block_diag_apply_plain(Hrows, x, bf16_operands)
    lib = _shape_lib("fused_block_diag_apply", d, SUPPORTED_BLOCK_DIAG,
                     (d, 0, 0), (d,))
    out = torch.empty((d, nc), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        code = lib.megba_block_diag_apply(
            arm_code, d, Hrows.data_ptr(), x.data_ptr(), out.data_ptr(), nc,
            _kernels.current_stream(dev))
    _kernels.raise_on(lib, code, "fused_block_diag_apply")
    _kernels.count_launch(fused_block_diag_apply, arm, (d,))
    return out


KERNELS = (fused_coupling_apply, fused_coupling_apply_implicit,
           fused_block_diag_apply, fused_ring_step_apply,
           fused_ring_step_apply_implicit)


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
    """Launches per kernel and shape: {"name(d_in,d_out)": count} for
    kernel 8, {"name(d_in,d_out,od)": count} for 7, {"name(d)": count}
    for 6."""
    return _kernels.shape_counts(KERNELS)

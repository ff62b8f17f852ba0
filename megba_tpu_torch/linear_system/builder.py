"""Block-structured Schur linear system assembly (feature-major, PyTorch).

Counterpart of `megba_tpu/linear_system/builder.py` on its plan path:
both block diagonals and the gradient come from the fused
`ops.segtiles.jtj_grad_reduce` kernel, one call per vertex kind.

  Hpp [num_cameras, cd, cd]   block-diagonal camera Hessian
  Hll [pd*pd, num_points]     block-diagonal point Hessian, row form
  g_cam [cd, num_cameras], g_pt [pd, num_points]   gradient -J^T r
  W [cd*pd, nE]               EXPLICIT only: per-edge coupling blocks

The camera-point coupling is IMPLICIT by default: it is recomputed from
the stored Jacobians at every matvec (solver/pcg.py).  EXPLICIT stores
the per-edge blocks W_e = Jc_e^T Jp_e once per linearisation, in
camera-slot order (row a*pd+b, `core.fm.coupling_rows`), and every
matvec contracts them.

The system is built over a mesh (`plans` a `parallel.mesh.ShardedPlans`;
one device is a mesh of one shard, `parallel.mesh.one_shard`): the edge
arrays are tuples of per-shard tensors, each shard reduces its own edges
over all vertices, and the four row blocks are summed across the shards
(the psum at JAX builder.py:226) on the first shard's device before the
fixed and edge-less vertices are patched; W stays per shard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from megba_tpu_torch.common import ComputeKind
from megba_tpu_torch.core.fm import coupling_rows
from megba_tpu_torch.ops.residuals import apply_sqrt_info
from megba_tpu_torch.ops import segtiles
from megba_tpu_torch.ops.segtiles import DualPlans
from megba_tpu_torch.parallel.collectives import for_shards, psum
from megba_tpu_torch.parallel.mesh import ShardedPlans


@dataclasses.dataclass
class SchurSystem:
    """The assembled (undamped) normal equations in Schur block form."""

    Hpp: torch.Tensor  # [Nc, cd, cd]
    Hll: torch.Tensor  # [pd*pd, Np] rows
    g_cam: torch.Tensor  # [cd, Nc]
    g_pt: torch.Tensor  # [pd, Np]
    # EXPLICIT: per shard, the [cd*pd, n_k] rows in cam-slot order.
    W: Optional[Tuple[torch.Tensor, ...]] = None


def weight_system_inputs(
    r: torch.Tensor,
    Jc: torch.Tensor,
    Jp: torch.Tensor,
    cam_idx: torch.Tensor,
    pt_idx: torch.Tensor,
    mask: torch.Tensor,
    sqrt_info: Optional[torch.Tensor] = None,
    cam_fixed: Optional[torch.Tensor] = None,
    pt_fixed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply sqrt-information, the edge mask and fixed-vertex masks ONCE.

    Feature-major: r [od, nE], Jc [od*cd, nE], Jp [od*pd, nE], mask [nE].
    The mask is 0/1, so a masked edge contributes exactly nothing to H,
    g and the cost; a fixed vertex's Jacobian rows are zeroed.
    """
    r, Jc, Jp = apply_sqrt_info(r, Jc, Jp, sqrt_info)
    m = mask[None, :]
    r = r * m
    Jc = Jc * m
    Jp = Jp * m
    if cam_fixed is not None:
        Jc = torch.where(cam_fixed[cam_idx][None, :], torch.zeros_like(Jc), Jc)
    if pt_fixed is not None:
        Jp = torch.where(pt_fixed[pt_idx][None, :], torch.zeros_like(Jp), Jp)
    return r, Jc, Jp


def build_schur_partials(r: torch.Tensor, Jc: torch.Tensor,
                         Jp: torch.Tensor, plans: DualPlans):
    """One shard's sums before any patching: the
    Hpp rows [cd*cd, Nc], g_cam [cd, Nc], the Hll rows [pd*pd, Np] and
    g_pt [pd, Np], through `jtj_grad_reduce` on each side."""
    hpp_rows, g_cam = segtiles.jtj_grad_reduce(Jc, r, plans.cam)
    Hll, g_pt = segtiles.jtj_grad_reduce(Jp, plans.to_pt(r), plans.pt)
    return hpp_rows, g_cam, Hll, g_pt


def build_schur_system(
    r: Tuple[torch.Tensor, ...],
    Jc: Tuple[torch.Tensor, ...],
    Jp: Tuple[torch.Tensor, ...],
    plans: ShardedPlans,
    num_cameras: int,
    num_points: int,
    cam_fixed: Optional[torch.Tensor] = None,
    pt_fixed: Optional[torch.Tensor] = None,
    compute_kind: ComputeKind = ComputeKind.IMPLICIT,
) -> SchurSystem:
    """Assemble the Schur-form normal equations from per-edge Jacobians.

    Inputs are per-shard tuples, already weighted by
    `weight_system_inputs`: `r`/`Jc` in cam-slot order, `Jp` in pt-slot
    order.  Fixed vertices get an identity Hessian block and
    zero gradient; vertices with no edge get an identity block (their
    gradient is already zero), so both updates are exactly zero and the
    damped blocks stay invertible.  EXPLICIT also stores the coupling
    rows W (from the same weighted, masked rows, Jp brought to cam-slot
    order first).
    """
    home = plans.mesh.home  # shard 0, or this process's first
    od = r[home].shape[0]
    cd = Jc[home].shape[0] // od
    pd = Jp[home].shape[0] // od
    dtype, device = r[home].dtype, r[home].device

    parts = for_shards(build_schur_partials, r, Jc, Jp, plans.shards)
    hpp_rows, g_cam, Hll, g_pt = (psum([p[i] for p in parts], device)
                                  for i in range(4))

    # Camera blocks to batched [Nc, cd, cd].
    Hpp = torch.movedim(hpp_rows.reshape(cd, cd, num_cameras), -1, 0)

    eye_c = torch.eye(cd, dtype=dtype, device=device)
    eye_p_rows = torch.tensor(
        [1.0 if i % (pd + 1) == 0 else 0.0 for i in range(pd * pd)],
        dtype=dtype, device=device)
    if cam_fixed is not None:
        Hpp = torch.where(cam_fixed[:, None, None], eye_c, Hpp)
        g_cam = torch.where(cam_fixed[None, :], torch.zeros_like(g_cam), g_cam)
    if pt_fixed is not None:
        Hll = torch.where(pt_fixed[None, :], eye_p_rows[:, None], Hll)
        g_pt = torch.where(pt_fixed[None, :], torch.zeros_like(g_pt), g_pt)

    # J^T J is PSD, so a zero trace marks exactly the edge-less blocks.
    empty_c = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1) == 0.0
    Hpp = torch.where(empty_c[:, None, None], eye_c, Hpp)
    tr_rows = [i for i in range(pd * pd) if i % (pd + 1) == 0]
    empty_p = sum(Hll[i] for i in tr_rows) == 0.0
    Hll = torch.where(empty_p[None, :], eye_p_rows[:, None], Hll)
    W = None
    if compute_kind == ComputeKind.EXPLICIT:
        W = tuple(for_shards(
            lambda jc, jp, pl: coupling_rows(jc, pl.to_cam(jp), od),
            Jc, Jp, plans.shards))
    return SchurSystem(Hpp=Hpp.contiguous(), Hll=Hll.contiguous(),
                       g_cam=g_cam.contiguous(), g_pt=g_pt.contiguous(), W=W)


def coupling_row_provider(
    W: Optional[torch.Tensor],
    Jc: Optional[torch.Tensor],
    Jp: Optional[torch.Tensor],
    od: int,
    compute_kind: ComputeKind,
    dtype: torch.dtype,
    plans: DualPlans,
):
    """Chunk accessor for the per-edge coupling block rows W_e = Jc_e^T Jp_e
    (JAX builder.py:270-305).

    Returns `rows(start, size) -> [cd*pd, size]` in camera-slot order and
    `dtype`: the stored `W` rows in EXPLICIT mode, rebuilt from the
    Jacobian rows in IMPLICIT mode (`Jp` is carried in point-slot order
    and is brought to camera order once here).  bfloat16 rows (a
    precision rung) are upcast.
    """
    if compute_kind == ComputeKind.EXPLICIT:
        def rows(start: int, size: int) -> torch.Tensor:
            return W[:, start:start + size].to(dtype)

        return rows
    Jp_cam = plans.to_cam(Jp)

    def rows(start: int, size: int) -> torch.Tensor:
        jc = Jc[:, start:start + size].to(dtype)
        jp = Jp_cam[:, start:start + size].to(dtype)
        return coupling_rows(jc, jp, od)

    return rows


def damp_blocks(H: torch.Tensor, region: torch.Tensor) -> torch.Tensor:
    """LM damping on batched [N, d, d] blocks: the diagonal scales by
    (1 + 1/region)."""
    d = H.shape[-1]
    eye = torch.eye(d, dtype=H.dtype, device=H.device)
    return H * (1.0 + eye / region)

"""Schur-complement preconditioned conjugate gradients (feature-major).

Counterpart of `megba_tpu/solver/pcg.py` for the single-device path:

  1. invert the damped Hll blocks (row-form closed-form adjugates);
  2. reduced RHS v = g_cam - Hpl Hll^-1 g_pt;
  3. PCG on S x = v, S = Hpp - Hpl Hll^-1 Hlp, block-Jacobi M^-1 = Hpp^-1;
  4. back-substitute dx_pt = Hll^-1 (g_pt - Hlp x).

Hpl/Hlp are never formed as matrices.  IMPLICIT recomputes each product
from the stored Jacobian rows, as a `coupling_expand` kernel (u = J x per
edge), a cross permute of the [od] rows to the other order, and a
`coupling_reduce` kernel (J^T u summed per vertex).  EXPLICIT contracts
the stored per-edge blocks W (SchurSystem.W): unfused, as a `seg_expand`
kernel, the per-edge W contraction in plain PyTorch, a cross permute and
a `seg_reduce` kernel; fused (`fused_kernels`), as one
`fused_coupling_apply` kernel per direction, with W brought into point
order once per solve.

The PCG body is the unguarded Chronopoulos-Gear single-recurrence CG of
the JAX package's `_pcg_core`, as a Python loop; its exit test reads
|rho| and the refuse flag on the host once per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from megba_tpu_torch.common import ComputeKind
from megba_tpu_torch.core.fm import block_inv_fm, block_matvec_fm, damp_rows_fm
from megba_tpu_torch.linear_system.builder import SchurSystem, damp_blocks
from megba_tpu_torch.ops.accum import comp_dot
from megba_tpu_torch.ops import fused, segtiles
from megba_tpu_torch.ops.segtiles import DualPlans
from megba_tpu_torch.solver.precond import (
    cam_block_matvec,
    make_schur_preconditioner,
)

# Absolute floor for the relative PCG threshold (guards rho0 == 0).
_TINY_RHO = 1e-30


@dataclasses.dataclass
class PCGResult:
    """Solve output: the Schur update and diagnostics (feature-major)."""

    dx_cam: torch.Tensor  # [cd, Nc]
    dx_pt: torch.Tensor  # [pd, Np]
    iterations: int
    rho: torch.Tensor  # final residual energy <r, M^-1 r>


def _edge_cam_to_pt_explicit(W, pe, cd, pd):
    """W^T applied per edge: [cd, n] camera rows -> [pd, n]."""
    return torch.stack([sum(W[a * pd + b] * pe[a] for a in range(cd))
                        for b in range(pd)])


def _edge_pt_to_cam_explicit(W, qe, cd, pd):
    """W applied per edge: [pd, n] point rows -> [cd, n]."""
    return torch.stack([sum(W[a * pd + b] * qe[b] for b in range(pd))
                        for a in range(cd)])


MatvecPair = Tuple[Callable[[torch.Tensor], torch.Tensor],
                   Callable[[torch.Tensor], torch.Tensor]]


def make_coupling_matvecs(
    Jc: Optional[torch.Tensor],
    Jp: Optional[torch.Tensor],
    plans: DualPlans,
    compute_kind: ComputeKind = ComputeKind.IMPLICIT,
    W: Optional[torch.Tensor] = None,
    fused_kernels: bool = False,
) -> MatvecPair:
    """Build hpl(q_pt [pd,Np]) -> [cd,Nc] and hlp(p_cam [cd,Nc]) -> [pd,Np].

    IMPLICIT reads only `Jc` (cam-slot order) and `Jp` (pt-slot order,
    algo/lm.py carries it there): each direction is expand -> cross
    permute -> reduce, and the expanded [cd]/[pd] per-edge rows never
    exist.  EXPLICIT reads only `W` (cam-slot order); with
    `fused_kernels` each direction is one fused kernel and `plans` must
    carry the fused directions (ops/fused.with_fused_plans).
    """
    if compute_kind == ComputeKind.EXPLICIT:
        if W is None:
            raise ValueError("EXPLICIT coupling products need the stored "
                             "W rows (SchurSystem.W)")
        if fused_kernels:
            return _fused_explicit_matvecs(W, plans)
        return _explicit_matvecs(W, plans)
    if fused_kernels:
        raise NotImplementedError(
            "fused_kernels with IMPLICIT needs the fused implicit coupling "
            "kernel (_fused_j_kernel), not ported yet")
    ocd, opd = Jc.shape[0], Jp.shape[0]

    def hlp(p_cam: torch.Tensor) -> torch.Tensor:
        cd = p_cam.shape[0]
        od = ocd // cd
        pd = opd // od
        u = segtiles.coupling_expand(p_cam, Jc, plans.cam, cd)
        return segtiles.coupling_reduce(Jp, plans.to_pt(u), plans.pt, pd)

    def hpl(q_pt: torch.Tensor) -> torch.Tensor:
        pd = q_pt.shape[0]
        od = opd // pd
        cd = ocd // od
        u = segtiles.coupling_expand(q_pt, Jp, plans.pt, pd)
        return segtiles.coupling_reduce(Jc, plans.to_cam(u), plans.cam, cd)

    return hpl, hlp


def _explicit_matvecs(W: torch.Tensor, plans: DualPlans) -> MatvecPair:
    """EXPLICIT, unfused (JAX pcg.py:333-349): gather the vector to the
    edges, contract with W per edge, permute, segment-sum."""
    cdpd = W.shape[0]

    def hlp(p_cam: torch.Tensor) -> torch.Tensor:
        cd = p_cam.shape[0]
        pd = cdpd // cd
        pe = segtiles.seg_expand(p_cam, plans.cam)  # [cd, n] cam slots
        te = _edge_cam_to_pt_explicit(W, pe, cd, pd)
        return segtiles.seg_reduce(plans.to_pt(te), plans.pt)

    def hpl(q_pt: torch.Tensor) -> torch.Tensor:
        pd = q_pt.shape[0]
        cd = cdpd // pd
        qe = plans.to_cam(segtiles.seg_expand(q_pt, plans.pt))  # cam slots
        te = _edge_pt_to_cam_explicit(W, qe, cd, pd)
        return segtiles.seg_reduce(te, plans.cam)

    return hpl, hlp


def _fused_explicit_matvecs(W: torch.Tensor, plans: DualPlans) -> MatvecPair:
    """EXPLICIT, fused (JAX pcg.py:291-303): one kernel per direction.
    W is brought into point-slot order here, once per PCG solve."""
    fp_tp, fp_tc = plans.fused_to_pt, plans.fused_to_cam
    if fp_tp is None or fp_tc is None:
        raise ValueError("fused_kernels needs the fused plans on the dual "
                         "plans (ops/fused.with_fused_plans; flat_solve "
                         "plans them)")
    W_tp = plans.to_pt(W)

    def hlp(p_cam: torch.Tensor) -> torch.Tensor:
        return fused.fused_coupling_apply(W_tp, p_cam, fp_tp, w_in_major=True)

    def hpl(q_pt: torch.Tensor) -> torch.Tensor:
        return fused.fused_coupling_apply(W, q_pt, fp_tc, w_in_major=False)

    return hpl, hlp


def _pcg_core(matvec, precond, b, max_iter, tol, refuse_ratio, tol_relative):
    """Preconditioned CG (Chronopoulos-Gear single recurrence), unguarded.

    Exits when |rho| < threshold (absolute `tol`, or `tol` times the RHS
    energy under `tol_relative`), after `max_iter` iterations, or when
    rho exceeds refuse_ratio * min(rho) — then the best iterate is
    restored.  Returns (x, iterations, rho).
    """
    x = torch.zeros_like(b)
    r = b
    u0 = precond(r)
    rho = comp_dot(r, u0)
    rhs_energy = rho
    threshold = (torch.clamp(tol * rhs_energy.abs(), min=_TINY_RHO)
                 if tol_relative else torch.as_tensor(tol, dtype=b.dtype,
                                                      device=b.device))
    # Prime the recurrence: p0 = u0, s0 = A p0, alpha0 = rho0 / <p0, A p0>.
    w0 = matvec(u0)
    delta0 = comp_dot(u0, w0)
    alpha = rho / torch.where(delta0 == 0, torch.ones_like(delta0), delta0)
    p, s = u0, w0
    rho_min = rho.abs()
    x_best = x
    refused = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    while k < max_iter and bool((rho.abs() >= threshold) & ~refused):
        x = x + alpha * p
        r = r + (-alpha) * s
        u = precond(r)
        w = matvec(u)
        rho_new = comp_dot(r, u)
        delta = comp_dot(u, w)
        beta = rho_new / rho
        alpha = rho_new / (delta - beta * rho_new / alpha)
        p = u + beta * p
        s = w + beta * s  # == A p, by linearity
        refused = rho_new.abs() > refuse_ratio * rho_min
        improved = rho_new.abs() < rho_min
        rho_min = torch.where(improved, rho_new.abs(), rho_min)
        x_best = torch.where(improved, x, x_best)
        rho = rho_new
        k += 1
    return torch.where(refused, x_best, x), k, rho


def schur_pcg_solve(
    system: SchurSystem,
    Jc: Optional[torch.Tensor],
    Jp: Optional[torch.Tensor],
    plans: DualPlans,
    region: torch.Tensor,
    max_iter: int = 100,
    tol: float = 1e-1,
    refuse_ratio: float = 1.0,
    tol_relative: bool = False,
    compute_kind: ComputeKind = ComputeKind.IMPLICIT,
    fused_kernels: bool = False,
) -> PCGResult:
    """Solve the damped Schur system for (dx_cam, dx_pt), feature-major.

    `region` is the LM trust region: damping multiplies the block
    diagonals' diagonals by (1 + 1/region).  EXPLICIT reads the coupling
    from `system.W` and not `Jc`/`Jp` (which may be None then);
    `fused_kernels` (EXPLICIT only) runs each coupling direction and the
    block-Jacobi apply as one fused kernel.
    """
    Hpp_d = damp_blocks(system.Hpp, region)
    Hll_inv = block_inv_fm(damp_rows_fm(system.Hll, region))
    hpl, hlp = make_coupling_matvecs(Jc, Jp, plans, compute_kind, system.W,
                                     fused_kernels)

    def s_matvec(p: torch.Tensor) -> torch.Tensor:
        # S p = Hpp_d p - Hpl Hll_d^-1 Hlp p
        t = block_matvec_fm(Hll_inv, hlp(p))
        return cam_block_matvec(Hpp_d, p) - hpl(t)

    precond = make_schur_preconditioner(Hpp_d, fused_kernels)
    v = system.g_cam - hpl(block_matvec_fm(Hll_inv, system.g_pt))
    x, k, rho = _pcg_core(s_matvec, precond, v, max_iter, tol, refuse_ratio,
                          tol_relative)
    dx_pt = block_matvec_fm(Hll_inv, system.g_pt - hlp(x))
    return PCGResult(dx_cam=x, dx_pt=dx_pt, iterations=k, rho=rho)

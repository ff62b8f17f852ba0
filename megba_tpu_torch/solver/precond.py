"""Preconditioners of the reduced camera system.

Counterpart of the JACOBI and NEUMANN families of
`megba_tpu/solver/precond.py` on either block diagonal: the damped camera
blocks Hpp (`PreconditionerKind.HPP`) or the true Schur block diagonal
Hpp - sum_e W_e Hll^-1 W_e^T (`PreconditionerKind.SCHUR_DIAG`,
`_schur_diag_precond`).  JACOBI applies the inverted block diagonal;
NEUMANN applies the truncated series sum_{i<=k} (I - D^-1 S)^i D^-1 by
Horner recursion, k = `neumann_order` extra S products a apply.

The batched 9x9 inverse runs through `torch.linalg` as the JAX package
leaves it to XLA, with `cholesky_ex`: no host read of the factor's
status, and a block that is not positive definite (or not finite) comes
out all NaN, as `jnp.linalg.cholesky` gives it.  SCHUR_DIAG counts the
blocks whose inverse is not finite and falls back to the Hpp inverse
for exactly those; the count rides `PCGResult.precond_fallback`
(`encode_precond_fallback`) into the trace.  The per-camera sum of the
SCHUR_DIAG correction rows is kernel 4 (`segtiles.seg_reduce`), nine
launches of nine rows each over the camera plan.

With `fused_kernels` the base apply is the block-diagonal kernel
(`ops.fused.fused_block_diag_apply`) on M^-1 laid out once per solve as
feature-major rows; under `SolverOption.bf16` those rows are a bfloat16
copy and the kernel runs its bf16 arm (JAX precond.py:938-947): each
product rounded to bfloat16, the sums in float32.  Without fused kernels
the bf16 rung applies `cam_block_matvec_bf16` (JAX precond.py:948-952),
whose XLA einsum keeps the exact float32 products of the bfloat16
operands.  Every family applies its base through the same closure.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from megba_tpu_torch.common import ComputeKind, PrecondKind, PreconditionerKind
from megba_tpu_torch.linear_system.builder import coupling_row_provider
from megba_tpu_torch.ops import fused, segtiles
from megba_tpu_torch.ops.segtiles import DualPlans

# `precond_fallback` is one int32 (JAX precond.py:166-200): the low 16
# bits count SCHUR_DIAG blocks that fell back to the Hpp inverse, the
# high bits are a per-coarse-level bit-field (the coarse families are
# not ported, so it is 0 here).
FALLBACK_BLOCK_RADIX = 1 << 16
FALLBACK_MAX_COARSE_LEVELS = 15


def encode_precond_fallback(block_count, coarse_bits=0):
    """Pack the block count and the coarse-level bit-field into one
    int32 (a tensor when `block_count` is one)."""
    if isinstance(block_count, torch.Tensor):
        block = torch.clamp(block_count.to(torch.int32),
                            max=FALLBACK_BLOCK_RADIX - 1)
        return coarse_bits * FALLBACK_BLOCK_RADIX + block
    return (int(coarse_bits) * FALLBACK_BLOCK_RADIX
            + min(int(block_count), FALLBACK_BLOCK_RADIX - 1))


def decode_precond_fallback(code) -> dict:
    """Unpack a trace code into {'block': n, 'coarse': bits} (host ints)."""
    c = int(code)
    return {"block": c % FALLBACK_BLOCK_RADIX,
            "coarse": c // FALLBACK_BLOCK_RADIX}


def decode_precond_fallback_levels(code) -> list:
    """Per-coarse-level degrade flags [level 1, level 2, ...] of one
    trace code, trailing healthy levels trimmed."""
    bits = int(code) // FALLBACK_BLOCK_RADIX
    out = []
    level = 0
    while bits and level < FALLBACK_MAX_COARSE_LEVELS:
        out.append(bool(bits & 1))
        bits >>= 1
        level += 1
    return out


def cam_block_matvec(H: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[Nc, d, d] camera blocks times [d, Nc] rows -> contiguous [d, Nc]
    rows (the kernels take contiguous feature rows only)."""
    return torch.einsum("nij,jn->in", H, x).contiguous()


def cam_block_matvec_bf16(H_bf16: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """The unfused bf16 rung's block apply (JAX precond.py:212-226): a
    bfloat16 copy of the blocks [Nc, d, d] times x [d, Nc] rounded to
    bfloat16, every product exact in float32 (two bfloat16 values), the
    sums in float32.  Written as a broadcast product and a sum, not a
    matmul, so no TF32 setting can touch it.  Returns contiguous float32
    [d, Nc] rows."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    return (H_bf16.to(torch.float32) * xb.T[:, None, :]).sum(-1).T.contiguous()


def block_inv(H: torch.Tensor) -> torch.Tensor:
    """Batched inverse of SPD blocks [N, d, d] via Cholesky: L^-T L^-1.

    A block whose factorisation fails (not positive definite) or that
    holds a non-finite value gets an all-NaN factor, hence an all-NaN
    inverse, as `jnp.linalg.cholesky` gives it; `cholesky_ex` reads no
    status back to the host, and healthy blocks are bitwise what
    `torch.linalg.cholesky` gives.
    """
    d = H.shape[-1]
    chol, info = torch.linalg.cholesky_ex(H)
    bad = (info != 0) | ~torch.isfinite(H).all(-1).all(-1)
    chol = torch.where(bad[:, None, None],
                       torch.full_like(chol, float("nan")), chol)
    eye = torch.eye(d, dtype=H.dtype, device=H.device).expand(H.shape)
    inv_l = torch.linalg.solve_triangular(chol, eye, upper=False)
    return torch.einsum("nki,nkj->nij", inv_l, inv_l)


def _schur_diag_precond(
    Hpp_d: torch.Tensor,
    Hll_inv: torch.Tensor,
    W: Optional[torch.Tensor],
    Jc: Optional[torch.Tensor],
    Jp: Optional[torch.Tensor],
    plans: DualPlans,
    compute_kind: ComputeKind,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The true Schur block diagonal Hpp_d - sum_e W_e Hll^-1 W_e^T,
    inverted, and the number of camera blocks that fell back to the Hpp
    inverse (JAX precond.py:244-299).

    The coupling rows come in camera-slot order (`coupling_row_provider`:
    W in EXPLICIT mode, Jc^T Jp rebuilt in IMPLICIT mode, bfloat16 rows
    upcast); each edge's correction block W_e Hll^-1 W_e^T is formed per
    slot, nine of its 81 rows at a time, and summed per camera by kernel
    4, nine launches of nine rows.  The whole edge axis is one chunk.
    """
    cd = Hpp_d.shape[-1]
    pd = int(round(Hll_inv.shape[0] ** 0.5))
    dtype = Hpp_d.dtype
    od = 0 if Jc is None else Jc.shape[0] // cd
    rows_of = coupling_row_provider(W, Jc, Jp, od, compute_kind, dtype,
                                    plans=plans)
    n = plans.cam.n_slots
    w = rows_of(0, n)  # [cd*pd, n]
    # The point of each camera slot, and its Hll^-1 rows there.
    pt_of_slot = plans.pt.seg.long().index_select(0, plans.cam.inv)
    hinv = Hll_inv.index_select(1, pt_of_slot)  # [pd*pd, n]
    # t[a, q] = sum_p w[a, p] hinv[p, q]
    t = [sum(w[a * pd + p] * hinv[p * pd + q] for p in range(pd))
         for a in range(cd) for q in range(pd)]
    del hinv
    # corr[a, b] = sum_q t[a, q] w[b, q]; camera row a's nine rows are
    # formed and summed per camera together, so only nine of the 81 edge
    # rows exist at a time.
    corr_rows = torch.cat([
        segtiles.seg_reduce(torch.stack([
            sum(t[a * pd + q] * w[b * pd + q] for q in range(pd))
            for b in range(cd)]), plans.cam)
        for a in range(cd)])
    del w, t
    num_cameras = Hpp_d.shape[0]
    corr = torch.movedim(corr_rows.reshape(cd, cd, num_cameras), -1, 0)
    # Exact arithmetic keeps Hpp_d - corr SPD (a principal block of S);
    # rounding, or a crushed Hll, can push a camera block indefinite.
    # Those blocks fall back to the Hpp inverse, and are counted.
    minv_hpp = block_inv(Hpp_d)
    minv_sd = block_inv(Hpp_d - corr)
    bad = ~torch.isfinite(minv_sd).all(-1).all(-1)
    return (torch.where(bad[:, None, None], minv_hpp, minv_sd),
            bad.sum().to(torch.int32))


def make_schur_preconditioner(
    kind: PrecondKind,
    block_kind: PreconditionerKind,
    Hpp_d: torch.Tensor,
    Hll_inv: Optional[torch.Tensor] = None,
    W: Optional[torch.Tensor] = None,
    Jc: Optional[torch.Tensor] = None,
    Jp: Optional[torch.Tensor] = None,
    plans: Optional[DualPlans] = None,
    compute_kind: ComputeKind = ComputeKind.IMPLICIT,
    neumann_order: int = 2,
    s_matvec: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    bf16: bool = False,
    fused_kernels: bool = False,
) -> Tuple[Callable[[torch.Tensor], torch.Tensor], Union[int, torch.Tensor]]:
    """The reduced-system preconditioner of one PCG solve.

    Returns `(apply, fallback_code)`: `apply(r [cd, Nc]) -> [cd, Nc]`,
    and the enum-coded fallback count (`encode_precond_fallback`; a
    device tensor under SCHUR_DIAG, 0 otherwise).  `kind` picks the
    operator family (JACOBI or NEUMANN; NEUMANN needs `s_matvec`, the
    CG's own S product), `block_kind` the base block diagonal (HPP, or
    SCHUR_DIAG, which needs `Hll_inv`, `plans` and the coupling rows of
    `compute_kind`).  `bf16` applies a bfloat16 copy of the inverted
    diagonal: through the kernel's bf16 arm with `fused_kernels`,
    through `cam_block_matvec_bf16` without.
    """
    if block_kind == PreconditionerKind.SCHUR_DIAG:
        if Hll_inv is None or plans is None:
            raise ValueError("the SCHUR_DIAG preconditioner needs Hll^-1 "
                             "and the dual plans")
        Minv, n_bad = _schur_diag_precond(Hpp_d, Hll_inv, W, Jc, Jp, plans,
                                          compute_kind)
    else:
        Minv = block_inv(Hpp_d)
        n_bad = 0

    if fused_kernels:
        Hrows = fused.block_diag_rows(Minv.to(torch.bfloat16) if bf16
                                      else Minv)

        def base_apply(r: torch.Tensor) -> torch.Tensor:
            return fused.fused_block_diag_apply(Hrows, r, bf16_operands=bf16)
    elif bf16:
        Minv_bf16 = Minv.to(torch.bfloat16)

        def base_apply(r: torch.Tensor) -> torch.Tensor:
            return cam_block_matvec_bf16(Minv_bf16, r)
    else:
        def base_apply(r: torch.Tensor) -> torch.Tensor:
            return cam_block_matvec(Minv, r)

    if kind == PrecondKind.JACOBI:
        return base_apply, encode_precond_fallback(n_bad)
    if kind == PrecondKind.NEUMANN:
        if s_matvec is None:
            raise ValueError("NEUMANN preconditioner needs the S matvec")
        order = int(neumann_order)

        def neumann_apply(r: torch.Tensor) -> torch.Tensor:
            # Horner form of sum_{i<=k} E^i D^-1 r, E = I - D^-1 S: each
            # step one S product and one base apply.
            z = base_apply(r)
            for _ in range(order):
                z = z + base_apply(r - s_matvec(z))
            return z

        return neumann_apply, encode_precond_fallback(n_bad)
    raise NotImplementedError(
        f"precond={kind.name} is not ported to megba_tpu_torch yet")

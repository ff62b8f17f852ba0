"""Block-Jacobi preconditioner of the reduced camera system.

Counterpart of the JACOBI family on the HPP block diagonal in
`megba_tpu/solver/precond.py` (`block_inv`, `cam_block_matvec` and the
JACOBI branch of `make_schur_preconditioner`): M^-1 is the inverse of the
damped camera blocks Hpp.  The batched 9x9 inverse runs through
`torch.linalg`, as the JAX package leaves it to XLA.  With
`fused_kernels` the apply is the block-diagonal kernel
(`ops.fused.fused_block_diag_apply`) on M^-1 laid out once per solve as
feature-major rows; under `SolverOption.bf16` those rows are a bfloat16
copy and the kernel runs its bf16 arm (JAX precond.py:938-947): each
product rounded to bfloat16, the sums in float32.  That is the Pallas
kernel's rounding.  Without fused kernels the bf16 rung applies
`cam_block_matvec_bf16` (JAX precond.py:948-952), whose XLA einsum keeps
the exact float32 products of the bfloat16 operands.
"""

from __future__ import annotations

from typing import Callable

import torch

from megba_tpu_torch.ops import fused


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
    """Batched inverse of SPD blocks [N, d, d] via Cholesky: L^-T L^-1."""
    d = H.shape[-1]
    chol = torch.linalg.cholesky(H)
    eye = torch.eye(d, dtype=H.dtype, device=H.device).expand(H.shape)
    inv_l = torch.linalg.solve_triangular(chol, eye, upper=False)
    return torch.einsum("nki,nkj->nij", inv_l, inv_l)


def make_schur_preconditioner(
        Hpp_d: torch.Tensor, fused_kernels: bool = False,
        bf16: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """The JACOBI/HPP apply r [cd, Nc] -> M^-1 r for one PCG solve;
    `bf16` applies a bfloat16 copy of M^-1: through the kernel's bf16 arm
    with `fused_kernels`, through `cam_block_matvec_bf16` without."""
    Minv = block_inv(Hpp_d)
    if fused_kernels:
        Hrows = fused.block_diag_rows(Minv.to(torch.bfloat16) if bf16
                                      else Minv)

        def fused_apply(r: torch.Tensor) -> torch.Tensor:
            return fused.fused_block_diag_apply(Hrows, r, bf16_operands=bf16)

        return fused_apply
    if bf16:
        Minv_bf16 = Minv.to(torch.bfloat16)

        def bf16_apply(r: torch.Tensor) -> torch.Tensor:
            return cam_block_matvec_bf16(Minv_bf16, r)

        return bf16_apply

    def apply(r: torch.Tensor) -> torch.Tensor:
        return cam_block_matvec(Minv, r)

    return apply

"""Block-Jacobi preconditioner of the reduced camera system.

Counterpart of the JACOBI family on the HPP block diagonal in
`megba_tpu/solver/precond.py` (`block_inv`, `cam_block_matvec` and the
JACOBI branch of `make_schur_preconditioner`): M^-1 is the inverse of the
damped camera blocks Hpp.  The batched 9x9 inverse runs through
`torch.linalg`, as the JAX package leaves it to XLA.  With
`fused_kernels` the apply is the block-diagonal kernel
(`ops.fused.fused_block_diag_apply`) on M^-1 laid out once per solve as
feature-major rows.
"""

from __future__ import annotations

from typing import Callable

import torch

from megba_tpu_torch.ops import fused


def cam_block_matvec(H: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[Nc, d, d] camera blocks times [d, Nc] rows -> contiguous [d, Nc]
    rows (the kernels take contiguous feature rows only)."""
    return torch.einsum("nij,jn->in", H, x).contiguous()


def block_inv(H: torch.Tensor) -> torch.Tensor:
    """Batched inverse of SPD blocks [N, d, d] via Cholesky: L^-T L^-1."""
    d = H.shape[-1]
    chol = torch.linalg.cholesky(H)
    eye = torch.eye(d, dtype=H.dtype, device=H.device).expand(H.shape)
    inv_l = torch.linalg.solve_triangular(chol, eye, upper=False)
    return torch.einsum("nki,nkj->nij", inv_l, inv_l)


def make_schur_preconditioner(
        Hpp_d: torch.Tensor,
        fused_kernels: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """The JACOBI/HPP apply r [cd, Nc] -> M^-1 r for one PCG solve."""
    Minv = block_inv(Hpp_d)
    if fused_kernels:
        Hrows = fused.block_diag_rows(Minv)

        def fused_apply(r: torch.Tensor) -> torch.Tensor:
            return fused.fused_block_diag_apply(Hrows, r)

        return fused_apply

    def apply(r: torch.Tensor) -> torch.Tensor:
        return cam_block_matvec(Minv, r)

    return apply

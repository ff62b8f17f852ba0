"""Schur-complement PCG and its block-Jacobi preconditioner."""

from megba_tpu_torch.solver.dense import dense_reference_solve
from megba_tpu_torch.solver.pcg import (
    PCGResult,
    plain_pcg_solve,
    schur_pcg_solve,
)
from megba_tpu_torch.solver.precond import block_inv, cam_block_matvec

__all__ = [
    "PCGResult",
    "block_inv",
    "cam_block_matvec",
    "plain_pcg_solve",
    "schur_pcg_solve",
    "dense_reference_solve",
]

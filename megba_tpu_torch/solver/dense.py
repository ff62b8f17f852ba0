"""Dense solves of small and test-scale systems (PyTorch).

Counterpart of `megba_tpu/solver/dense.py`:

- `dense_filtered_factor` / `dense_filtered_solve`: the spectrally
  filtered pseudo-inverse of a small symmetric matrix, the coarse solve
  of the TWO_LEVEL and MULTILEVEL preconditioners (solver/precond.py);
- `dense_reference_solve`: the direct solve of the full damped system,
  the ground truth the tests hold the PCG solvers to.  Test-scale only:
  O((Nc*cd + Np*pd)^2) memory.

`torch.linalg.eigh` differs from `jnp.linalg.eigh` on a non-finite
matrix: on CUDA, cuSOLVER may report a failure to converge, and torch
then raises (it reads the solver's status back to the host to do so).
The factor therefore decomposes the matrix with its non-finite entries
zeroed and reports `ok=False` for it, so a poisoned coarse operator
falls back to the base apply and never raises.  That status read is
the one host synchronisation of a factor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from megba_tpu_torch.core.fm import coupling_rows, damp_rows_fm
from megba_tpu_torch.linear_system.builder import SchurSystem, damp_blocks


def dense_filtered_factor(
    A: torch.Tensor, rel_floor: float
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Spectrally filtered pseudo-inverse factor of a small symmetric A
    (JAX dense.py:22-49).

    Eigendecomposes A and keeps only the eigenvalues above
    `rel_floor * lambda_max`: `dense_filtered_solve` then applies
    A^+ = Q diag(1/lambda_kept, 0) Q^T, symmetric positive semidefinite by
    construction.  Returns ((Q, inv_lam), ok): `ok` (a 0-dim bool tensor)
    is False when A is not finite, or its spectrum is not finite or has no
    positive part; Q is zero then.  Eigenvectors and their signs may
    differ from the JAX package's; A^+ does not.
    """
    finite = torch.isfinite(A).all()
    lam, Q = torch.linalg.eigh(torch.where(finite, A, torch.zeros_like(A)))
    lam_max = lam[-1]  # ascending eigenvalues
    ok = (finite & torch.isfinite(lam).all() & torch.isfinite(Q).all()
          & (lam_max > 0))
    inv = torch.where(lam > rel_floor * lam_max, 1.0 / lam,
                      torch.zeros_like(lam))
    inv = torch.where(torch.isfinite(inv), inv, torch.zeros_like(inv))
    Q = torch.where(ok, Q, torch.zeros_like(Q))
    return (Q, inv), ok


def dense_filtered_solve(
    factor: Tuple[torch.Tensor, torch.Tensor], b: torch.Tensor
) -> torch.Tensor:
    """Apply the filtered pseudo-inverse of `dense_filtered_factor`."""
    Q, inv = factor
    return Q @ (inv * (Q.T @ b))


def dense_reference_solve(
    system: SchurSystem,
    Jc: torch.Tensor,
    Jp: torch.Tensor,
    cam_idx: torch.Tensor,
    pt_idx: torch.Tensor,
    region: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct solve of the damped system H dx = g (JAX dense.py:60-113).

    `Jc`, `Jp`, `cam_idx` and `pt_idx` are per edge in one edge order
    (Jp in that same order, not point-slot order).  Returns
    (dx_cam [cd, Nc], dx_pt [pd, Np]).
    """
    Nc, cd, _ = system.Hpp.shape
    pdpd, Np = system.Hll.shape
    pd = int(round(pdpd ** 0.5))
    od = Jc.shape[0] // cd
    n = Nc * cd + Np * pd

    Hpp_d = damp_blocks(system.Hpp, region)
    Hll_d = damp_rows_fm(system.Hll, region)
    H = torch.zeros((n, n), dtype=system.Hpp.dtype, device=Hpp_d.device)
    for i in range(Nc):
        H[i * cd:(i + 1) * cd, i * cd:(i + 1) * cd] = Hpp_d[i]
    off = Nc * cd
    for j in range(Np):
        H[off + j * pd:off + (j + 1) * pd,
          off + j * pd:off + (j + 1) * pd] = Hll_d[:, j].reshape(pd, pd)
    W = coupling_rows(Jc, Jp, od)  # [cd*pd, nE]
    for e in range(Jc.shape[1]):
        ci, pi = int(cam_idx[e]), int(pt_idx[e])
        blk = W[:, e].reshape(cd, pd)
        rows = slice(ci * cd, (ci + 1) * cd)
        cols = slice(off + pi * pd, off + (pi + 1) * pd)
        H[rows, cols] += blk
        H[cols, rows] += blk.T
    g = torch.cat([system.g_cam.T.reshape(-1), system.g_pt.T.reshape(-1)])
    dx = torch.linalg.solve(H, g)
    return (dx[:Nc * cd].reshape(Nc, cd).T.contiguous(),
            dx[Nc * cd:].reshape(Np, pd).T.contiguous())


__all__ = ["dense_filtered_factor", "dense_filtered_solve",
           "dense_reference_solve"]

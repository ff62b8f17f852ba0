"""Flat solve pipeline + one-call BAL convenience (PyTorch).

Counterpart of `megba_tpu/solve.py` on the single-device plan path:
`flat_solve` takes the conventional edge-major numpy arrays, plans both
segment orders on the host (ops/segtiles.make_dual_plans: the stable
camera sort is the canonical edge order), with `fused_kernels` derives
from them the input index of each fused direction once
(ops/fused.with_fused_plans), moves feature-major tensors to the device
once, runs the LM loop, and returns the solved cameras and points
edge-major ([N, d]) again.

Entry points run on CUDA unless the caller passes `device="cpu"` (or an
option with `device=Device.CPU`); with no card and no such request they
raise.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from megba_tpu_torch.algo.lm import LMResult, lm_solve
from megba_tpu_torch.common import (
    DTYPE_TO_TORCH,
    JacobianMode,
    ProblemOption,
    resolve_device,
    validate_options,
)
from megba_tpu_torch.io.bal import BALFile, load_bal
from megba_tpu_torch.ops.fused import with_fused_plans
from megba_tpu_torch.ops.segtiles import make_dual_plans


def flat_solve(
    cameras: np.ndarray,
    points: np.ndarray,
    obs: np.ndarray,
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    option: ProblemOption,
    sqrt_info: Optional[np.ndarray] = None,
    edge_mask: Optional[np.ndarray] = None,
    cam_fixed: Optional[np.ndarray] = None,
    pt_fixed: Optional[np.ndarray] = None,
    verbose: bool = False,
    device: Union[None, str, torch.device] = None,
) -> LMResult:
    """Lower flat arrays and run the solve on one device.

    Arrays are edge-major numpy: cameras [Nc, 9], points [Np, 3],
    obs [nE, 2], cam_idx/pt_idx [nE], sqrt_info [nE, 2, 2].  `edge_mask`
    ([nE] 0/1, caller's edge order) soft-deletes edges: a 0 edge adds
    nothing to the cost or the system.  `cam_fixed` / `pt_fixed` ([Nc] /
    [Np] bool) freeze vertices.  The result's cameras/points are [N, d]
    tensors on the solve device.
    """
    validate_options(option)
    dev = resolve_device(device, option)
    dtype = np.dtype(option.dtype)
    tdtype = DTYPE_TO_TORCH[dtype]
    cameras = np.asarray(cameras).astype(dtype, copy=False)
    points = np.asarray(points).astype(dtype, copy=False)
    obs = np.asarray(obs).astype(dtype, copy=False)
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    n_edges = int(cam_idx.shape[0])
    if obs.shape[0] != n_edges or pt_idx.shape[0] != n_edges:
        raise ValueError(
            f"obs ({obs.shape[0]}), cam_idx ({n_edges}) and pt_idx "
            f"({pt_idx.shape[0]}) must have one row per edge")
    mask = np.ones(n_edges, dtype)
    if edge_mask is not None:
        mask = np.asarray(edge_mask).astype(dtype, copy=False).reshape(-1)
        if mask.shape[0] != n_edges:
            raise ValueError(
                f"edge_mask has {mask.shape[0]} entries for a problem "
                f"with {n_edges} edges")

    # Canonical edge order = the stable camera sort (cam plan slots).
    plan_c, plans = make_dual_plans(cam_idx, pt_idx, cameras.shape[0],
                                    points.shape[0], dev)
    if option.solver_option.fused_kernels:
        plans = with_fused_plans(plans)
    perm = plan_c.perm

    def edge_rows(a: np.ndarray) -> torch.Tensor:
        """[nE, ...] caller order -> feature-major [F, nE] slot order."""
        a = a[perm].reshape(n_edges, -1)
        return torch.from_numpy(np.ascontiguousarray(a.T)).to(dev)

    def vertex_rows(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a.T)).to(dev)

    def flags(a: Optional[np.ndarray], n: int) -> Optional[torch.Tensor]:
        if a is None:
            return None
        a = np.asarray(a, dtype=bool).reshape(-1)
        if a.shape[0] != n:
            raise ValueError(f"fixed mask has {a.shape[0]} entries, "
                             f"expected {n}")
        return torch.from_numpy(a).to(dev)

    si = None
    if sqrt_info is not None:
        si = edge_rows(np.asarray(sqrt_info).astype(dtype, copy=False))
    result = lm_solve(
        vertex_rows(cameras), vertex_rows(points), edge_rows(obs),
        plans.cam.seg.long(),
        torch.from_numpy(pt_idx[perm].astype(np.int64)).to(dev),
        torch.from_numpy(mask[perm]).to(dev, tdtype), option, plans,
        sqrt_info=si, cam_fixed=flags(cam_fixed, cameras.shape[0]),
        pt_fixed=flags(pt_fixed, points.shape[0]), verbose=verbose)
    result.cameras = result.cameras.T.contiguous()
    result.points = result.points.T.contiguous()
    return result


def solve_bal(
    bal: Union[BALFile, str, os.PathLike],
    option: Optional[ProblemOption] = None,
    verbose: bool = False,
    device: Union[None, str, torch.device] = None,
) -> Tuple[BALFile, LMResult]:
    """Solve a BAL problem end to end.

    Accepts a parsed `BALFile` or a path (.txt/.bz2).  The default option
    is the JAX package's with ANALYTICAL Jacobians (the one Jacobian mode
    ported).  Returns (solved BALFile in the ORIGINAL edge order,
    LMResult).
    """
    option = option or ProblemOption(jacobian_mode=JacobianMode.ANALYTICAL)
    validate_options(option)
    if not isinstance(bal, BALFile):
        bal = load_bal(bal, dtype=option.dtype)
    if verbose:
        cd = np.bincount(bal.cam_idx, minlength=bal.num_cameras)
        pdg = np.bincount(bal.pt_idx, minlength=bal.num_points)
        print(f"cameras {bal.num_cameras} points {bal.num_points} "
              f"observations {bal.num_observations} max camera degree "
              f"{int(cd.max(initial=0))} max point degree "
              f"{int(pdg.max(initial=0))}", flush=True)
    result = flat_solve(bal.cameras, bal.points, bal.obs, bal.cam_idx,
                        bal.pt_idx, option, verbose=verbose, device=device)
    solved = BALFile(
        cameras=result.cameras.detach().cpu().numpy().astype(np.float64),
        points=result.points.detach().cpu().numpy().astype(np.float64),
        obs=bal.obs, cam_idx=bal.cam_idx, pt_idx=bal.pt_idx)
    return solved, result

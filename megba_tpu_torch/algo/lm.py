"""Levenberg-Marquardt trust-region outer loop (PyTorch).

Counterpart of `megba_tpu/algo/lm.py:lm_solve` for the unguarded case
without forcing or warm starts: damp, solve the Schur system, test
||dx|| <= eps2 (||x|| + eps1), measure the gain ratio rho against the
linearised cost Sum (J dx + r)^2, then accept (relinearise, region /=
max(1/3, 1 - (2 rho - 1)^3), stop when ||g||_inf <= eps1) or reject
(region /= v, v *= 2).

The JAX `lax.while_loop` becomes a Python loop and its `lax.cond`
relinearisation a Python `if`; the host reads the accept and stop flags
once per iteration.  Trial points are costed by the residual alone
(`bal_residual_analytical_fm` + `comp_sum_sq`): eager PyTorch has no
dead-code elimination to drop an unused Jacobian and Schur build, so the
full linearisation runs only on an accepted step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from megba_tpu_torch.common import ProblemOption, SolveStatus
from megba_tpu_torch.linear_system.builder import (
    build_schur_system,
    weight_system_inputs,
)
from megba_tpu_torch.observability.trace import SolveTrace
from megba_tpu_torch.ops.accum import comp_sum_sq
from megba_tpu_torch.ops.residuals import (
    apply_sqrt_info_residual,
    bal_residual_analytical_fm,
    bal_residual_jacobian_analytical_fm,
)
from megba_tpu_torch.ops import segtiles
from megba_tpu_torch.ops.segtiles import DualPlans
from megba_tpu_torch.solver.pcg import schur_pcg_solve

_TINY = 1e-30


def derive_status(*, stopped: bool, accepted: int, recoveries: int = 0,
                  fatal: bool = False) -> int:
    """Termination status code (common.SolveStatus), the JAX package's
    priority order: fatal, then recovered, then converged / max_iter /
    stalled."""
    if fatal:
        return int(SolveStatus.FATAL_NONFINITE)
    if recoveries > 0:
        return int(SolveStatus.RECOVERED)
    if stopped:
        return int(SolveStatus.CONVERGED)
    return int(SolveStatus.MAX_ITER if accepted > 0 else SolveStatus.STALLED)


@dataclasses.dataclass
class LMResult:
    """Final state + diagnostics of one LM solve."""

    cameras: torch.Tensor
    points: torch.Tensor
    cost: torch.Tensor  # final accepted cost Sum e^2
    initial_cost: torch.Tensor
    iterations: int  # LM iterations executed
    accepted: int  # number of accepted steps
    pcg_iterations: int  # total PCG iterations across the solve
    region: torch.Tensor  # final trust region
    v: torch.Tensor  # final reject back-off factor
    stopped: bool  # True when a convergence criterion fired
    trace: Optional[SolveTrace] = None
    status: Optional[int] = None
    recoveries: int = 0


def lm_solve(
    cameras: torch.Tensor,
    points: torch.Tensor,
    obs: torch.Tensor,
    cam_idx: torch.Tensor,
    pt_idx: torch.Tensor,
    mask: torch.Tensor,
    option: ProblemOption,
    plans: DualPlans,
    sqrt_info: Optional[torch.Tensor] = None,
    cam_fixed: Optional[torch.Tensor] = None,
    pt_fixed: Optional[torch.Tensor] = None,
    verbose: bool = False,
) -> LMResult:
    """Run the LM loop to convergence.

    FEATURE-MAJOR contract: cameras [9, Nc], points [3, Np], obs [2, nE],
    sqrt_info [4, nE]; every edge array (obs, cam_idx, pt_idx, mask,
    sqrt_info) is in the cam plan's slot order (solve.flat_solve arranges
    this).  Jp is carried in pt-slot order, so both Hessian sides and
    both coupling products reduce over sorted segments.  With
    `option.compute_kind` EXPLICIT the Schur system also carries the
    coupling rows W, and with `solver_option.fused_kernels` `plans` must
    carry the fused directions (ops/fused.with_fused_plans); the
    precision rungs (`mixed_precision_pcg`, `solver_option.bf16`) reach
    the PCG only.
    """
    num_cameras = cameras.shape[1]
    num_points = points.shape[1]
    algo_opt = option.algo_option
    solver_opt = option.solver_option
    dtype, device = cameras.dtype, cameras.device

    def linearize(cams, pts):
        r, Jc, Jp = bal_residual_jacobian_analytical_fm(
            cams.index_select(1, cam_idx), pts.index_select(1, pt_idx), obs)
        r, Jc, Jp = weight_system_inputs(
            r, Jc, Jp, cam_idx, pt_idx, mask, sqrt_info, cam_fixed, pt_fixed)
        cost = comp_sum_sq(r)
        Jp = plans.to_pt(Jp)
        system = build_schur_system(r, Jc, Jp, plans, num_cameras,
                                    num_points, cam_fixed, pt_fixed,
                                    option.compute_kind)
        return r, Jc, Jp, system, cost

    def trial_cost(cams, pts):
        r = bal_residual_analytical_fm(
            cams.index_select(1, cam_idx), pts.index_select(1, pt_idx), obs)
        r = apply_sqrt_info_residual(r, sqrt_info) * mask[None, :]
        return comp_sum_sq(r)

    r, Jc, Jp, system, cost = linearize(cameras, points)
    cost0 = cost
    region = torch.tensor(algo_opt.initial_region, dtype=dtype, device=device)
    v = torch.tensor(2.0, dtype=dtype, device=device)
    third = torch.tensor(1.0 / 3.0, dtype=dtype, device=device)
    trace = SolveTrace.empty(algo_opt.max_iter, dtype)
    k = accepted = pcg_total = 0
    stop = False
    t0 = time.perf_counter()
    while k < algo_opt.max_iter and not stop:
        pcg = schur_pcg_solve(
            system, Jc, Jp, plans, region, max_iter=solver_opt.max_iter,
            tol=solver_opt.tol, refuse_ratio=solver_opt.refuse_ratio,
            tol_relative=solver_opt.tol_relative,
            compute_kind=option.compute_kind,
            fused_kernels=solver_opt.fused_kernels,
            mixed_precision=option.mixed_precision_pcg, bf16=solver_opt.bf16)
        dx_cam, dx_pt = pcg.dx_cam, pcg.dx_pt

        # ||dx|| <= eps2 (||x|| + eps1) -> converged, the step is not applied.
        dx_norm = torch.sqrt((dx_cam * dx_cam).sum() + (dx_pt * dx_pt).sum())
        x_norm = torch.sqrt((cameras ** 2).sum() + (points ** 2).sum())
        converged = dx_norm <= algo_opt.epsilon2 * (x_norm + algo_opt.epsilon1)
        cams_new = cameras + dx_cam
        pts_new = points + dx_pt

        # Gain-ratio denominator: the linearised cost at dx minus the old
        # cost, from the unscaled full-precision Jc/Jp whatever the PCG's
        # precision rung.  Jp is pt-ordered, so its [od] rows hop to cam
        # order.
        jc_dx = segtiles.coupling_expand(dx_cam, Jc, plans.cam,
                                         dx_cam.shape[0])
        jp_dx = plans.to_cam(
            segtiles.coupling_expand(dx_pt, Jp, plans.pt, dx_pt.shape[0]))
        predicted = comp_sum_sq(jc_dx + jp_dx + r)
        denominator = torch.clamp(predicted - cost, max=-_TINY)

        cost_new = trial_cost(cams_new, pts_new)
        rho = (cost_new - cost) / denominator
        accept_t = (cost_new < cost) & ~converged
        accept = bool(accept_t)

        if accept:
            cameras, points = cams_new, pts_new
            r, Jc, Jp, system, _ = linearize(cameras, points)
        g_inf = torch.maximum(system.g_cam.abs().max(),
                              system.g_pt.abs().max())
        stop_t = converged | (accept_t & (g_inf <= algo_opt.epsilon1))
        trace_k = torch.stack([cost_new, g_inf, region, rho]).cpu()
        if accept:
            region = region / torch.maximum(
                third, 1.0 - (2.0 * rho - 1.0) ** 3)
            cost = cost_new
            v = torch.full_like(v, 2.0)
            accepted += 1
        else:
            region = region / v
            v = v * 2.0
        trace.record(
            k, cost=trace_k[0], grad_inf_norm=trace_k[1],
            trust_region=trace_k[2], rho=trace_k[3], accept=accept,
            pcg_iters=pcg.iterations, pcg_eta=solver_opt.tol,
            pcg_r0_ratio=1.0)  # every PCG starts cold: no warm start
        pcg_total += pcg.iterations
        stop = bool(stop_t)
        if verbose:
            c = float(trace_k[0])
            print(f"iter {k}: cost {c:.6e} accept {accept} "
                  f"pcg_iters {pcg.iterations} "
                  f"elapsed {(time.perf_counter() - t0) * 1e3:.1f} ms",
                  flush=True)
        k += 1

    status = derive_status(stopped=stop, accepted=accepted)
    return LMResult(
        cameras=cameras, points=points, cost=cost, initial_cost=cost0,
        iterations=k, accepted=accepted, pcg_iterations=pcg_total,
        region=region, v=v, stopped=stop, trace=trace, status=status)

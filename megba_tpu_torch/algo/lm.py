"""Levenberg-Marquardt trust-region outer loop (PyTorch).

Counterpart of `megba_tpu/algo/lm.py:lm_solve`: damp, solve the Schur
system (or, with `use_schur=False`, the full system through
`plain_pcg_solve`), test ||dx|| <= eps2 (||x|| + eps1), measure the gain
ratio rho against the linearised cost Sum (J dx + r)^2, then accept
(relinearise, region /= max(1/3, 1 - (2 rho - 1)^3), stop when
||g||_inf <= eps1) or reject (region /= v, v *= 2).  With a robust loss
the system is built from the IRLS-reweighted rows, the accept test uses
Sum rho and the model decrease is measured from the weighted cost.
`SolverOption.forcing` drives the PCG tolerance by the Eisenstat-Walker
schedule, and `warm_start` seeds each PCG with the last accepted step.

`RobustOption(guards=True)` contains faults (JAX lm.py:465-611): a step
whose trial cost, step norm or PCG residual energy is not finite, or
whose PCG exited broken, is rolled back (the carried state already is
the last accepted one), the system is relinearised there, the trust
region is divided by `damping_inflation`, and after more than
`max_recoveries` consecutive failures the solve stops FATAL_NONFINITE;
a finite step taken from a non-finite carried cost is adopted.  A
`FaultPlan` (robustness/faults.py) poisons residuals and crushes Hll
blocks at stamped iterations: the pre-loop linearisation is stamped 0,
the trial point and the relinearisation at carry k both k.

The JAX `lax.while_loop` becomes a Python loop and its `lax.cond`
relinearisation a Python `if`; the host reads the accept (and recover)
flags and the stop flag once each per iteration, the trace values in one
transfer, and the forcing term and the warm-start carry stay on the
device.  Trial points are costed by the engine's value-only
residual (`ops.residuals.residual_only`): eager PyTorch has no dead-code
elimination to drop an unused Jacobian and Schur build, so the full
linearisation runs only on an accepted step.

The loop runs over a mesh (`plans` a `parallel.mesh.ShardedPlans`; one
device is a mesh of one shard): every edge array is a tuple of
per-shard tensors, the residuals, Jacobians, costs and the predicted
J.dx run per shard on its device, and the cost sums (compensated per
shard, JAX lm.py:289-297 and 441) are summed across the shards; the
parameters, the system and every LM scalar are replicated state, held
once on the first shard's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from megba_tpu_torch.analysis import census
from megba_tpu_torch.common import (
    PrecondKind,
    PreconditionerKind,
    ProblemOption,
    RobustKind,
    SolveStatus,
)
from megba_tpu_torch.linear_system.builder import (
    build_schur_system,
    weight_system_inputs,
)
from megba_tpu_torch.observability.emit import (
    emit_verbose_iteration,
    next_verbose_token,
)
from megba_tpu_torch.observability.trace import SolveTrace
from megba_tpu_torch.ops.accum import comp_sum, comp_sum_sq
from megba_tpu_torch.ops.residuals import (
    apply_sqrt_info_residual,
    make_residual_jacobian_fn,
    residual_only,
)
from megba_tpu_torch.ops.robust import rho_and_weight, robustify
from megba_tpu_torch.ops import segtiles
from megba_tpu_torch.parallel.collectives import for_shards, psum
from megba_tpu_torch.parallel.mesh import ShardedPlans
from megba_tpu_torch.robustness.faults import (
    FaultPlan,
    poison_residuals,
    poison_system,
)
from megba_tpu_torch.solver.pcg import plain_pcg_solve, schur_pcg_solve
from megba_tpu_torch.solver.precond import FALLBACK_BLOCK_RADIX

_TINY = 1e-30


def initial_forcing_eta(eta_min: torch.Tensor,
                        eta_max: torch.Tensor) -> torch.Tensor:
    """Eisenstat-Walker start: half the RHS energy removed is plenty for
    the first linearisation, never looser than the cap."""
    return torch.clamp(torch.clamp(eta_max, max=0.5), min=eta_min)


def eisenstat_walker_eta(eta_prev, cost_new, cost_prev, rho, accept,
                         eta_min, eta_max):
    """One Eisenstat-Walker choice-2 forcing update (gamma 0.9, alpha 2),
    on device scalars.

    Costs are squared norms, so their ratio is the norm ratio squared.
    Safeguarded against over-tightening while the previous eta was still
    loose, loosened when the gain ratio trusts the linear model,
    tightened on a reject; clamped to [eta_min, eta_max].
    """
    ratio2 = cost_new / torch.clamp(cost_prev, min=_TINY)
    eta_ew = 0.9 * ratio2
    safeguard = 0.9 * eta_prev * eta_prev
    eta_ew = torch.where(safeguard > 0.1, torch.maximum(eta_ew, safeguard),
                         eta_ew)
    eta_ew = torch.where(rho > 0.75, 2.0 * eta_ew, eta_ew)
    return torch.where(accept,
                       torch.clamp(torch.maximum(eta_ew, eta_min),
                                   max=eta_max),
                       torch.maximum(0.25 * eta_prev, eta_min))


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
    cost: torch.Tensor  # final accepted cost (Sum rho with a robust loss)
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
    # Under SolverOption.warm_start: the last accepted camera step, laid
    # out like `cameras` (the resume hook `initial_dx`); None otherwise.
    dx_cam: Optional[torch.Tensor] = None
    # flat_solve under TWO_LEVEL / MULTILEVEL: seconds spent planning the
    # camera clusters on the host and moving the plan to the device, or,
    # when the plan came from the host plan cache (a
    # `cluster_plan_cache_hit`), the seconds of the lookup (the stream's
    # sort and digests); None otherwise.
    coarse_plan_seconds: Optional[float] = None


def lm_solve(
    cameras: torch.Tensor,
    points: torch.Tensor,
    obs: Tuple[torch.Tensor, ...],
    cam_idx: Tuple[torch.Tensor, ...],
    pt_idx: Tuple[torch.Tensor, ...],
    mask: Tuple[torch.Tensor, ...],
    option: ProblemOption,
    plans: ShardedPlans,
    sqrt_info: Optional[Tuple[torch.Tensor, ...]] = None,
    cam_fixed: Optional[torch.Tensor] = None,
    pt_fixed: Optional[torch.Tensor] = None,
    verbose: bool = False,
    residual_jac_fn: Optional[Callable] = None,
    initial_region=None,
    initial_v=None,
    initial_dx: Optional[torch.Tensor] = None,
    fault_plan: Optional[Tuple[FaultPlan, ...]] = None,
    cluster_plan=None,
) -> LMResult:
    """Run the LM loop to convergence over the mesh of `plans`
    (parallel/mesh.py; parallel.mesh.distributed_lm_solve builds it).

    FEATURE-MAJOR contract, at the engine's widths (BAL: cd 9, pd 3,
    od = rd = 2): cameras [cd, Nc], points [pd, Np] on the first shard's
    device; obs [od, n_k], cam_idx, pt_idx, mask, sqrt_info [rd*rd, n_k]
    and `fault_plan` are tuples, one entry per shard on its
    device (a shard's fault plan carries its own edge poison), each edge
    array in its shard's cam plan slot order (solve.flat_solve arranges
    this).  Jp is carried in pt-slot order,
    so both Hessian sides and both coupling products reduce over sorted
    segments.  With `option.compute_kind` EXPLICIT the Schur system also
    carries the coupling rows W, and with `solver_option.fused_kernels`
    each shard's plans must carry the fused directions
    (ops/fused.with_fused_plans);
    the precision rungs (`mixed_precision_pcg`, `solver_option.bf16`)
    reach the PCG only.

    `residual_jac_fn` is the engine (ops.residuals; None: the BAL engine
    of `option.jacobian_mode`); its value-only residual
    (`residual_only`) costs the trial points.
    `initial_region` / `initial_v` replace the trust-region start state,
    and `initial_dx` ([cd, Nc]) seeds the warm-start carry under
    `SolverOption.warm_start`: the resume hooks of a split solve.
    `fault_plan` injects seeded faults; `option.robust_option.guards`
    contains them.  `cluster_plan` is the coarse space of
    `SolverOption.precond` TWO_LEVEL or MULTILEVEL, split over the
    shards (ops/segtiles.device_sharded_coarse_plan).
    """
    if residual_jac_fn is None:
        residual_jac_fn = make_residual_jacobian_fn(mode=option.jacobian_mode)
    residual_fn = residual_only(residual_jac_fn)
    num_cameras = cameras.shape[1]
    num_points = points.shape[1]
    algo_opt = option.algo_option
    solver_opt = option.solver_option
    robust_opt = option.robust_option
    guards = robust_opt.guards
    robust, delta = option.robust_kind, option.robust_delta
    forcing, warm_start = solver_opt.forcing, solver_opt.warm_start
    use_schur = option.use_schur
    dtype, device = cameras.dtype, cameras.device
    # The trace records the preconditioner fallback whenever a block
    # diagonal or operator with a fallback is live (JAX lm.py:561-570).
    fallback_live = (solver_opt.preconditioner == PreconditionerKind.SCHUR_DIAG
                     or solver_opt.precond != PrecondKind.JACOBI)
    if (use_schur and cluster_plan is None
            and solver_opt.precond in (PrecondKind.TWO_LEVEL,
                                       PrecondKind.MULTILEVEL)):
        raise ValueError(
            f"SolverOption.precond={solver_opt.precond.name} needs a "
            "camera-cluster plan operand: solve through flat_solve (which "
            "plans it) or pass cluster_plan="
            "ops.segtiles.device_cluster_plan(...) / "
            "device_multilevel_plan(...)")

    # The edge side, one record per shard.
    n_sh = len(plans.shards)
    faults = fault_plan if fault_plan is not None else (None,) * n_sh
    shards = list(zip(obs, cam_idx, pt_idx, mask,
                      sqrt_info if sqrt_info is not None else (None,) * n_sh,
                      plans.shards, faults, plans.devices))

    def reduce(parts):
        return psum(parts, device)

    def scalar(x):
        return torch.tensor(x, dtype=dtype, device=device)

    def edge_linearize(sh, cams, pts, k):
        ob, ci, pi, m, si, pl, fp, dev = sh
        cf = None if cam_fixed is None else cam_fixed.to(dev)
        pf = None if pt_fixed is None else pt_fixed.to(dev)
        r, Jc, Jp = residual_jac_fn(
            cams.to(dev).index_select(1, ci), pts.to(dev).index_select(1, pi),
            ob)
        r, Jc, Jp = weight_system_inputs(r, Jc, Jp, ci, pi, m, si, cf, pf)
        if fp is not None:
            r = poison_residuals(r, fp, k)
        if robust == RobustKind.NONE:
            cost = wcost = comp_sum_sq(r)
        else:
            # The system is built from the reweighted rows; the accept
            # test uses Sum rho, the model decrease the weighted cost.
            r, Jc, Jp, rho_e = robustify(r, Jc, Jp, robust, delta)
            cost, wcost = comp_sum(rho_e), comp_sum_sq(r)
        return r, Jc, pl.to_pt(Jp), cost, wcost

    def linearize(cams, pts, k):
        out = for_shards(lambda sh: edge_linearize(sh, cams, pts, k), shards)
        r, Jc, Jp = (tuple(o[i] for o in out) for i in range(3))
        cost, wcost = (reduce([o[i] for o in out]) for i in (3, 4))
        system = build_schur_system(r, Jc, Jp, plans, num_cameras,
                                    num_points, cam_fixed, pt_fixed,
                                    option.compute_kind)
        if faults[plans.mesh.home] is not None:
            system = poison_system(system, faults[plans.mesh.home], k)
        return r, Jc, Jp, system, cost, wcost

    def edge_trial_cost(sh, cams, pts, k):
        ob, ci, pi, m, si, _, fp, dev = sh
        r = residual_fn(cams.to(dev).index_select(1, ci),
                        pts.to(dev).index_select(1, pi), ob)
        r = apply_sqrt_info_residual(r, si) * m[None, :]
        if fp is not None:
            r = poison_residuals(r, fp, k)
        if robust == RobustKind.NONE:
            return comp_sum_sq(r)
        return comp_sum(rho_and_weight((r * r).sum(0), robust, delta)[0])

    def trial_cost(cams, pts, k):
        return reduce(for_shards(
            lambda sh: edge_trial_cost(sh, cams, pts, k), shards))

    def edge_predicted(sh, dx_cam, dx_pt, r_k, Jc_k, Jp_k):
        # The linearised (weighted) residual J dx + r, from the unscaled
        # full-precision Jc/Jp whatever the PCG's precision rung.  Jp is
        # pt-ordered, so its [od] rows hop to cam order.
        pl, dev = sh[5], sh[7]
        dc, dp = dx_cam.to(dev), dx_pt.to(dev)
        jc_dx = segtiles.coupling_expand(dc, Jc_k, pl.cam, dc.shape[0])
        jp_dx = pl.to_cam(
            segtiles.coupling_expand(dp, Jp_k, pl.pt, dp.shape[0]))
        return comp_sum_sq(jc_dx + jp_dx + r_k)

    r, Jc, Jp, system, cost, wcost = linearize(cameras, points, 0)
    cost0 = cost
    region = scalar(algo_opt.initial_region if initial_region is None
                    else initial_region)
    v = scalar(2.0 if initial_v is None else initial_v)
    third = scalar(1.0 / 3.0)
    inflation = scalar(robust_opt.damping_inflation)
    # eta_k is a norm-relative forcing term and the PCG threshold is on
    # the residual energy, so eta rides squared into the PCG with
    # tol_relative on; with forcing, `tol` is eta's cap.
    eta_min, eta_max = scalar(solver_opt.eta_min), scalar(solver_opt.tol)
    eta = initial_forcing_eta(eta_min, eta_max) if forcing else eta_max
    dx0 = None
    if warm_start:
        dx0 = (torch.zeros_like(cameras) if initial_dx is None
               else initial_dx.to(dtype))
        if not use_schur:  # the plain solver warm-starts the pair
            dx0 = (dx0, torch.zeros_like(points))
    pcg_kw = dict(
        max_iter=solver_opt.max_iter, refuse_ratio=solver_opt.refuse_ratio,
        compute_kind=option.compute_kind,
        mixed_precision=option.mixed_precision_pcg, bf16=solver_opt.bf16,
        guard=guards,
        max_restarts=robust_opt.pcg_max_restarts if guards else 0)
    if use_schur:
        pcg_solve = schur_pcg_solve
        pcg_kw.update(fused_kernels=solver_opt.fused_kernels,
                      bf16_collectives=solver_opt.bf16_collectives,
                      precond=solver_opt.precond,
                      preconditioner=solver_opt.preconditioner,
                      neumann_order=solver_opt.neumann_order,
                      cluster_plan=cluster_plan, cam_fixed=cam_fixed,
                      smooth_omega=solver_opt.smooth_omega)
    else:
        pcg_solve = plain_pcg_solve
    trace = SolveTrace.empty(algo_opt.max_iter, dtype)
    k = accepted = pcg_total = recoveries = fail_streak = 0
    stop = fatal = False
    token = next_verbose_token() if verbose else None
    while k < algo_opt.max_iter and not stop:
        census.mark("lm")
        pcg = pcg_solve(
            system, Jc, Jp, plans, region,
            tol=eta * eta if forcing else solver_opt.tol,
            tol_relative=forcing or solver_opt.tol_relative, x0=dx0,
            **pcg_kw)
        dx_cam, dx_pt = pcg.dx_cam, pcg.dx_pt

        # ||dx|| <= eps2 (||x|| + eps1) -> converged, the step is not applied.
        dx_norm = torch.sqrt((dx_cam * dx_cam).sum() + (dx_pt * dx_pt).sum())
        x_norm = torch.sqrt((cameras ** 2).sum() + (points ** 2).sum())
        converged = dx_norm <= algo_opt.epsilon2 * (x_norm + algo_opt.epsilon1)
        cams_new = cameras + dx_cam
        pts_new = points + dx_pt

        # Gain-ratio denominator: the linearised (weighted) cost at dx
        # minus the weighted cost.
        predicted = reduce(for_shards(
            lambda sh, r_k, jc, jp: edge_predicted(sh, dx_cam, dx_pt, r_k,
                                                   jc, jp),
            shards, r, Jc, Jp))
        denominator = torch.clamp(predicted - wcost, max=-_TINY)

        cost_new = trial_cost(cams_new, pts_new, k)
        rho = (cost_new - cost) / denominator
        accept_t = (cost_new < cost) & ~converged
        if guards:
            # A non-finite trial cost, step or PCG residual energy (a
            # poisoned carried system exits its PCG at once), or a PCG
            # that exited broken, is a failed step: roll it back.  A
            # finite step from a non-finite carried cost is adopted.
            step_bad = ~(torch.isfinite(cost_new) & torch.isfinite(dx_norm)
                         & torch.isfinite(pcg.rho)) | pcg.broken
            converged = converged & ~step_bad
            adopt = ~torch.isfinite(cost) & ~step_bad & ~converged
            accept_t = (accept_t & ~step_bad) | adopt
            accept, recover = torch.stack([accept_t, step_bad]).tolist()
        else:
            accept, recover = bool(accept_t), False
        eta_k = eta
        if forcing:
            eta = eisenstat_walker_eta(eta, cost_new, cost, rho, accept_t,
                                       eta_min, eta_max)
            # A non-finite update restarts the schedule at the cap.
            eta = torch.where(torch.isfinite(eta), eta, eta_max)
        if warm_start:
            # A reject changes the damped system sharply: start the next
            # PCG cold, bitwise as without warm starts.
            step = (dx_cam,) if use_schur else (dx_cam, dx_pt)
            if not accept:
                step = tuple(torch.zeros_like(d) for d in step)
            dx0 = step[0] if use_schur else step

        if accept:
            cameras, points = cams_new, pts_new
            r, Jc, Jp, system, _, wcost = linearize(cameras, points, k)
        elif recover:
            # Relinearise at the rolled-back point, healing a poisoned
            # carried system; the carried costs stay.
            r, Jc, Jp, system, _, _ = linearize(cameras, points, k)
        g_inf = torch.maximum(system.g_cam.abs().max(),
                              system.g_pt.abs().max())
        stop_t = converged | (accept_t & (g_inf <= algo_opt.epsilon1))
        # One transfer of the iteration's trace values; the integer
        # counters are exact in either float dtype.
        values = [cost_new, g_inf, region, rho, eta_k,
                  pcg.r0_ratio.to(dtype)]
        if guards:
            values.append(pcg.breakdowns.to(dtype))
        if fallback_live:
            # The code as its two 16-bit halves: each is exact in either
            # float dtype, where the whole code is not in float32.
            code = torch.as_tensor(pcg.precond_fallback, device=device)
            values += [(code // FALLBACK_BLOCK_RADIX).to(dtype),
                       (code % FALLBACK_BLOCK_RADIX).to(dtype)]
        trace_k = torch.stack(values).cpu()
        if accept:
            region_accept = region / torch.maximum(
                third, 1.0 - (2.0 * rho - 1.0) ** 3)
            if guards:
                # An adopted accept has rho = NaN (its denominator ran
                # through the non-finite carried cost): keep the region.
                region_accept = torch.where(torch.isfinite(rho),
                                            region_accept, region)
            region = region_accept
            cost = cost_new
            v = torch.full_like(v, 2.0)
            accepted += 1
        elif recover:
            # Damping inflation in place of the reject back-off.
            region = region / inflation
        else:
            region = region / v
            v = v * 2.0
        robust_trace = {}
        if guards:
            fail_streak = fail_streak + 1 if recover else 0
            recoveries += int(recover)
            fatal = fatal or fail_streak > robust_opt.max_recoveries
            robust_trace = dict(recovery=recover,
                                pcg_breakdown=int(trace_k[6]))
        if fallback_live:
            robust_trace["precond_fallback"] = (
                int(trace_k[-2]) * FALLBACK_BLOCK_RADIX + int(trace_k[-1]))
        trace.record(
            k, cost=trace_k[0], grad_inf_norm=trace_k[1],
            trust_region=trace_k[2], rho=trace_k[3], accept=accept,
            pcg_iters=pcg.iterations, pcg_eta=trace_k[4],
            pcg_r0_ratio=trace_k[5], **robust_trace)
        pcg_total += pcg.iterations
        stop = bool(stop_t) or fatal
        if verbose:
            emit_verbose_iteration(token, k, float(trace_k[0]), accept,
                                   int(pcg.iterations))
        k += 1

    census.mark("lm_done")
    status = derive_status(stopped=stop, accepted=accepted,
                           recoveries=recoveries, fatal=fatal)
    if warm_start and not use_schur:
        dx0 = dx0[0]
    return LMResult(
        cameras=cameras, points=points, cost=cost, initial_cost=cost0,
        iterations=k, accepted=accepted, pcg_iterations=pcg_total,
        region=region, v=v, stopped=stop, trace=trace, status=status,
        recoveries=recoveries, dx_cam=dx0)

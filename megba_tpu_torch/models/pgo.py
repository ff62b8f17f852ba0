"""Pose-graph optimisation (PGO): SE(3) and sim(3) between-factors.

Counterpart of `megba_tpu/models/pgo.py`.  One pose table, edges between
two poses of it, and the LM trust region of the BA loop (algo/lm.py)
over a matrix-free Gauss-Newton operator H x = J^T J x, solved by the
shared PCG core (solver/pcg._pcg_core) with block-Jacobi
preconditioning.  The residual family comes from the factor registry
(`se3_between`, the default, or `sim3_between`, or any registered
`PoseFactorSpec`).

Model (SE(3)): pose = [angle_axis (3), translation (3)]; T maps body ->
world.  A measurement m on edge (i, j) is the expected relative pose
T_ij = T_i^{-1} T_j, and the residual is the right-invariant error

    E   = T_ij^{-1} (T_i^{-1} T_j)
    r   = [ log_SO3(E_R) ; E_t ]           (6 rows)

Jacobians d r / d pose_{i,j} come from forward-mode autodiff of the
exact residual (ops/residuals' AUTODIFF_FORWARD engine, the JAX
package's `jacfwd`), per edge.

The sums on the card.  The JAX driver sums with XLA scatter-adds and
applies its preconditioner with an einsum; here every one of those sums
is a hand-written kernel, over plans built once per solve:

- the two edge orders are the dual plans of ops/segtiles
  (`make_sharded_dual_plans` with the i-side as the "camera" side and
  the j-side as the "point" side): the canonical slot order is the
  stable sort by edge_i, and Jj is carried in the j-side order;
- the gradient and block diagonal are one `jtj_grad_reduce` per side
  (kernel 1, which returns -Sum J^T r);
- the matvec J^T J x is a `coupling_expand` per side (kernel 2), the sum
  of u in the i-side order, then a `coupling_reduce` per side (kernel 3);
  the gain ratio's J dx uses the same expands;
- the preconditioner M^-1 x is `fused_block_diag_apply` (kernel 6) on
  the inverted damped blocks in row form.

On the CPU each wrapper runs its plain version; on the card it launches
its kernel or raises, and nothing falls back.

The JAX `lax.while_loop` is a host loop.  Per LM iteration the host
reads the PCG's exit test once per PCG iteration, the accept flag once
and the stop flag once; with `verbose` also the trial cost.

`option.world_size` N > 1 shards the EDGE axis over the 1-D mesh
(parallel/mesh.py), given N devices that may repeat one: each shard
holds a contiguous piece of the i-sorted (padded) edge stream and its
own plans over all poses, and the five sums of the JAX program (cost
and weighted cost, g and h before the identity guard, the matvec output
before its damping term, the predicted decrease) run through
`parallel.collectives.psum` in shard order.  The poses, the system
diagonal and every LM scalar are held once, on the first device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from megba_tpu_torch.common import (
    DTYPE_TO_TORCH,
    JacobianMode,
    ProblemOption,
    RobustKind,
    resolve_device,
    validate_options,
)
from megba_tpu_torch.core.host_se3 import compose, relative
from megba_tpu_torch.core.types import pad_edges
from megba_tpu_torch.factors.pose_graph import between_residual
from megba_tpu_torch.observability.emit import (
    emit_verbose_iteration,
    next_verbose_token,
)
from megba_tpu_torch.ops import fused, segtiles
from megba_tpu_torch.ops.accum import comp_sum, comp_sum_sq
from megba_tpu_torch.ops.residuals import (
    apply_sqrt_info,
    apply_sqrt_info_residual,
    make_residual_jacobian_fn,
)
from megba_tpu_torch.ops.robust import rho_and_weight, robustify
from megba_tpu_torch.parallel.collectives import for_shards, psum
from megba_tpu_torch.parallel.mesh import (
    make_mesh,
    make_process_mesh,
    multiprocess_active,
    resolve_devices,
)
from megba_tpu_torch.parallel.multihost import dispatch_on_mesh

POSE_DIM = 6
_TINY = 1e-30

__all__ = [
    "POSE_DIM",
    "PGOResult",
    "SyntheticPoseGraph",
    "between_residual",
    "make_synthetic_pose_graph",
    "solve_pgo",
    "spanning_tree_init",
    "with_priors",
]


class PGOResult(NamedTuple):
    """The JAX package's `PGOResult` fields.  Tensors on the solve's
    first device (poses [N, pd] edge-major, costs, region, v); the
    counters, `stopped` and `status` (a common.SolveStatus code) are
    host values, as in the port's `LMResult`."""

    poses: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: int
    accepted: int
    pcg_iterations: int
    region: torch.Tensor
    v: torch.Tensor  # trust-region back-off factor (resume state)
    stopped: bool
    status: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class _Shard:
    """One shard's edges, in its i-side slot order, on its device."""

    ei: torch.Tensor  # [n] int64 pose i per slot
    ej: torch.Tensor  # [n] int64 pose j per slot
    meas: torch.Tensor  # [md, n]
    sqrt_info: Optional[torch.Tensor]  # [rd*rd, n]
    emask: Optional[torch.Tensor]  # [n]: 0 on padding edges
    free_i: torch.Tensor  # [n]: 0 where pose i is fixed
    free_j: torch.Tensor
    plans: segtiles.DualPlans  # cam = the i-side, pt = the j-side
    device: torch.device


def _shard_edges(edge_i, edge_j, meas, sqrt_info, emask, fixed, devices,
                 n_poses, tdtype):
    """Plan each shard's two sides (the i-sorted stream cut into
    len(devices) pieces) and move its edge arrays there, in slot order;
    a shard of another process (device None) is None."""
    perms, plans = segtiles.make_sharded_dual_plans(
        edge_i, edge_j, n_poses, n_poses, devices)
    shards = []
    for perm, pl, dev in zip(perms, plans, devices):
        if dev is None:
            shards.append(None)
            continue
        def rows(a):
            a = a[perm].reshape(perm.shape[0], -1)
            return torch.from_numpy(np.ascontiguousarray(a.T)).to(dev, tdtype)

        ei = torch.from_numpy(edge_i[perm].astype(np.int64)).to(dev)
        ej = torch.from_numpy(edge_j[perm].astype(np.int64)).to(dev)
        fx = fixed.to(dev)
        shards.append(_Shard(
            ei=ei, ej=ej, meas=rows(meas),
            sqrt_info=None if sqrt_info is None else rows(sqrt_info),
            emask=(None if emask is None
                   else torch.from_numpy(emask[perm]).to(dev, tdtype)),
            free_i=1.0 - fx.index_select(0, ei).to(tdtype),
            free_j=1.0 - fx.index_select(0, ej).to(tdtype),
            plans=pl, device=dev))
    return shards


def _linearize(sh: _Shard, poses: torch.Tensor, engine, robust,
               robust_delta):
    """One shard's r [rd, n] and Ji (i-side order) / Jj (j-side order)
    [rd*pd, n], sqrt-information weighted, fixed-masked, padding-masked
    and IRLS-reweighted (JAX pgo.py:90-147), with its cost (Sum rho
    under a robust loss) and weighted cost."""
    p = poses.to(sh.device)
    r, Ji, Jj = engine(p.index_select(1, sh.ei), p.index_select(1, sh.ej),
                       sh.meas)
    r, Ji, Jj = apply_sqrt_info(r, Ji, Jj, sh.sqrt_info)
    # Gauge / fixed poses contribute no Jacobian columns.
    Ji = Ji * sh.free_i[None, :]
    Jj = Jj * sh.free_j[None, :]
    if sh.emask is not None:
        r = r * sh.emask[None, :]
        Ji = Ji * sh.emask[None, :]
        Jj = Jj * sh.emask[None, :]
    if robust == RobustKind.NONE:
        cost = wcost = comp_sum_sq(r)
    else:
        # Padding edges are inert: r = 0 -> rho = 0, w = 1.
        r, Ji, Jj, rho_e = robustify(r, Ji, Jj, robust, robust_delta)
        cost, wcost = comp_sum(rho_e), comp_sum_sq(r)
    return r, Ji, sh.plans.to_pt(Jj), cost, wcost


def _trial_cost(sh: _Shard, poses: torch.Tensor, residual_fn, robust,
                robust_delta):
    """One shard's cost at a trial point, from the value-only residual."""
    p = poses.to(sh.device)
    r = residual_fn(p.index_select(1, sh.ei), p.index_select(1, sh.ej),
                    sh.meas)
    r = apply_sqrt_info_residual(r, sh.sqrt_info)
    if sh.emask is not None:
        r = r * sh.emask[None, :]
    if robust == RobustKind.NONE:
        return comp_sum_sq(r)
    return comp_sum(rho_and_weight((r * r).sum(0), robust, robust_delta)[0])


def _grad_diag_parts(sh: _Shard, r, Ji, Jj):
    """One shard's (-g [pd, N], h rows [pd*pd, N]): kernel 1 on each
    side, summed i-side first."""
    pl = sh.plans
    hi, gi = segtiles.jtj_grad_reduce(Ji, r, pl.cam)
    hj, gj = segtiles.jtj_grad_reduce(Jj, pl.to_pt(r), pl.pt)
    return gi + gj, hi + hj


def _expand(sh: _Shard, x, Ji, Jj, pd):
    """u = Ji x[ei] + Jj x[ej] per edge [rd, n], in the i-side order."""
    pl = sh.plans
    x = x.to(sh.device)
    return (segtiles.coupling_expand(x, Ji, pl.cam, pd)
            + pl.to_cam(segtiles.coupling_expand(x, Jj, pl.pt, pd)))


def _matvec_part(sh: _Shard, x, Ji, Jj, pd):
    """One shard's J^T J x [pd, N]: kernels 2 then 3 on each side."""
    pl = sh.plans
    u = _expand(sh, x, Ji, Jj, pd)
    return (segtiles.coupling_reduce(Ji, u, pl.cam, pd)
            + segtiles.coupling_reduce(Jj, pl.to_pt(u), pl.pt, pd))


def solve_pgo(
    poses0: np.ndarray,
    edge_i: np.ndarray,
    edge_j: np.ndarray,
    meas: np.ndarray,
    option: Optional[ProblemOption] = None,
    sqrt_info: Optional[np.ndarray] = None,
    fixed: Optional[np.ndarray] = None,
    verbose: bool = False,
    initial_region: Optional[float] = None,
    initial_v: Optional[float] = None,
    factor="se3_between",
    device: Union[None, str, torch.device, Sequence] = None,
) -> PGOResult:
    """Solve a pose graph.  PUBLIC edge-major boundary.

    poses0 [N, pd], edge_i/edge_j [nE] int, meas [nE, md],
    sqrt_info [nE, rd, rd] optional, fixed [N] bool (pose 0 is fixed by
    default: the gauge anchor), with (pd, md, rd) from the registered
    pose-graph `factor`: `"se3_between"` (6/6/6), `"sim3_between"`
    (7/7/7, whose PCG refuse_ratio default of 16 is applied), or any
    registered `factors.PoseFactorSpec`.  A Schur (camera/point) factor
    name raises a typed `FactorError`; an unknown name
    `UnknownFactorError`.  LM trust-region semantics and PCG stopping are
    the BA path's (algo/lm.py, solver/pcg.py); `initial_region` /
    `initial_v` replace the trust-region start state.

    `option.world_size` N > 1 shards the edge axis over N shards;
    `device` is then a sequence of N devices (which may repeat one) or
    None (the first N visible cards); across the processes of a process
    group (parallel/multihost.initialize_multihost) each process passes
    its own device(s) and the whole graph, and every process gets the
    one-process world-N result, bitwise.  With one shard `device` is one
    device, or None for `option.device` (the card by default).
    `option.robust_kind` / `robust_delta` enable IRLS robust losses
    (Huber / Cauchy); `result.cost` is then Sum rho.

    The JAX package's `lower_only` (the Lowered XLA program, for its
    program auditor) has no counterpart here: the port runs eagerly and
    has no program to lower.
    """
    # The PGO family records no solve report: the observability knobs
    # are dropped, as the JAX package's strip_observability does.
    option = dataclasses.replace(option or ProblemOption(), telemetry=None,
                                 metrics=False)
    # Registry dispatch (lazy: the factor modules are registered by the
    # factors package, which this module's import does not need).
    from megba_tpu_torch.factors import get_factor
    from megba_tpu_torch.factors.registry import (
        apply_factor_solver_defaults,
        require_pose_graph,
    )

    spec = require_pose_graph(get_factor(factor), "solve_pgo")
    option = apply_factor_solver_defaults(spec, option)
    validate_options(option)
    pd, md, rd = spec.pose_dim, spec.meas_dim, spec.residual_dim
    if int(poses0.shape[1]) != pd:
        raise ValueError(
            f"solve_pgo: poses0 width {int(poses0.shape[1])} does not "
            f"match factor {spec.name!r} pose_dim {pd}")
    if np.asarray(meas).ndim != 2 or int(np.asarray(meas).shape[1]) != md:
        raise ValueError(
            f"solve_pgo: meas width "
            f"{np.asarray(meas).shape[1:] or '?'} does not match factor "
            f"{spec.name!r} meas_dim {md}")
    dtype = np.dtype(option.dtype)
    tdtype = DTYPE_TO_TORCH[dtype]
    n_poses = int(poses0.shape[0])
    world = int(option.world_size)
    if world > 1 and multiprocess_active():
        # Across the process group: this process's shards on `device`
        # (parallel/multihost.py).
        mesh = make_process_mesh(world, device, default=option.device.value)
    else:
        if world > 1:
            devices = resolve_devices(world, device,
                                      default=option.device.value)
        else:
            if isinstance(device, (list, tuple)):
                device = resolve_devices(1, device)[0]
            devices = (resolve_device(device, option),)
        mesh = make_mesh(world, devices)
    dev0 = mesh.home_device

    # Host-side prep: pad the edge axis to a multiple of world_size with
    # masked-out edges (core/types.pad_edges, the JAX package's padding
    # contract; the CSR plans themselves need none).
    edge_i = np.asarray(edge_i, np.int32)
    edge_j = np.asarray(edge_j, np.int32)
    meas_np = np.asarray(meas)
    si_np = None if sqrt_info is None else np.asarray(sqrt_info)
    if si_np is not None and si_np.shape[1:] != (rd, rd):
        raise ValueError(
            f"solve_pgo: sqrt_info must be [nE, {rd}, {rd}] for factor "
            f"{spec.name!r}, got {si_np.shape}")
    n_pad = (-edge_i.shape[0]) % world
    emask = None
    if n_pad:
        meas_np, edge_i, edge_j, emask = pad_edges(
            meas_np, edge_i, edge_j, world, dtype=np.float64)
        if si_np is not None:
            si_np = np.concatenate(
                [si_np, np.zeros((n_pad, rd, rd), si_np.dtype)])

    if fixed is None:
        fixed_np = np.zeros(n_poses, bool)
        fixed_np[0] = True
    else:
        fixed_np = np.asarray(fixed, bool)
    fixed_t = torch.from_numpy(fixed_np.copy()).to(dev0)
    shards = _shard_edges(
        edge_i, edge_j, meas_np.astype(dtype, copy=False),
        None if si_np is None else si_np.astype(dtype, copy=False),
        emask, fixed_t, mesh.devices, n_poses, tdtype)
    poses = torch.from_numpy(np.ascontiguousarray(
        np.asarray(poses0).T).astype(dtype, copy=False)).to(dev0)
    region0 = (option.algo_option.initial_region if initial_region is None
               else initial_region)
    v0 = 2.0 if initial_v is None else initial_v
    out = dispatch_on_mesh(
        lambda: _run(poses, fixed_t, shards, option, spec, region0, v0,
                     verbose), mesh)
    result = PGOResult(poses=out.pop("poses").T.contiguous(), **out)
    if verbose:
        print(f"PGO: cost {float(result.initial_cost):.6e} -> "
              f"{float(result.cost):.6e} in {result.iterations} LM iters "
              f"({result.accepted} accepted, {result.pcg_iterations} PCG)",
              flush=True)
    return result


def _run(poses, fixed, shards, option, spec, region0, v0, verbose) -> dict:
    """The LM loop (JAX pgo.py:404-577) on feature-major poses [pd, N]."""
    from megba_tpu_torch.algo.lm import (
        derive_status,
        eisenstat_walker_eta,
        initial_forcing_eta,
    )
    from megba_tpu_torch.solver.pcg import _pcg_core
    from megba_tpu_torch.solver.precond import block_inv

    algo_opt, solver_opt = option.algo_option, option.solver_option
    robust, delta = option.robust_kind, option.robust_delta
    forcing, warm_start = solver_opt.forcing, solver_opt.warm_start
    pd = spec.pose_dim
    n_poses = poses.shape[1]
    dtype, dev0 = poses.dtype, poses.device
    engine = make_residual_jacobian_fn(spec.residual_fn,
                                       JacobianMode.AUTODIFF_FORWARD)

    def scalar(x):
        return torch.tensor(x, dtype=dtype, device=dev0)

    def linearize(p):
        out = for_shards(lambda sh: _linearize(sh, p, engine, robust, delta),
                         shards)
        r, Ji, Jj = (tuple(o[i] for o in out) for i in range(3))
        cost, wcost = (psum([o[i] for o in out], dev0) for i in (3, 4))
        return r, Ji, Jj, cost, wcost

    def grad_and_diag(r, Ji, Jj):
        # Sharded solves sum g and h BEFORE the identity guard: a pose
        # whose edges all live on other shards must see the global sum.
        parts = for_shards(_grad_diag_parts, shards, r, Ji, Jj)
        g = -psum([gp for gp, _ in parts], dev0)
        h = psum([hp for _, hp in parts], dev0)
        # Fixed (and unobserved) poses get identity blocks, so the damped
        # preconditioner stays invertible; their gradient is zero, so PCG
        # leaves them untouched.
        eye = torch.eye(pd, dtype=dtype, device=dev0).reshape(pd * pd, 1)
        guard = fixed | (h[0] == 0)
        h = torch.where(guard[None, :], eye, h)
        g = g * (1.0 - fixed.to(dtype))[None, :]
        return g, h

    def step_system(g, h_rows, Ji, Jj, region, tol, x0):
        damp = 1.0 + 1.0 / region
        h_blocks = h_rows.reshape(pd, pd, n_poses).permute(2, 0, 1)
        # Diagonal ENTRIES of each pd x pd block: rows 0, pd+1, ... of
        # the [pd*pd, N] row store.
        h_diag = h_rows[:: pd + 1]
        eye = torch.eye(pd, dtype=dtype, device=dev0)
        minv = fused.block_diag_rows(
            block_inv(h_blocks * (eye * (damp - 1.0) + 1.0)))

        def matvec(x):  # [pd, N] -> [pd, N]: damped H x, matrix-free
            out = psum(for_shards(
                lambda sh, ji, jj: _matvec_part(sh, x, ji, jj, pd),
                shards, Ji, Jj), dev0)
            # LM damping scales the diagonal ENTRIES by (1 + 1/region),
            # added after the sum: x and h_diag are replicated.
            return out + h_diag * x * (damp - 1.0)

        def precond(x):
            return fused.fused_block_diag_apply(minv, x)

        dx, iters, _, _, _, _ = _pcg_core(
            matvec, precond, -g, solver_opt.max_iter, tol,
            solver_opt.refuse_ratio,
            True if forcing else solver_opt.tol_relative, x0=x0)
        return dx, iters

    r, Ji, Jj, cost, wcost = linearize(poses)
    cost0 = cost
    g, h_rows = grad_and_diag(r, Ji, Jj)
    region, v = scalar(region0), scalar(v0)
    third = scalar(1.0 / 3.0)
    # Inexact-LM knobs, the BA loop's semantics (algo/lm.py).
    eta_min, eta_max = scalar(solver_opt.eta_min), scalar(solver_opt.tol)
    eta = initial_forcing_eta(eta_min, eta_max) if forcing else None
    dx0 = torch.zeros_like(poses) if warm_start else None
    k = accepted = pcg_total = 0
    stop = False
    token = next_verbose_token() if verbose else None
    while k < algo_opt.max_iter and not stop:
        dx, pcg_iters = step_system(g, h_rows, Ji, Jj, region,
                                    eta * eta if forcing else solver_opt.tol,
                                    dx0)
        dx_norm = torch.sqrt((dx * dx).sum())
        x_norm = torch.sqrt((poses ** 2).sum())
        converged = dx_norm <= algo_opt.epsilon2 * (x_norm
                                                    + algo_opt.epsilon1)
        poses_new = poses + dx

        # Gain ratio as the BA loop: predicted = ||J dx + r||^2, summed
        # over the shards, against the carried weighted cost; the
        # denominator is clamped sign-preservingly.
        predicted = psum(for_shards(
            lambda sh, r_k, ji, jj: comp_sum_sq(
                _expand(sh, dx, ji, jj, pd) + r_k),
            shards, r, Ji, Jj), dev0)
        denominator = torch.clamp(predicted - wcost, max=-_TINY)
        cost_new = psum(for_shards(
            lambda sh: _trial_cost(sh, poses_new, spec.residual_fn, robust,
                                   delta), shards), dev0)
        rho = (cost_new - cost) / denominator
        accept_t = (cost_new < cost) & ~converged
        accept = bool(accept_t)
        # An accept relinearises AND rebuilds g / h, so the gradient stop
        # reads the accepted point's gradient and the next iteration
        # reuses the carry.
        if accept:
            r, Ji, Jj, _, wcost = linearize(poses_new)
            g, h_rows = grad_and_diag(r, Ji, Jj)
            g_inf = g.abs().max()
        if forcing:
            eta = eisenstat_walker_eta(eta, cost_new, cost, rho, accept_t,
                                       eta_min, eta_max)
        if warm_start:
            dx0 = dx if accept else torch.zeros_like(dx)
        if accept:
            region = region / torch.maximum(
                third, 1.0 - (2.0 * rho - 1.0) ** 3)
            v = torch.full_like(v, 2.0)
            poses, cost = poses_new, cost_new
            accepted += 1
            stop = bool(converged | (g_inf <= algo_opt.epsilon1))
        else:
            region = region / v
            v = v * 2.0
            stop = bool(converged)
        pcg_total += pcg_iters
        if verbose:
            emit_verbose_iteration(token, k, float(cost_new), accept,
                                   int(pcg_iters))
        k += 1
    return dict(
        poses=poses, cost=cost, initial_cost=cost0, iterations=k,
        accepted=accepted, pcg_iterations=pcg_total, region=region, v=v,
        stopped=stop, status=derive_status(stopped=stop, accepted=accepted))


def with_priors(
    poses0: np.ndarray,
    edge_i: np.ndarray,
    edge_j: np.ndarray,
    meas: np.ndarray,
    prior_idx: np.ndarray,
    prior_poses: np.ndarray,
    prior_sqrt_info: Optional[np.ndarray] = None,
    fixed: Optional[np.ndarray] = None,
    sqrt_info: Optional[np.ndarray] = None,
):
    """Augment a pose graph with unary PRIOR factors (host numpy).

    A prior anchoring pose i to T_prior with information Omega is a
    between-factor edge from a virtual FIXED pose holding T_prior to pose
    i with identity measurement: `between_residual` then evaluates
    [log(R_prior^T R_i); R_prior^T (t_i - t_prior)], the standard prior
    residual, and the virtual pose contributes no columns.

    Returns (poses0', edge_i', edge_j', meas', fixed', sqrt_info') for
    `solve_pgo`.  `prior_sqrt_info` [P, 6, 6] weights each prior
    (W^T W = Omega); when either weight input is present the other side
    is padded with identities.  The returned pose array gains P trailing
    virtual poses; the result's `poses[:N]` are the real ones.
    """
    poses0 = np.asarray(poses0, np.float64)
    prior_idx = np.asarray(prior_idx, np.int32)
    prior_poses = np.asarray(prior_poses, np.float64)
    n, p = poses0.shape[0], prior_idx.shape[0]
    if prior_poses.shape != (p, POSE_DIM):
        raise ValueError(
            f"prior_poses must be [{p}, {POSE_DIM}], got {prior_poses.shape}")
    if p and (prior_idx.min() < 0 or prior_idx.max() >= n):
        raise ValueError("prior_idx out of range")

    poses_aug = np.concatenate([poses0, prior_poses])
    ei_aug = np.concatenate(
        [np.asarray(edge_i, np.int32),
         np.arange(n, n + p, dtype=np.int32)])
    ej_aug = np.concatenate([np.asarray(edge_j, np.int32), prior_idx])
    meas_aug = np.concatenate(
        [np.asarray(meas, np.float64), np.zeros((p, POSE_DIM))])

    if fixed is None:
        fixed_aug = np.zeros(n + p, bool)
        # Priors ARE gauge information: anchor pose 0 only when nothing
        # else constrains the gauge.
        if p == 0:
            fixed_aug[0] = True
    else:
        fixed_aug = np.concatenate([np.asarray(fixed, bool),
                                    np.ones(p, bool)])
    fixed_aug[n:] = True  # virtual anchor poses never move

    n_e = np.asarray(edge_i).shape[0]
    if sqrt_info is None and prior_sqrt_info is None:
        si_aug = None
    else:
        base = (np.asarray(sqrt_info, np.float64) if sqrt_info is not None
                else np.broadcast_to(np.eye(POSE_DIM),
                                     (n_e, POSE_DIM, POSE_DIM)))
        pri = (np.asarray(prior_sqrt_info, np.float64)
               if prior_sqrt_info is not None
               else np.broadcast_to(np.eye(POSE_DIM),
                                    (p, POSE_DIM, POSE_DIM)))
        if base.shape != (n_e, POSE_DIM, POSE_DIM):
            raise ValueError(
                f"sqrt_info must be [{n_e}, {POSE_DIM}, {POSE_DIM}], "
                f"got {base.shape}")
        if pri.shape != (p, POSE_DIM, POSE_DIM):
            raise ValueError(
                f"prior_sqrt_info must be [{p}, {POSE_DIM}, {POSE_DIM}], "
                f"got {pri.shape}")
        si_aug = np.concatenate([base, pri])
    return poses_aug, ei_aug, ej_aug, meas_aug, fixed_aug, si_aug


@dataclasses.dataclass
class SyntheticPoseGraph:
    """Ground truth + drifted odometry init for a loop-closed graph."""

    poses_gt: np.ndarray  # [N, 6]
    poses0: np.ndarray
    edge_i: np.ndarray
    edge_j: np.ndarray
    meas: np.ndarray  # [nE, 6]


def spanning_tree_init(
    poses0: np.ndarray,
    edge_i: np.ndarray,
    edge_j: np.ndarray,
    meas: np.ndarray,
    fixed: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Re-initialise poses by composing measurements along a BFS tree.

    Anchors keep their input pose; every other pose is reached by
    composing between-factor measurements along a breadth-first spanning
    tree from the nearest anchor, traversing edges forward
    (T_j = T_i o m) or backward (T_i = T_j o m^{-1}).  Exact on
    noise-free odometry.  Poses unreachable from any anchor keep their
    input estimate.  Host numpy (core/host_se3).
    """
    from collections import deque

    poses0 = np.asarray(poses0, np.float64)
    n = poses0.shape[0]
    edge_i = np.asarray(edge_i)
    edge_j = np.asarray(edge_j)
    meas = np.asarray(meas, np.float64)
    if fixed is None:
        fixed_np = np.zeros(n, bool)
        fixed_np[0] = True
    else:
        fixed_np = np.asarray(fixed, bool)
        if not fixed_np.any():
            fixed_np = fixed_np.copy()
            fixed_np[0] = True

    adj: list[list[tuple[int, int, bool]]] = [[] for _ in range(n)]
    for k in range(len(edge_i)):
        a, b = int(edge_i[k]), int(edge_j[k])
        adj[a].append((b, k, True))   # forward: T_b = T_a o m_k
        adj[b].append((a, k, False))  # backward: T_a = T_b o m_k^{-1}

    out = poses0.copy()
    seen = fixed_np.copy()
    queue = deque(np.nonzero(fixed_np)[0].tolist())
    # Inverse measurement: T^{-1} = (R^T, -R^T t) = relative(T, identity).
    inv_meas = relative(meas, np.zeros_like(meas))
    while queue:
        a = queue.popleft()
        for b, k, forward in adj[a]:
            if seen[b]:
                continue
            seen[b] = True
            out[b] = compose(out[a], meas[k] if forward else inv_meas[k])
            queue.append(b)
    return out


def make_synthetic_pose_graph(
    num_poses: int = 32,
    loop_closures: int = 6,
    meas_noise: float = 0.0,
    drift_noise: float = 0.05,
    seed: int = 0,
) -> SyntheticPoseGraph:
    """A circle trajectory with odometry edges + random loop closures.

    Measurements are exact relative poses (+ optional noise); the init
    integrates NOISY odometry, so it drifts, and the loop closures pull
    the chain back onto the circle.  The JAX package's generator: the
    same seed gives equal arrays.
    """
    rng = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(num_poses) / num_poses
    poses_gt = np.zeros((num_poses, 6))
    poses_gt[:, 2] = th
    poses_gt[:, 3] = np.cos(th)
    poses_gt[:, 4] = np.sin(th)
    poses_gt[:, 5] = 0.05 * np.sin(3 * th)

    ei = list(range(num_poses - 1))
    ej = list(range(1, num_poses))
    for _ in range(loop_closures):
        a = int(rng.integers(0, num_poses - 4))
        b = int(rng.integers(a + 2, num_poses))
        ei.append(a)
        ej.append(b)
    ei, ej = np.asarray(ei, np.int32), np.asarray(ej, np.int32)

    meas = (relative(poses_gt[ei], poses_gt[ej])
            + meas_noise * rng.standard_normal((len(ei), 6)))

    poses0 = poses_gt.copy()
    cur = poses_gt[0].copy()
    odo_noise = drift_noise * rng.standard_normal((num_poses - 1, 6))
    for k in range(1, num_poses):
        cur = compose(cur, meas[k - 1] + odo_noise[k - 1])
        poses0[k] = cur
    return SyntheticPoseGraph(
        poses_gt=poses_gt, poses0=poses0, edge_i=ei, edge_j=ej, meas=meas)

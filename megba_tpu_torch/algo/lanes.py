"""Lane-batched Levenberg-Marquardt: one solve over a bucket of problems.

The counterpart of the JAX package's bucket program
(`megba_tpu/serving/compile_pool.py:_build_batched_solve`), which vmaps
`lm_solve` over a leading lane axis.  The port's kernels are launched
from a host-driven loop and cannot be vmapped; the card's counterpart of
the vmap is a solve over the disjoint union of the bucket's lanes.
Every lane has the bucket's padded sizes (`n_cam`, `n_pt`, `n_edge`);
lane l's cameras and points are offset by l*n_cam and l*n_pt, and the
union is planned once (`ops.segtiles.make_dual_plans`; a camera-sorted
lane stays camera-sorted, so the camera slot order is the stacking
order).  Per-edge and per-vertex tensors are the union's, and every
per-vertex reduction is per lane by construction: each kernel launches
once a step for all lanes.  Kernel 1 (`jtj_grad_reduce`) builds the
system, kernel 2 (`coupling_expand`) the gain ratio's J.dx, and kernel 6
(`fused_block_diag_apply`) the JACOBI M^-1 apply and the camera blocks'
own Hpp_d p.  The coupling products (the S.p product, the reduced
right-hand side and the back-substitution) are the solo solve's
`solver.pcg.make_coupling_matvecs`: IMPLICIT unfused, kernels 2-3;
EXPLICIT unfused, kernel 5 (`seg_expand`), the elementwise per-edge W
contraction and kernel 4 (`seg_reduce`); with `fused_kernels`, kernel 7
(`fused_coupling_apply_implicit`, IMPLICIT) or kernel 8
(`fused_coupling_apply`, EXPLICIT) over the union's fused plans
(`ops.fused.with_fused_plans`).  The linearisation
(`linear_system.builder`, EXPLICIT's stored W rows included) and the
kernel wrappers are the solo solve's too.

Per-lane control, as JAX's vmapped `while_loop`: every scalar of the LM
and of the PCG (costs, trust region, v, rho, the forcing term, the PCG's
alpha, rho and flags, the guards' counters) is an [L] tensor, each lane
stops on its own tests, and a lane that stopped freezes exactly: every
update is a per-lane `torch.where` of the new value against the old
one, never a recomputation.  The host reads one "any lane still
running" flag per PCG iteration and one per LM iteration, plus one
"any lane relinearises" flag per LM iteration: the sync count is per
batch, not per problem.  A fault plan's window is per lane.

Bitwise lane independence is the contract: a lane's cameras, points,
trace, counts and status are the same bits whatever its batch-mates and
the lane count.  What keeps it:

- every per-lane reduction (costs, PCG dots, norms) folds a lane's own
  row in halves in a fixed order, in float64 (`lane_sum`), never a
  `torch.sum` over [L, n], whose order may depend on L;
- the kernels' launch shape depends on a side's mean segment length
  (`ops.segtiles.is_per_thread`), which on the union is the bucket's
  n_edge / n_cam (or / n_pt) whatever L is; split chunks, and kernel 4's
  choice between a tile thread, the whole block and split chunks, are
  decided per segment by its length; kernel 4's thread per segment, on a
  short side whose segments are all under 256 slots, sums each segment
  in the same order as a tile thread, so that choice (made on the union)
  moves no bit; no kernel sums with atomics;
- the slot tiles of kernel 4 and of the fused kernels
  (`ops.segtiles.SLOT_TILE` slots; a segment belongs to the tile where
  it starts) never straddle two lanes, so a lane's tile and chunk tables
  are its own shifted by its offset: a bucket's edge count is a multiple
  of the tile (`core.fm.EDGE_QUANTUM` is), which `lane_lm_solve` asserts
  on every path that launches them (EXPLICIT, `fused_kernels`);
- no batched library call (matmul, Cholesky, triangular solve) whose
  algorithm may change with the batch size: the camera blocks' M^-1 is
  an unrolled Cholesky inverse over feature-major rows (`block_inv_rows`)
  and their products are kernel 6;
- elementwise operations compute each element alone (on the CPU,
  float32 `atan2` rounds by position in the vectorised loop; no BAL
  path calls it).

The option surface: Schur PCG with JACOBI on HPP, IMPLICIT or EXPLICIT,
with or without `fused_kernels`, every Jacobian mode, HUBER and CAUCHY,
guards, forcing with warm starts, `tol_relative`, edge masks, fixed
vertices and fault plans, at float32 and float64.  `check_lane_option`
refuses the rest.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from megba_tpu_torch.algo.lm import (
    LMResult,
    derive_status,
    eisenstat_walker_eta,
    initial_forcing_eta,
)
from megba_tpu_torch.common import (
    DTYPE_TO_TORCH,
    ComputeKind,
    PrecondKind,
    PreconditionerKind,
    ProblemOption,
    RobustKind,
)
from megba_tpu_torch.core.fm import block_inv_fm, block_matvec_fm
from megba_tpu_torch.linear_system.builder import (
    build_schur_system,
    weight_system_inputs,
)
from megba_tpu_torch.observability.trace import SolveTrace
from megba_tpu_torch.ops import fused, segtiles
from megba_tpu_torch.ops.residuals import residual_only
from megba_tpu_torch.ops.robust import rho_and_weight, robustify
from megba_tpu_torch.parallel.mesh import one_shard
from megba_tpu_torch.robustness.faults import FaultPlan, _CRUSH
from megba_tpu_torch.solver.pcg import make_coupling_matvecs

_TINY = 1e-30
_TINY_RHO = 1e-30


def check_lane_option(option: ProblemOption) -> None:
    """Refuse, naming the option, what the lane-batched solve does not
    run yet (the JAX package's bucket program runs them through its XLA
    path): the precision rungs, SCHUR_DIAG, NEUMANN, TWO_LEVEL, MULTILEVEL
    and the plain full-system solver."""
    so = option.solver_option
    refused = [
        ("use_schur", option.use_schur, not option.use_schur),
        ("mixed_precision_pcg", option.mixed_precision_pcg,
         option.mixed_precision_pcg),
        ("solver_option.bf16", so.bf16, so.bf16),
        ("solver_option.preconditioner", so.preconditioner,
         so.preconditioner != PreconditionerKind.HPP),
        ("solver_option.precond", so.precond,
         so.precond != PrecondKind.JACOBI),
    ]
    for name, value, bad in refused:
        if bad:
            raise NotImplementedError(
                f"{name}={value!r} is not ported to the lane-batched fleet "
                "solve yet (megba_tpu_torch/algo/lanes.py): the batch runs "
                "Schur PCG with JACOBI on HPP, IMPLICIT or EXPLICIT, with or "
                "without fused_kernels; solve such a problem alone with "
                "flat_solve")


def prepare_kernels(cd: int, pd: int, od: int, device,
                    option: ProblemOption) -> None:
    """Build (or load) the kernel libraries a bucket of block widths
    (cd, pd) and residual rows od launches on `device` under `option`:
    kernels 1-3 at (od, cd) and (od, pd) (kernels 4-5, EXPLICIT unfused,
    live in the same library at every width of csrc/fused_shapes.cuh),
    kernel 6 at cd, and with `fused_kernels` kernel 7 (IMPLICIT) or 8
    (EXPLICIT) in both directions.  Nothing to do on the CPU."""
    if torch.device(device).type != "cuda":
        return
    for d in (cd, pd):
        segtiles.check_block("jtj_grad_reduce", (od, d))
        segtiles._lib((od, d))
    fused._shape_lib("fused_block_diag_apply", cd, fused.SUPPORTED_BLOCK_DIAG,
                     (cd, 0, 0), (cd,))
    if not option.solver_option.fused_kernels:
        return
    if option.compute_kind == ComputeKind.EXPLICIT:
        for shape in ((cd, pd, True), (pd, cd, False)):
            fused._shape_lib("fused_coupling_apply", shape,
                             fused.SUPPORTED_DIRECTIONS, (cd, pd, 0),
                             (cd, pd))
    else:
        fused._shape_lib("fused_coupling_apply_implicit", (cd, pd, od),
                         fused.SUPPORTED_IMPLICIT,
                         (max(cd, pd), min(cd, pd), od), (cd, pd), od)


# ---------------------------------------------------------------------------
# Per-lane reductions
# ---------------------------------------------------------------------------


def lane_sum(rows: torch.Tensor) -> torch.Tensor:
    """[L] sums of the rows of `rows` [L, m], each row on its own: in
    float64 (a float32 row too, for the accuracy `ops.accum.comp_sum`
    gets from its compensation), the row zero-padded to a power of two
    and folded in halves, so its order depends on m alone; returned in
    the rows' dtype."""
    n_lanes, m = rows.shape
    acc = rows.to(torch.float64)
    width = 1
    while width < m:
        width *= 2
    if width > m:
        acc = torch.cat([acc, torch.zeros((n_lanes, width - m),
                                          dtype=acc.dtype,
                                          device=acc.device)], 1)
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    return acc[:, 0].to(rows.dtype)


class Lanes:
    """The lane geometry of one union: L lanes of `n` columns each."""

    def __init__(self, n_lanes: int, n: int) -> None:
        self.n_lanes, self.n = n_lanes, n

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """[F, L*n] (or [L*n]) feature-major -> [L, F*n], each lane's
        entries in its own feature-major order."""
        if x.dim() == 1:
            return x.reshape(self.n_lanes, self.n)
        f = x.shape[0]
        return x.reshape(f, self.n_lanes, self.n).transpose(0, 1).reshape(
            self.n_lanes, f * self.n)

    def expand(self, v: torch.Tensor) -> torch.Tensor:
        """[L] per-lane values -> [L*n], lane l's value on its columns."""
        return v.repeat_interleave(self.n)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Per-lane sum of each lane's own entries (`lane_sum`)."""
        return lane_sum(self.rows(x))

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.sum(a * b)

    def abs_max(self, x: torch.Tensor) -> torch.Tensor:
        return self.rows(x).abs().amax(1)


def _where(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           lanes: Optional[Lanes] = None) -> torch.Tensor:
    """Per-lane select: `pred` [L] (expanded over `lanes`' columns when
    given)."""
    if lanes is not None:
        pred = lanes.expand(pred)
    return torch.where(pred, a, b)


# ---------------------------------------------------------------------------
# The camera blocks
# ---------------------------------------------------------------------------


def damp_rows(rows: torch.Tensor, region: torch.Tensor) -> torch.Tensor:
    """LM damping of row-form blocks [d*d, N] with a trust region per
    column (`region` [N]): the diagonal rows scale by (1 + 1/region), the
    others by exactly 1 (`core.fm.damp_rows_fm` with a region per
    block)."""
    dd = rows.shape[0]
    d = int(round(dd ** 0.5))
    diag = torch.tensor([1.0 if i % (d + 1) == 0 else 0.0 for i in range(dd)],
                        dtype=rows.dtype, device=rows.device)
    return rows * (1.0 + diag[:, None] / region[None, :])


def block_inv_rows(H: torch.Tensor) -> torch.Tensor:
    """Inverse of SPD blocks in row form (H [d*d, N], row i*d+j holds
    H[:, i, j]) by the Cholesky factor L, L^-1 by forward substitution
    and L^-T L^-1: the JACOBI M^-1 of `solver.precond.block_inv` with
    elementwise arithmetic only, so each block's bits depend on that
    block alone.  A block that is not positive definite or not finite
    comes out all NaN, as `block_inv` gives it.  Returns row form, kernel
    6's layout."""
    dd, n = H.shape
    d = int(round(dd ** 0.5))
    h = H.reshape(d, d, n)
    # cols[j]: rows j..d-1 of column j of L.
    cols = []
    for j in range(d):
        c = h[j:, j]
        for k in range(j):
            c = c - cols[k][j - k:] * cols[k][j - k]
        diag = torch.sqrt(c[0])
        cols.append(torch.cat([diag[None], c[1:] / diag]))
    eye = torch.eye(d, dtype=H.dtype, device=H.device)
    # Li[i]: row i of L^-1, all d columns.
    Li = []
    for i in range(d):
        t = eye[i][:, None].expand(d, n)
        for k in range(i):
            t = t - cols[k][i - k] * Li[k]
        Li.append(t / cols[i][0])
    M = Li[0][:, None, :] * Li[0][None, :, :]
    for k in range(1, d):
        M = M + Li[k][:, None, :] * Li[k][None, :, :]
    M = M.reshape(dd, n)
    diag = torch.stack([c[0] for c in cols])
    bad = ~(torch.isfinite(H).all(0) & torch.isfinite(M).all(0)
            & (diag > 0).all(0))
    return torch.where(bad[None, :], torch.full_like(M, float("nan")), M)


# ---------------------------------------------------------------------------
# The lane-batched PCG
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LanePCG:
    """One lane-batched Schur solve: the union's update and [L] counts."""

    dx_cam: torch.Tensor
    dx_pt: torch.Tensor
    iterations: torch.Tensor  # [L] int32
    rho: torch.Tensor  # [L]
    r0_ratio: torch.Tensor  # [L]
    breakdowns: torch.Tensor  # [L] int32
    broken: torch.Tensor  # [L] bool
    batch_iterations: int  # iterations the batch loop ran


def _lane_pcg_core(matvec, precond, b, cams: Lanes, live, max_iter, tol,
                   refuse_ratio, tol_relative, x0=None, guard=False,
                   max_restarts=0):
    """The Chronopoulos-Gear PCG of `solver.pcg._pcg_core`, lane by lane:
    each lane exits on its own threshold (`tol` a float or [L]),
    `max_iter`, refuse ratio or (guarded) breakdown budget, and a lane
    that exited keeps its x, r, p, s and scalars.  Lanes not `live` run
    no iteration.  Returns (x, iterations [L], rho, r0_ratio, restarts,
    broken, batch iterations)."""
    E = cams.expand
    dev = b.device
    n_lanes = cams.n_lanes
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
        u0 = precond(r)
        rho = cams.dot(r, u0)
        rhs_energy = rho
        r0_ratio = torch.ones_like(rho)
    else:
        r = b + (-1.0) * matvec(x0)
        u0 = precond(r)
        rho = cams.dot(r, u0)
        ub = precond(b)
        rhs_energy = cams.dot(b, ub)
        r0_ratio = rho.abs() / torch.clamp(rhs_energy.abs(), min=_TINY_RHO)
        use_ws = rho.abs() <= rhs_energy.abs()
        W = E(use_ws)
        x = torch.where(W, x0, torch.zeros_like(b))
        r = torch.where(W, r, b)
        u0 = torch.where(W, u0, ub)
        rho = torch.where(use_ws, rho, rhs_energy)
    if tol_relative:
        threshold = torch.clamp(tol * rhs_energy.abs(), min=_TINY_RHO)
    else:
        threshold = torch.as_tensor(tol, dtype=rho.dtype,
                                    device=dev).expand(n_lanes)
    w0 = matvec(u0)
    delta0 = cams.dot(u0, w0)
    alpha = rho / torch.where(delta0 == 0, torch.ones_like(delta0), delta0)
    p, s = u0, w0
    rho_min = rho.abs()
    x_best = x
    refused = torch.zeros((n_lanes,), dtype=torch.bool, device=dev)
    broken = torch.zeros_like(refused)
    iters = torch.zeros((n_lanes,), dtype=torch.int32, device=dev)
    restarts = torch.zeros((n_lanes,), dtype=torch.int32, device=dev)
    phase = torch.zeros((n_lanes,), dtype=torch.int32, device=dev)
    keepalive = torch.maximum(rhs_energy.abs(), threshold) * 2.0 + 1.0
    k = 0
    while k < max_iter:
        active = live & (rho.abs() >= threshold) & ~refused & ~broken
        if not bool(active.any()):
            break
        A = E(active)
        if not guard:
            x_n = x + E(alpha) * p
            r_n = r + E(-alpha) * s
            u = precond(r_n)
            w = matvec(u)
            rho_new = cams.dot(r_n, u)
            delta = cams.dot(u, w)
            beta = rho_new / rho
            alpha_n = rho_new / (delta - beta * rho_new / alpha)
            p_n = u + E(beta) * p
            s_n = w + E(beta) * s
            refused_n = rho_new.abs() > refuse_ratio * rho_min
            improved = rho_new.abs() < rho_min
            rho_next = rho_new
        else:
            # The guarded body (`_pcg_core`'s): phase 0 advances, 1
            # refreshes r = b - A x, 2 re-primes; one precond and one
            # matvec a phase.
            advancing, refresh, reprime = phase == 0, phase == 1, phase == 2
            step = torch.where(advancing, alpha, torch.zeros_like(alpha))
            x_n = x + E(step) * p
            r_n = r + E(-step) * s
            u = precond(r_n)
            R = E(refresh)
            w = matvec(torch.where(R, x_n, u))
            r_n = torch.where(R, b + (-1.0) * w, r_n)
            rho_new = cams.dot(r_n, u)
            delta = cams.dot(u, w)
            beta = rho_new / rho
            alpha_cg = rho_new / (delta - beta * rho_new / alpha)
            alpha_fresh = rho_new / torch.where(delta == 0,
                                                torch.ones_like(delta), delta)
            breakdown = ~refresh & (
                ~(torch.isfinite(rho_new) & torch.isfinite(delta))
                | (rho_new < 0) | (delta < 0))
            enter = breakdown & (restarts < max_restarts)
            broken = torch.where(
                active, broken | (breakdown & (restarts >= max_restarts)),
                broken)
            phase_n = torch.where(enter, torch.ones_like(phase),
                                  torch.where(refresh, torch.full_like(
                                      phase, 2), torch.zeros_like(phase)))
            restarts = torch.where(active, restarts + enter.to(torch.int32),
                                   restarts)
            phase = torch.where(active, phase_n, phase)
            ok_adv = advancing & ~breakdown
            ok_rep = reprime & ~breakdown
            alpha_n = torch.where(ok_rep, alpha_fresh,
                                  torch.where(ok_adv, alpha_cg, alpha))
            rho_next = torch.where(enter | refresh, keepalive, rho_new)
            P, Q = E(ok_rep), E(ok_adv)
            p_n = torch.where(P, u, torch.where(Q, u + E(beta) * p, p))
            s_n = torch.where(P, w, torch.where(Q, w + E(beta) * s, s))
            refused_n = ok_adv & (rho_new.abs() > refuse_ratio * rho_min)
            improved = ok_adv & (rho_new.abs() < rho_min)
        rho_min_n = torch.where(improved, rho_new.abs(), rho_min)
        x_best = torch.where(A & E(improved), x_n, x_best)
        x = torch.where(A, x_n, x)
        r = torch.where(A, r_n, r)
        p = torch.where(A, p_n, p)
        s = torch.where(A, s_n, s)
        alpha = torch.where(active, alpha_n, alpha)
        rho = torch.where(active, rho_next, rho)
        rho_min = torch.where(active, rho_min_n, rho_min)
        refused = torch.where(active, refused_n, refused)
        iters = iters + active.to(torch.int32)
        k += 1
    x = torch.where(E(refused | broken), x_best, x)
    return x, iters, rho, r0_ratio, restarts, broken, k


def lane_schur_pcg(system, Jc, Jp, plans, region, cams: Lanes, pts: Lanes,
                   live, max_iter, tol, refuse_ratio, tol_relative, x0=None,
                   guard=False, max_restarts=0,
                   compute_kind: ComputeKind = ComputeKind.IMPLICIT,
                   fused_kernels: bool = False) -> LanePCG:
    """The damped Schur solve of every live lane (`schur_pcg_solve` with
    JACOBI on HPP), `region` [L]: S p = Hpp_d p - Hpl Hll_d^-1 Hlp p with
    the coupling products of `make_coupling_matvecs` under
    `compute_kind` and `fused_kernels` (EXPLICIT reads `system.W`; fused
    needs the fused plans on `plans`) and the camera blocks' products by
    kernel 6."""
    Hpp_rows = damp_rows(fused.block_diag_rows(system.Hpp),
                         cams.expand(region))
    Hll_inv = block_inv_fm(damp_rows(system.Hll, pts.expand(region)))
    Minv_rows = block_inv_rows(Hpp_rows)
    hpl, hlp = make_coupling_matvecs(
        Jc, Jp, plans.shards[0], compute_kind,
        None if system.W is None else system.W[0], fused_kernels)

    def s_matvec(p: torch.Tensor) -> torch.Tensor:
        t = block_matvec_fm(Hll_inv, hlp(p))
        return fused.fused_block_diag_apply(Hpp_rows, p) - hpl(t)

    def precond(r: torch.Tensor) -> torch.Tensor:
        return fused.fused_block_diag_apply(Minv_rows, r)

    v = system.g_cam - hpl(block_matvec_fm(Hll_inv, system.g_pt))
    x, iters, rho, r0_ratio, restarts, broken, k = _lane_pcg_core(
        s_matvec, precond, v, cams, live, max_iter, tol, refuse_ratio,
        tol_relative, x0=x0, guard=guard, max_restarts=max_restarts)
    dx_pt = block_matvec_fm(Hll_inv, system.g_pt - hlp(x))
    return LanePCG(dx_cam=x, dx_pt=dx_pt, iterations=iters, rho=rho,
                   r0_ratio=r0_ratio, breakdowns=restarts, broken=broken,
                   batch_iterations=k)


# ---------------------------------------------------------------------------
# The lane-batched LM loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LaneSolve:
    """A bucket's solve: one `LMResult` per lane (feature-major cameras
    [cd, n_cam] and points [pd, n_pt], views of the union's `cameras`
    [cd, L*n_cam] and `points` [pd, L*n_pt] on the solve's device; the
    trace on the host) and the batch loop's own counts: LM iterations,
    PCG iterations per LM iteration, and linearisations (the pre-loop
    one included)."""

    results: List[LMResult]
    cameras: torch.Tensor
    points: torch.Tensor
    lm_iterations: int
    pcg_iterations: List[int]
    linearizations: int


def _union(stack: np.ndarray) -> np.ndarray:
    """[L, F, n] lane stacks -> [F, L*n] union rows."""
    n_lanes, f, n = stack.shape
    return np.ascontiguousarray(stack.transpose(1, 0, 2).reshape(f, n_lanes * n))


def lane_lm_solve(
    residual_jac_fn: Callable,
    option: ProblemOption,
    cameras: np.ndarray,
    points: np.ndarray,
    obs: np.ndarray,
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    mask: np.ndarray,
    cam_fixed: np.ndarray,
    pt_fixed: np.ndarray,
    initial_region=None,
    initial_v=None,
    fault_plan: Optional[FaultPlan] = None,
    device=None,
) -> LaneSolve:
    """Solve the L lanes of one bucket together.

    The operands are the serving layer's lane stacks (host numpy,
    feature-major, leading lane axis): cameras [L, cd, n_cam], points
    [L, pd, n_pt], obs [L, od, n_edge], cam_idx / pt_idx [L, n_edge]
    (each lane camera-sorted), mask [L, n_edge], cam_fixed [L, n_cam],
    pt_fixed [L, n_pt].  `initial_region` / `initial_v` start every lane
    (None: the option's).  `fault_plan` is a lane stack
    (`robustness.faults.stack_fault_plans`).  `device` defaults to the
    option's.
    """
    from megba_tpu_torch.common import resolve_device

    check_lane_option(option)
    dev = resolve_device(device, option)
    tdtype = DTYPE_TO_TORCH[np.dtype(option.dtype)]
    n_lanes, cd, n_cam = cameras.shape
    pd, n_pt = points.shape[1:]
    od, n_edge = obs.shape[1:]
    cams, pts = Lanes(n_lanes, n_cam), Lanes(n_lanes, n_pt)
    edges = Lanes(n_lanes, n_edge)
    algo_opt, solver_opt = option.algo_option, option.solver_option
    robust_opt = option.robust_option
    guards = robust_opt.guards
    robust, delta = option.robust_kind, option.robust_delta
    forcing, warm_start = solver_opt.forcing, solver_opt.warm_start
    residual_fn = residual_only(residual_jac_fn)

    lane = np.arange(n_lanes, dtype=np.int64)[:, None]
    ci = (np.asarray(cam_idx, np.int64) + lane * n_cam).reshape(-1)
    pi = (np.asarray(pt_idx, np.int64) + lane * n_pt).reshape(-1)
    plan_c, dual = segtiles.make_dual_plans(ci, pi, n_lanes * n_cam,
                                            n_lanes * n_pt, dev)
    if not np.array_equal(plan_c.perm, np.arange(ci.shape[0])):
        raise ValueError("lane_lm_solve: every lane's edges must be "
                         "camera-sorted (serving.shape_class.pad_to_class)")
    compute_kind = option.compute_kind
    fused_kernels = solver_opt.fused_kernels
    if fused_kernels or compute_kind == ComputeKind.EXPLICIT:
        # A slot tile (kernel 4, the fused kernels) sums the segments that
        # start in it: tiles that never straddle two lanes keep each
        # lane's tables its own.  The ladder's edge buckets are multiples
        # of EDGE_QUANTUM.
        if n_edge % segtiles.SLOT_TILE:
            raise ValueError(
                f"lane_lm_solve: EXPLICIT and fused_kernels need a bucket "
                f"edge count that is a multiple of {segtiles.SLOT_TILE} "
                f"(the slot tile), got {n_edge}")
    if fused_kernels:
        dual = fused.with_fused_plans(dual)
    plans = one_shard(dual)

    def put(a: np.ndarray, dt=tdtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    cameras_u = put(_union(np.asarray(cameras)))
    points_u = put(_union(np.asarray(points)))
    obs_u = put(_union(np.asarray(obs)))
    ci_t = dual.cam.seg.long()
    pi_t = put(pi, torch.int64)
    m_t = put(np.asarray(mask).reshape(-1))
    cf_t = put(np.asarray(cam_fixed, bool).reshape(-1), torch.bool)
    pf_t = put(np.asarray(pt_fixed, bool).reshape(-1), torch.bool)

    faults = None
    if fault_plan is not None:
        windows = np.asarray(fault_plan.window, np.int64).reshape(n_lanes, 2)
        offsets = np.asarray(fault_plan.offset, np.int64).reshape(n_lanes)
        edge_nan = fault_plan.edge_nan.reshape(-1).to(dev, tdtype)
        crush = fault_plan.point_crush.reshape(-1).to(dev, tdtype)
        faults = (windows, offsets, edge_nan, crush)

    def open_lanes(k: int) -> Optional[np.ndarray]:
        """The lanes whose fault window is open at stamp k (host
        arithmetic), or None when none is."""
        if faults is None:
            return None
        g = k + faults[1]
        on = (faults[0][:, 0] <= g) & (g < faults[0][:, 1])
        return on if on.any() else None

    def poison_residuals(r: torch.Tensor, k: int) -> torch.Tensor:
        on = open_lanes(k)
        if on is None:
            return r
        sel = edges.expand(torch.from_numpy(on).to(dev))
        return torch.where(sel[None, :], r + faults[2][None, :], r)

    def poison_system(system, k: int):
        on = open_lanes(k)
        if on is None:
            return system
        sel = pts.expand(torch.from_numpy(on).to(dev)) & (faults[3] > 0)
        one = torch.ones((), dtype=tdtype, device=dev)
        scale = torch.where(sel, torch.full_like(one, _CRUSH), one)
        return dataclasses.replace(system, Hll=system.Hll * scale[None, :])

    def lane_cost(r: torch.Tensor, rho_e: Optional[torch.Tensor]):
        if rho_e is None:
            return edges.sum(r * r)
        return edges.sum(rho_e)

    def linearize(cams_u, pts_u, k):
        r, Jc, Jp = residual_jac_fn(cams_u.index_select(1, ci_t),
                                    pts_u.index_select(1, pi_t), obs_u)
        r, Jc, Jp = weight_system_inputs(r, Jc, Jp, ci_t, pi_t, m_t, None,
                                         cf_t, pf_t)
        r = poison_residuals(r, k)
        if robust == RobustKind.NONE:
            cost = wcost = lane_cost(r, None)
        else:
            r, Jc, Jp, rho_e = robustify(r, Jc, Jp, robust, delta)
            cost, wcost = lane_cost(r, rho_e), lane_cost(r, None)
        Jp = dual.to_pt(Jp)
        system = build_schur_system(
            (r,), (Jc,), (Jp,), plans, n_lanes * n_cam, n_lanes * n_pt,
            cf_t, pf_t, compute_kind)
        return r, Jc, Jp, poison_system(system, k), cost, wcost

    def trial_cost(cams_u, pts_u, k):
        r = residual_fn(cams_u.index_select(1, ci_t),
                        pts_u.index_select(1, pi_t), obs_u) * m_t[None, :]
        r = poison_residuals(r, k)
        if robust == RobustKind.NONE:
            return lane_cost(r, None)
        return lane_cost(r, rho_and_weight((r * r).sum(0), robust, delta)[0])

    def predicted(dx_cam, dx_pt, r, Jc, Jp):
        jc_dx = segtiles.coupling_expand(dx_cam, Jc, dual.cam, cd)
        jp_dx = dual.to_cam(segtiles.coupling_expand(dx_pt, Jp, dual.pt, pd))
        t = jc_dx + jp_dx + r
        return edges.sum(t * t)

    def full(v) -> torch.Tensor:
        return torch.full((n_lanes,), float(v), dtype=tdtype, device=dev)

    r, Jc, Jp, system, cost, wcost = linearize(cameras_u, points_u, 0)
    cost0 = cost
    region = full(algo_opt.initial_region if initial_region is None
                  else initial_region)
    v = full(2.0 if initial_v is None else initial_v)
    inflation = full(robust_opt.damping_inflation)
    third = full(1.0 / 3.0)
    eta_min, eta_max = full(solver_opt.eta_min), full(solver_opt.tol)
    eta = initial_forcing_eta(eta_min, eta_max) if forcing else eta_max
    dx0 = torch.zeros_like(cameras_u) if warm_start else None
    zeros_i = torch.zeros((n_lanes,), dtype=torch.int32, device=dev)
    stop = torch.zeros((n_lanes,), dtype=torch.bool, device=dev)
    fatal = torch.zeros_like(stop)
    accepted, iters, pcg_total = zeros_i, zeros_i, zeros_i
    fail_streak, recoveries = zeros_i, zeros_i
    rows: List[torch.Tensor] = []  # per LM iteration: [11, L] trace values
    live_rows: List[torch.Tensor] = []
    batch_pcg: List[int] = []
    n_lin = 1
    k = 0
    while k < algo_opt.max_iter:
        live = ~stop
        pcg = lane_schur_pcg(
            system, Jc, Jp, plans, region, cams, pts, live,
            solver_opt.max_iter, eta * eta if forcing else solver_opt.tol,
            solver_opt.refuse_ratio, forcing or solver_opt.tol_relative,
            x0=dx0, guard=guards,
            max_restarts=robust_opt.pcg_max_restarts if guards else 0,
            compute_kind=compute_kind, fused_kernels=fused_kernels)
        batch_pcg.append(pcg.batch_iterations)
        dx_cam, dx_pt = pcg.dx_cam, pcg.dx_pt
        dx_norm = torch.sqrt(cams.sum(dx_cam * dx_cam)
                             + pts.sum(dx_pt * dx_pt))
        x_norm = torch.sqrt(cams.sum(cameras_u ** 2)
                            + pts.sum(points_u ** 2))
        converged = dx_norm <= algo_opt.epsilon2 * (x_norm
                                                    + algo_opt.epsilon1)
        cams_new = cameras_u + dx_cam
        pts_new = points_u + dx_pt
        denominator = torch.clamp(
            predicted(dx_cam, dx_pt, r, Jc, Jp) - wcost, max=-_TINY)
        cost_new = trial_cost(cams_new, pts_new, k)
        rho = (cost_new - cost) / denominator
        accept = (cost_new < cost) & ~converged
        recover = torch.zeros_like(accept)
        if guards:
            step_bad = ~(torch.isfinite(cost_new) & torch.isfinite(dx_norm)
                         & torch.isfinite(pcg.rho)) | pcg.broken
            converged = converged & ~step_bad
            adopt = ~torch.isfinite(cost) & ~step_bad & ~converged
            accept = (accept & ~step_bad) | adopt
            recover = step_bad
        accept, recover = accept & live, recover & live
        eta_k = eta
        if forcing:
            eta_n = eisenstat_walker_eta(eta, cost_new, cost, rho, accept,
                                         eta_min, eta_max)
            eta_n = torch.where(torch.isfinite(eta_n), eta_n, eta_max)
            eta = torch.where(live, eta_n, eta)
        if warm_start:
            # A reject starts the next PCG cold (the solo loop's rule).
            dx0 = torch.where(cams.expand(live), _where(
                accept, dx_cam, torch.zeros_like(dx_cam), cams), dx0)

        relin = accept | recover
        if bool(relin.any()):
            n_lin += 1
            at_c = _where(accept, cams_new, cameras_u, cams)
            at_p = _where(accept, pts_new, points_u, pts)
            r_n, Jc_n, Jp_n, sys_n, _, wcost_n = linearize(at_c, at_p, k)
            r = _where(relin, r_n, r, edges)
            Jc = _where(relin, Jc_n, Jc, edges)
            Jp = _where(relin, Jp_n, Jp, edges)
            rc, rp = cams.expand(relin), pts.expand(relin)
            W = system.W
            if W is not None:  # EXPLICIT: the stored rows, camera slots
                W = (_where(relin, sys_n.W[0], W[0], edges),)
            system = dataclasses.replace(
                system,
                Hpp=torch.where(rc[:, None, None], sys_n.Hpp, system.Hpp),
                Hll=torch.where(rp[None, :], sys_n.Hll, system.Hll),
                g_cam=torch.where(rc[None, :], sys_n.g_cam, system.g_cam),
                g_pt=torch.where(rp[None, :], sys_n.g_pt, system.g_pt),
                W=W)
            wcost = torch.where(accept, wcost_n, wcost)
        cameras_u = _where(accept, cams_new, cameras_u, cams)
        points_u = _where(accept, pts_new, points_u, pts)
        g_inf = torch.maximum(cams.abs_max(system.g_cam),
                              pts.abs_max(system.g_pt))
        stop_n = converged | (accept & (g_inf <= algo_opt.epsilon1))
        if guards:
            streak = torch.where(recover, fail_streak + 1, zeros_i)
            fatal_n = streak > robust_opt.max_recoveries
            stop_n = stop_n | fatal_n
            fail_streak = torch.where(live, streak, fail_streak)
            recoveries = recoveries + recover.to(torch.int32)
            fatal = fatal | (fatal_n & live)
        region_acc = region / torch.maximum(third,
                                            1.0 - (2.0 * rho - 1.0) ** 3)
        if guards:
            region_acc = torch.where(torch.isfinite(rho), region_acc, region)
        region_rej = torch.where(recover, region / inflation, region / v)
        v_rej = torch.where(recover, v, v * 2.0)
        rows.append(torch.stack([
            cost_new, g_inf, region, rho, accept.to(tdtype),
            pcg.iterations.to(tdtype), eta_k, pcg.r0_ratio.to(tdtype),
            recover.to(tdtype), pcg.breakdowns.to(tdtype)]))
        live_rows.append(live)
        region = torch.where(live, torch.where(accept, region_acc,
                                               region_rej), region)
        v = torch.where(live, torch.where(accept, torch.full_like(v, 2.0),
                                          v_rej), v)
        cost = torch.where(accept, cost_new, cost)
        accepted = accepted + accept.to(torch.int32)
        pcg_total = pcg_total + torch.where(live, pcg.iterations, zeros_i)
        iters = iters + live.to(torch.int32)
        stop = torch.where(live, stop_n, stop)
        k += 1
        if not bool((~stop).any()):
            break

    return LaneSolve(
        results=_lane_results(
            cameras_u, points_u, cost, cost0, region, v, stop, fatal,
            accepted, iters, pcg_total, recoveries, dx0, rows, cams, pts,
            algo_opt.max_iter, tdtype, warm_start),
        cameras=cameras_u, points=points_u, lm_iterations=k, pcg_iterations=batch_pcg, linearizations=n_lin)


def _lane_results(cameras_u, points_u, cost, cost0, region, v, stop, fatal,
                  accepted, iters, pcg_total, recoveries, dx0, rows,
                  cams: Lanes, pts: Lanes, max_iter: int, tdtype,
                  warm_start: bool) -> List[LMResult]:
    """Each lane's `LMResult`: its slices of the union, its scalars, and
    its trace from the per-iteration rows (read to the host once)."""
    n_lanes = cams.n_lanes
    host = torch.stack([cost, cost0, region, v, stop.to(tdtype),
                        fatal.to(tdtype), accepted.to(tdtype),
                        iters.to(tdtype), pcg_total.to(tdtype),
                        recoveries.to(tdtype)]).cpu()
    trace_rows = (torch.stack(rows).cpu() if rows
                  else torch.zeros((0, 10, n_lanes), dtype=tdtype))
    out = []
    for lane in range(n_lanes):
        c_sl = slice(lane * cams.n, (lane + 1) * cams.n)
        p_sl = slice(lane * pts.n, (lane + 1) * pts.n)
        (c, c0, reg, vv, st, fa, acc, it, pc, rec) = host[:, lane].tolist()
        it, acc, pc, rec = int(it), int(acc), int(pc), int(rec)
        trace = SolveTrace.empty(max_iter, tdtype)
        t = trace_rows[:it, :, lane]
        trace.cost[:it] = t[:, 0]
        trace.grad_inf_norm[:it] = t[:, 1]
        trace.trust_region[:it] = t[:, 2]
        trace.rho[:it] = t[:, 3]
        trace.accept[:it] = t[:, 4] != 0
        trace.pcg_iters[:it] = t[:, 5].to(torch.int32)
        trace.pcg_eta[:it] = t[:, 6]
        trace.pcg_r0_ratio[:it] = t[:, 7]
        trace.recovery[:it] = t[:, 8] != 0
        trace.pcg_breakdown[:it] = t[:, 9].to(torch.int32)
        stopped, fatal_l = bool(st), bool(fa)
        out.append(LMResult(
            cameras=cameras_u[:, c_sl], points=points_u[:, p_sl],
            cost=torch.tensor(c, dtype=tdtype),
            initial_cost=torch.tensor(c0, dtype=tdtype),
            iterations=it, accepted=acc, pcg_iterations=pc,
            region=torch.tensor(reg, dtype=tdtype),
            v=torch.tensor(vv, dtype=tdtype), stopped=stopped, trace=trace,
            status=derive_status(stopped=stopped, accepted=acc,
                                 recoveries=rec, fatal=fatal_l),
            recoveries=rec,
            dx_cam=dx0[:, c_sl] if warm_start else None))
    return out

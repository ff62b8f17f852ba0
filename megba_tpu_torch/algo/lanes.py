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

The precision rungs (`mixed_precision_pcg`, `bf16`) equilibrate the
row-form blocks elementwise (`lane_equilibrate`) and run the coupling
kernels in their mixed, mixed64 or bf16 arm on bfloat16 rows; under
`bf16` M^-1 is a bfloat16 copy (kernel 6's bf16 arm with
`fused_kernels`) and the PCG is the textbook body (`_lane_pcg_classic`).
SCHUR_DIAG sums its correction rows per camera by kernel 4; NEUMANN
applies Horner's series over the lane S.p product; `use_schur=False`
runs CG over the (camera, point) pair (`lane_plain_pcg`).

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
- no batched library call (matmul, Cholesky, triangular solve, an
  einsum over the union's blocks) whose algorithm may change with the
  batch size: every camera-block inverse (JACOBI, SCHUR_DIAG and its
  fallback, the plain solve's) is an unrolled Cholesky inverse over
  feature-major rows (`block_inv_rows`) and their products are kernel 6
  (or, on the unfused bf16 rung, the elementwise
  `block_rows_apply_bf16`);
- elementwise operations compute each element alone (on the CPU,
  float32 `atan2` rounds by position in the vectorised loop; no BAL
  path calls it).

The option surface is every option `validate_options` accepts for a
single device, as the JAX package's vmapped bucket program takes them:
Schur PCG with JACOBI or NEUMANN on HPP or SCHUR_DIAG, IMPLICIT or
EXPLICIT, with or without `fused_kernels`, the mixed and bf16 rungs,
the plain full-system solver, every Jacobian mode, HUBER and CAUCHY,
guards, forcing with warm starts, `tol_relative`, edge masks, fixed
vertices and fault plans, at float32 and float64.  TWO_LEVEL and
MULTILEVEL on the Schur solver raise the JAX package's `ValueError`
(`check_lane_option`): its vmapped solve has no camera-cluster plan.
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
from megba_tpu_torch.analysis import census
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
from megba_tpu_torch.solver.pcg import (
    _BF16_TOL_FLOOR,
    _safe_div,
    _scale_rows,
    make_coupling_matvecs,
)
from megba_tpu_torch.solver.precond import (
    FALLBACK_BLOCK_RADIX,
    _schur_diag_rows,
)

_TINY = 1e-30
_TINY_RHO = 1e-30


def check_lane_option(option: ProblemOption) -> None:
    """Raise what the JAX package's bucket program raises: its `lm_solve`
    refuses TWO_LEVEL and MULTILEVEL on the Schur solver, since the
    vmapped solve passes no camera-cluster plan.  Every other option
    `validate_options` accepts runs in the batch."""
    so = option.solver_option
    if option.use_schur and so.precond in (PrecondKind.TWO_LEVEL,
                                           PrecondKind.MULTILEVEL):
        raise ValueError(
            f"SolverOption.precond={so.precond.name} needs a "
            "camera-cluster plan operand: solve through flat_solve (which "
            "plans + caches it) or pass cluster_plan="
            "ops.segtiles.device_cluster_plan(...) / "
            "device_multilevel_plan(...)")


def uses_seg_reduce(option: ProblemOption) -> bool:
    """Whether the batch launches kernel 4: EXPLICIT's unfused coupling
    products, or SCHUR_DIAG's correction rows."""
    return ((option.compute_kind == ComputeKind.EXPLICIT
             and not option.solver_option.fused_kernels)
            or (option.use_schur and option.solver_option.preconditioner
                == PreconditionerKind.SCHUR_DIAG))


def prepare_kernels(cd: int, pd: int, od: int, device,
                    option: ProblemOption) -> None:
    """Build (or load) the kernel libraries a bucket of block widths
    (cd, pd) and residual rows od launches on `device` under `option`:
    kernels 1-3 at (od, cd) and (od, pd) (kernel 5 lives in the same
    library at every width of csrc/fused_shapes.cuh), kernel 4's library
    when the batch launches it (`uses_seg_reduce`), kernel 6 at cd, and
    with `fused_kernels` kernel 7 (IMPLICIT) or 8 (EXPLICIT) in both
    directions.  A library holds every precision arm of its kernels.
    Nothing to do on the CPU."""
    if torch.device(device).type != "cuda":
        return
    for d in (cd, pd):
        segtiles.check_block("jtj_grad_reduce", (od, d))
        segtiles._lib((od, d))
    if uses_seg_reduce(option):
        segtiles._sum_lib()
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

    def dots(self, pairs) -> List[torch.Tensor]:
        """Per-lane dot of each (a, b) pair: the products' rows folded in
        one `lane_sum`, each row on its own (so each dot's bits are those
        of `sum(a * b)`)."""
        rows = lane_sum(torch.cat([self.rows(a * b) for a, b in pairs]))
        return list(rows.split(self.n_lanes))

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


class LaneSpace:
    """The PCG's vectors over the lanes: one union tensor (the Schur
    solve's cameras) or a (camera, point) pair (the plain full-system
    solve), one `Lanes` geometry a leaf.  Every operation takes [L]
    scalars and works leafwise; a pair's dot sums per leaf, camera
    first, as the JAX package's tree dots do."""

    def __init__(self, *leaves: Lanes) -> None:
        self.leaves = leaves
        self.n_lanes = leaves[0].n_lanes

    def _map(self, fn, *trees):
        if len(self.leaves) == 1:
            return fn(self.leaves[0], *trees)
        return tuple(fn(lanes, *parts)
                     for lanes, *parts in zip(self.leaves, *trees))

    def dot(self, a, b) -> torch.Tensor:
        return self.dots([(a, b)])[0]

    def dots(self, pairs) -> List[torch.Tensor]:
        """The dot of each (a, b) pair, each leaf's in one fold."""
        if len(self.leaves) == 1:
            return self.leaves[0].dots(pairs)
        out = None
        for i, lanes in enumerate(self.leaves):
            d = lanes.dots([(a[i], b[i]) for a, b in pairs])
            out = d if out is None else [o + di for o, di in zip(out, d)]
        return out

    def axpy(self, alpha: torch.Tensor, x, y):
        """y + alpha x, alpha [L]."""
        return self._map(lambda lanes, xi, yi: yi + lanes.expand(alpha) * xi,
                         x, y)

    def sub(self, b, w):
        """b - w, as b + (-1) w."""
        return self._map(lambda lanes, bi, wi: bi + (-1.0) * wi, b, w)

    def where(self, pred: torch.Tensor, a, b):
        """Per-lane select, `pred` [L]."""
        return self._map(lambda lanes, ai, bi: torch.where(
            lanes.expand(pred), ai, bi), a, b)

    def zeros_like(self, b):
        return self._map(lambda lanes, bi: torch.zeros_like(bi), b)


def _lane_pcg_core(matvec, precond, b, sp: LaneSpace, live, max_iter, tol,
                   refuse_ratio, tol_relative, x0=None, guard=False,
                   max_restarts=0, classic=False):
    """The PCG of `solver.pcg._pcg_core`, lane by lane, over `sp`'s
    vectors: each lane exits on its own threshold (`tol` a float or
    [L]), `max_iter`, refuse ratio or (guarded) breakdown budget, and a
    lane that exited keeps its x, r, p, s and scalars.  Lanes not `live`
    run no iteration.  The Chronopoulos-Gear body, or with `classic` the
    textbook body with its stagnation exit (`_lane_pcg_classic`).
    Returns (x, iterations [L], rho, r0_ratio, restarts, broken, batch
    iterations)."""
    dev = live.device
    n_lanes = sp.n_lanes
    if x0 is None:
        x = sp.zeros_like(b)
        r = b
        u0 = precond(r)
        rho = sp.dot(r, u0)
        rhs_energy = rho
        r0_ratio = torch.ones_like(rho)
    else:
        r = sp.sub(b, matvec(x0))
        u0 = precond(r)
        ub = precond(b)
        rho, rhs_energy = sp.dots([(r, u0), (b, ub)])
        r0_ratio = rho.abs() / torch.clamp(rhs_energy.abs(), min=_TINY_RHO)
        use_ws = rho.abs() <= rhs_energy.abs()
        x = sp.where(use_ws, x0, sp.zeros_like(b))
        r = sp.where(use_ws, r, b)
        u0 = sp.where(use_ws, u0, ub)
        rho = torch.where(use_ws, rho, rhs_energy)
    if tol_relative:
        threshold = torch.clamp(tol * rhs_energy.abs(), min=_TINY_RHO)
    else:
        threshold = torch.as_tensor(tol, dtype=rho.dtype,
                                    device=dev).expand(n_lanes)
    if classic:
        return _lane_pcg_classic(matvec, precond, b, sp, live, max_iter,
                                 threshold, refuse_ratio, x, r, u0, rho,
                                 rhs_energy, r0_ratio, guard, max_restarts)
    w0 = matvec(u0)
    delta0 = sp.dot(u0, w0)
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
        census.mark("pcg")
        if not guard:
            x_n = sp.axpy(alpha, p, x)
            r_n = sp.axpy(-alpha, s, r)
            u = precond(r_n)
            w = matvec(u)
            rho_new, delta = sp.dots([(r_n, u), (u, w)])
            beta = rho_new / rho
            alpha_n = rho_new / (delta - beta * rho_new / alpha)
            p_n = sp.axpy(beta, p, u)
            s_n = sp.axpy(beta, s, w)
            refused_n = rho_new.abs() > refuse_ratio * rho_min
            improved = rho_new.abs() < rho_min
            rho_next = rho_new
        else:
            # The guarded body (`_pcg_core`'s): phase 0 advances, 1
            # refreshes r = b - A x, 2 re-primes; one precond and one
            # matvec a phase.
            advancing, refresh, reprime = phase == 0, phase == 1, phase == 2
            step = torch.where(advancing, alpha, torch.zeros_like(alpha))
            x_n = sp.axpy(step, p, x)
            r_n = sp.axpy(-step, s, r)
            u = precond(r_n)
            w = matvec(sp.where(refresh, x_n, u))
            r_n = sp.where(refresh, sp.sub(b, w), r_n)
            rho_new, delta = sp.dots([(r_n, u), (u, w)])
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
            p_n = sp.where(ok_rep, u, sp.where(ok_adv, sp.axpy(beta, p, u), p))
            s_n = sp.where(ok_rep, w, sp.where(ok_adv, sp.axpy(beta, s, w), s))
            refused_n = ok_adv & (rho_new.abs() > refuse_ratio * rho_min)
            improved = ok_adv & (rho_new.abs() < rho_min)
        rho_min_n = torch.where(improved, rho_new.abs(), rho_min)
        x_best = sp.where(active & improved, x_n, x_best)
        x = sp.where(active, x_n, x)
        r = sp.where(active, r_n, r)
        p = sp.where(active, p_n, p)
        s = sp.where(active, s_n, s)
        alpha = torch.where(active, alpha_n, alpha)
        rho = torch.where(active, rho_next, rho)
        rho_min = torch.where(active, rho_min_n, rho_min)
        refused = torch.where(active, refused_n, refused)
        iters = iters + active.to(torch.int32)
        k += 1
    x = sp.where(refused | broken, x_best, x)
    census.mark("pcg_done")
    return x, iters, rho, r0_ratio, restarts, broken, k


def _lane_pcg_classic(matvec, precond, b, sp: LaneSpace, live, max_iter,
                      threshold, refuse_ratio, x, r, u0, rho, rhs_energy,
                      r0_ratio, guard, max_restarts):
    """The textbook body of `solver.pcg._pcg_core_classic`, lane by lane
    (the bf16 rung's): s = A p fresh each step, alpha = rho / <p, s>; a
    finite sign flip of rho or delta is a stall that restores the lane's
    best iterate and stops it.  Under `guard` only a non-finite scalar is
    a breakdown; its restart is one iteration whose matvec computes A x
    for r = b - A x, p = M^-1 r."""
    dev = rho.device
    n_lanes = sp.n_lanes
    p = u0
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
        census.mark("pcg")
        if not guard:
            s = matvec(p)
            delta = sp.dot(p, s)
            alpha = _safe_div(rho, delta)
            x_n = sp.axpy(alpha, p, x)
            r_n = sp.axpy(-alpha, s, r)
            u = precond(r_n)
            rho_new = sp.dot(r_n, u)
            beta = _safe_div(rho_new, rho)
            p_n = sp.axpy(beta, p, u)
            stall = (rho_new < 0) | (delta < 0)
            refused_n = stall | (rho_new.abs() > refuse_ratio * rho_min)
            improved = ~stall & (rho_new.abs() < rho_min)
            rho_next = rho_new
        else:
            advancing, refresh = phase == 0, phase == 1
            # The one matvec: A p normally, A x during the refresh.
            w = matvec(sp.where(refresh, x, p))
            delta = sp.dot(p, w)
            alpha = _safe_div(rho, delta)
            step = torch.where(advancing, alpha, torch.zeros_like(alpha))
            x_new = sp.axpy(step, p, x)
            r_new = sp.where(refresh, sp.sub(b, w), sp.axpy(-step, w, r))
            u = precond(r_new)
            rho_new = sp.dot(r_new, u)
            finite = torch.isfinite(rho_new) & torch.isfinite(delta)
            stall = advancing & finite & ((rho_new < 0) | (delta < 0))
            breakdown = advancing & ~finite
            enter = breakdown & (restarts < max_restarts)
            broken = torch.where(
                active, broken | (breakdown & (restarts >= max_restarts)),
                broken)
            restarts = torch.where(active, restarts + enter.to(torch.int32),
                                   restarts)
            phase = torch.where(active, torch.where(
                enter, torch.ones_like(phase), torch.zeros_like(phase)),
                phase)
            ok_adv = advancing & ~breakdown & ~stall
            x_n = sp.where(ok_adv, x_new, x)
            r_n = sp.where(ok_adv | refresh, r_new, r)
            beta = _safe_div(rho_new, rho)
            p_n = sp.where(refresh, u, sp.where(ok_adv, sp.axpy(beta, p, u),
                                                p))
            rho_next = torch.where(enter, keepalive, rho_new)
            refused_n = stall | (ok_adv
                                 & (rho_new.abs() > refuse_ratio * rho_min))
            improved = ok_adv & (rho_new.abs() < rho_min)
        rho_min_n = torch.where(improved, rho_new.abs(), rho_min)
        x_best = sp.where(active & improved, x_n, x_best)
        x = sp.where(active, x_n, x)
        r = sp.where(active, r_n, r)
        p = sp.where(active, p_n, p)
        rho = torch.where(active, rho_next, rho)
        rho_min = torch.where(active, rho_min_n, rho_min)
        refused = torch.where(active, refused_n, refused)
        iters = iters + active.to(torch.int32)
        k += 1
    x = sp.where(refused | broken, x_best, x)
    census.mark("pcg_done")
    return x, iters, rho, r0_ratio, restarts, broken, k


@dataclasses.dataclass
class LanePCG:
    """One lane-batched solve: the union's update and [L] counts."""

    dx_cam: torch.Tensor
    dx_pt: torch.Tensor
    iterations: torch.Tensor  # [L] int32
    rho: torch.Tensor  # [L]
    r0_ratio: torch.Tensor  # [L]
    breakdowns: torch.Tensor  # [L] int32
    broken: torch.Tensor  # [L] bool
    batch_iterations: int  # iterations the batch loop ran
    # [L] int32: the SCHUR_DIAG blocks that fell back to the Hpp inverse
    # (`solver.precond.encode_precond_fallback`; 0 on HPP).
    precond_fallback: Optional[torch.Tensor] = None


def lane_equilibrate(Hpp_rows, Hll_d, g_cam, g_pt, Jc, Jp, W, plans,
                     compute_kind: ComputeKind):
    """The precision rungs' Jacobi equilibration (`solver.pcg._equilibrate`)
    on row-form blocks: d = diag(damped H)^-1/2 per camera and per point,
    both block diagonals scaled symmetrically, g by d, the coupling rows
    (Jc / Jp, or W) scaled per edge and cast to bfloat16
    (`solver.pcg._scale_rows`, kernel 5 gathering the scales).  All of it
    elementwise.  Returns the scaled pieces and the scales d_cam [cd, Nc],
    d_pt [pd, Np]."""
    cd, pd = g_cam.shape[0], g_pt.shape[0]
    dc = torch.rsqrt(torch.stack([Hpp_rows[i * (cd + 1)] for i in range(cd)]))
    Hpp_rows = (Hpp_rows * dc.repeat_interleave(cd, 0)) * dc.repeat(cd, 1)
    d_pt = torch.rsqrt(torch.stack([Hll_d[i * (pd + 1)] for i in range(pd)]))
    Hll_d = Hll_d * torch.stack([d_pt[i] * d_pt[j] for i in range(pd)
                                 for j in range(pd)])
    Jc, Jp, W = _scale_rows(Jc, Jp, W, plans, dc, d_pt, compute_kind)
    return Hpp_rows, Hll_d, g_cam * dc, g_pt * d_pt, Jc, Jp, W, dc, d_pt


def block_rows_apply_bf16(M_bf16: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """The unfused bf16 rung's M^-1 apply (`solver.precond.
    cam_block_matvec_bf16`) on bfloat16 row-form blocks [d*d, N]: x
    rounded to bfloat16, each product exact in float32 (two bfloat16
    values), the sums in float32 in column order, per block alone.
    Returns float32 [d, N]."""
    d, n = x.shape
    xb = x.to(torch.bfloat16).to(torch.float32)
    prod = M_bf16.to(torch.float32).view(d, d, n) * xb[None]
    out = prod[:, 0]
    for j in range(1, d):
        out = out + prod[:, j]
    return out


def lane_preconditioner(kind: PrecondKind, block_kind: PreconditionerKind,
                        Hpp_rows, Hll_inv, W, Jc, Jp, plans,
                        compute_kind: ComputeKind, cams: Lanes, s_matvec,
                        neumann_order: int = 2, bf16: bool = False,
                        fused_kernels: bool = False):
    """The reduced system's M^-1 (`solver.precond.make_schur_preconditioner`
    for JACOBI and NEUMANN on HPP or SCHUR_DIAG), lane-safe: both block
    inverses by `block_inv_rows`; SCHUR_DIAG's correction rows
    sum_e W_e Hll^-1 W_e^T summed per camera by kernel 4 over the union's
    camera plan, nine launches of nine rows (`_schur_diag_rows`), and a
    camera block whose Schur inverse is not finite falls back to its Hpp
    inverse.  The base apply is kernel 6, on a bfloat16 copy under `bf16`
    (its bf16 arm with `fused_kernels`, `block_rows_apply_bf16` without);
    NEUMANN is Horner's series over `s_matvec`, `neumann_order` S
    products and base applies more an apply.  Returns (apply, the [L]
    int32 fallback counts)."""
    Minv = block_inv_rows(Hpp_rows)
    n_bad = torch.zeros((cams.n_lanes,), dtype=torch.int32,
                        device=Hpp_rows.device)
    if block_kind == PreconditionerKind.SCHUR_DIAG:
        cd = int(round(Hpp_rows.shape[0] ** 0.5))
        pd = int(round(Hll_inv.shape[0] ** 0.5))
        corr = _schur_diag_rows(Hll_inv, W, Jc, Jp, plans, compute_kind, cd,
                                pd, Hpp_rows.dtype)
        minv_sd = block_inv_rows(Hpp_rows - corr)
        bad = ~torch.isfinite(minv_sd).all(0)
        Minv = torch.where(bad[None, :], Minv, minv_sd)
        n_bad = torch.clamp(cams.rows(bad).to(torch.int32).sum(1),
                            max=FALLBACK_BLOCK_RADIX - 1).to(torch.int32)
    if bf16:
        M_bf16 = Minv.to(torch.bfloat16)
        if fused_kernels:
            def base_apply(r: torch.Tensor) -> torch.Tensor:
                return fused.fused_block_diag_apply(M_bf16, r,
                                                    bf16_operands=True)
        else:
            def base_apply(r: torch.Tensor) -> torch.Tensor:
                return block_rows_apply_bf16(M_bf16, r)
    else:
        def base_apply(r: torch.Tensor) -> torch.Tensor:
            return fused.fused_block_diag_apply(Minv, r)
    if kind == PrecondKind.JACOBI:
        return base_apply, n_bad

    def neumann_apply(r: torch.Tensor) -> torch.Tensor:
        z = base_apply(r)
        for _ in range(int(neumann_order)):
            z = z + base_apply(r - s_matvec(z))
        return z

    return neumann_apply, n_bad


def lane_schur_pcg(system, Jc, Jp, plans, region, cams: Lanes, pts: Lanes,
                   live, max_iter, tol, refuse_ratio, tol_relative, x0=None,
                   guard=False, max_restarts=0,
                   compute_kind: ComputeKind = ComputeKind.IMPLICIT,
                   fused_kernels: bool = False, mixed_precision: bool = False,
                   bf16: bool = False,
                   precond: PrecondKind = PrecondKind.JACOBI,
                   preconditioner: PreconditionerKind = PreconditionerKind.HPP,
                   neumann_order: int = 2) -> LanePCG:
    """The damped Schur solve of every live lane (`schur_pcg_solve`),
    `region` [L]: S p = Hpp_d p - Hpl Hll_d^-1 Hlp p with the coupling
    products of `make_coupling_matvecs` under `compute_kind` and
    `fused_kernels` (EXPLICIT reads `system.W`; fused needs the fused
    plans on `plans`) and the camera blocks' products by kernel 6.  The
    precision rungs (`mixed_precision`, `bf16`) equilibrate first
    (`lane_equilibrate`), run the coupling kernels in their mixed or bf16
    arm on the bfloat16 rows, bring `x0` into the scaled variables and
    unscale the solution; `bf16` runs the textbook body with a relative
    `tol` floored at `_BF16_TOL_FLOOR`.  `precond` / `preconditioner`
    pick M^-1 (`lane_preconditioner`)."""
    Hpp_rows = damp_rows(fused.block_diag_rows(system.Hpp),
                         cams.expand(region))
    Hll_d = damp_rows(system.Hll, pts.expand(region))
    g_cam, g_pt = system.g_cam, system.g_pt
    W = None if system.W is None else system.W[0]
    dual = plans.shards[0]
    equil = mixed_precision or bf16
    if equil:
        (Hpp_rows, Hll_d, g_cam, g_pt, Jc, Jp, W, d_cam,
         d_pt) = lane_equilibrate(Hpp_rows, Hll_d, g_cam, g_pt, Jc, Jp, W,
                                  dual, compute_kind)
    Hll_inv = block_inv_fm(Hll_d)
    hpl, hlp = make_coupling_matvecs(Jc, Jp, dual, compute_kind, W,
                                     fused_kernels, bf16)

    def s_matvec(p: torch.Tensor) -> torch.Tensor:
        t = block_matvec_fm(Hll_inv, hlp(p))
        return fused.fused_block_diag_apply(Hpp_rows, p) - hpl(t)

    precond_apply, fallback = lane_preconditioner(
        precond, preconditioner, Hpp_rows, Hll_inv, W, Jc, Jp, dual,
        compute_kind, cams, s_matvec, neumann_order, bf16, fused_kernels)
    v = g_cam - hpl(block_matvec_fm(Hll_inv, g_pt))
    if x0 is not None and equil:
        x0 = x0 / d_cam
    if bf16 and tol_relative:
        tol = (torch.clamp(tol, min=_BF16_TOL_FLOOR)
               if isinstance(tol, torch.Tensor) else max(tol, _BF16_TOL_FLOOR))
    x, iters, rho, r0_ratio, restarts, broken, k = _lane_pcg_core(
        s_matvec, precond_apply, v, LaneSpace(cams), live, max_iter, tol,
        refuse_ratio, tol_relative, x0=x0, guard=guard,
        max_restarts=max_restarts, classic=bf16)
    dx_pt = block_matvec_fm(Hll_inv, g_pt - hlp(x))
    if equil:
        x = x * d_cam
        dx_pt = dx_pt * d_pt
    return LanePCG(dx_cam=x, dx_pt=dx_pt, iterations=iters, rho=rho,
                   r0_ratio=r0_ratio, breakdowns=restarts, broken=broken,
                   batch_iterations=k, precond_fallback=fallback)


def lane_plain_pcg(system, Jc, Jp, plans, region, cams: Lanes, pts: Lanes,
                   live, max_iter, tol, refuse_ratio, tol_relative, x0=None,
                   guard=False, max_restarts=0,
                   compute_kind: ComputeKind = ComputeKind.IMPLICIT
                   ) -> LanePCG:
    """The damped full-system solve of every live lane (`plain_pcg_solve`,
    `use_schur=False`): CG over the (camera, point) pair (`LaneSpace` of
    both), H x = (Hpp_d xc + Hpl xp, Hlp xc + Hll_d xp) with the coupling
    products of `make_coupling_matvecs` and the camera blocks' product by
    kernel 6; M^-1 the inverted damped block diagonal, the camera blocks
    by `block_inv_rows` applied by kernel 6, the point blocks by
    `block_inv_fm` / `block_matvec_fm`.  `x0` a (dx_cam, dx_pt) pair."""
    Hpp_rows = damp_rows(fused.block_diag_rows(system.Hpp),
                         cams.expand(region))
    Hll_d = damp_rows(system.Hll, pts.expand(region))
    Minv_c = block_inv_rows(Hpp_rows)
    Minv_p = block_inv_fm(Hll_d)
    hpl, hlp = make_coupling_matvecs(
        Jc, Jp, plans.shards[0], compute_kind,
        None if system.W is None else system.W[0])

    def h_matvec(x):
        xc, xp = x
        return (fused.fused_block_diag_apply(Hpp_rows, xc) + hpl(xp),
                hlp(xc) + block_matvec_fm(Hll_d, xp))

    def precond(r):
        rc, rp = r
        return (fused.fused_block_diag_apply(Minv_c, rc),
                block_matvec_fm(Minv_p, rp))

    (xc, xp), iters, rho, r0_ratio, restarts, broken, k = _lane_pcg_core(
        h_matvec, precond, (system.g_cam, system.g_pt), LaneSpace(cams, pts),
        live, max_iter, tol, refuse_ratio, tol_relative, x0=x0, guard=guard,
        max_restarts=max_restarts)
    return LanePCG(dx_cam=xc, dx_pt=xp, iterations=iters, rho=rho,
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
    if fused_kernels or uses_seg_reduce(option):
        # A slot tile (kernel 4, the fused kernels) sums the segments that
        # start in it: tiles that never straddle two lanes keep each
        # lane's tables its own.  The ladder's edge buckets are multiples
        # of EDGE_QUANTUM.
        if n_edge % segtiles.SLOT_TILE:
            raise ValueError(
                f"lane_lm_solve: EXPLICIT, SCHUR_DIAG and fused_kernels need "
                f"a bucket edge count that is a multiple of "
                f"{segtiles.SLOT_TILE} (the slot tile), got {n_edge}")
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
    use_schur = option.use_schur
    step_space = LaneSpace(cams) if use_schur else LaneSpace(cams, pts)
    dx0 = None
    if warm_start:
        dx0 = torch.zeros_like(cameras_u)
        if not use_schur:  # the plain solver warm-starts the pair
            dx0 = (dx0, torch.zeros_like(points_u))
    pcg_kw = dict(compute_kind=compute_kind, guard=guards,
                  max_restarts=robust_opt.pcg_max_restarts if guards else 0)
    if use_schur:
        pcg_solve = lane_schur_pcg
        pcg_kw.update(fused_kernels=fused_kernels,
                      mixed_precision=option.mixed_precision_pcg,
                      bf16=solver_opt.bf16, precond=solver_opt.precond,
                      preconditioner=solver_opt.preconditioner,
                      neumann_order=solver_opt.neumann_order)
    else:
        pcg_solve = lane_plain_pcg
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
        census.mark("lm")
        live = ~stop
        pcg = pcg_solve(
            system, Jc, Jp, plans, region, cams, pts, live,
            solver_opt.max_iter, eta * eta if forcing else solver_opt.tol,
            solver_opt.refuse_ratio, forcing or solver_opt.tol_relative,
            x0=dx0, **pcg_kw)
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
            dx = dx_cam if use_schur else (dx_cam, dx_pt)
            dx0 = step_space.where(live, step_space.where(
                accept, dx, step_space.zeros_like(dx)), dx0)

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
            recover.to(tdtype), pcg.breakdowns.to(tdtype),
            (zeros_i if pcg.precond_fallback is None
             else pcg.precond_fallback).to(tdtype)]))
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

    census.mark("lm_done")
    return LaneSolve(
        results=_lane_results(
            cameras_u, points_u, cost, cost0, region, v, stop, fatal,
            accepted, iters, pcg_total, recoveries,
            dx0 if use_schur or dx0 is None else dx0[0], rows, cams, pts,
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
                  else torch.zeros((0, 11, n_lanes), dtype=tdtype))
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
        trace.precond_fallback[:it] = t[:, 10].to(torch.int32)
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

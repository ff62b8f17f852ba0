"""Schur-complement preconditioned conjugate gradients (feature-major).

Counterpart of `megba_tpu/solver/pcg.py` for the single-device path:

  1. invert the damped Hll blocks (row-form closed-form adjugates);
  2. reduced RHS v = g_cam - Hpl Hll^-1 g_pt;
  3. PCG on S x = v, S = Hpp - Hpl Hll^-1 Hlp, block-Jacobi M^-1 = Hpp^-1;
  4. back-substitute dx_pt = Hll^-1 (g_pt - Hlp x).

Hpl/Hlp are never formed as matrices.  IMPLICIT recomputes each product
from the stored Jacobian rows: unfused, as a `coupling_expand` kernel
(u = J x per edge), a cross permute of the [od] rows to the other order,
and a `coupling_reduce` kernel (J^T u summed per vertex); fused
(`fused_kernels`), as one `fused_coupling_apply_implicit` kernel per
direction, with Jc brought into point order and Jp into camera order
once per solve.  EXPLICIT contracts the stored per-edge blocks W
(SchurSystem.W): unfused, as a `seg_expand` kernel, the per-edge W
contraction in plain PyTorch, a cross permute and a `seg_reduce` kernel;
fused, as one `fused_coupling_apply` kernel per direction, with W
brought into point order once per solve.

The precision ladder: both rungs (`mixed_precision`, `bf16`) first
equilibrate the system with D = diag(damped H)^-1/2 and cast the scaled
coupling rows (Jc/Jp or W) to bfloat16.  `mixed_precision` upcasts each
row value before the multiply, at float32 or float64; `bf16` (float32)
rounds the gathered vector to bfloat16, multiplies in bfloat16 with
float32 sums (`_edge_precision`, JAX pcg.py:133-163), applies a bfloat16
copy of M^-1 and runs the textbook CG body.  The rows' precision arm
rides every kernel of the product: unfused IMPLICIT in both coupling
kernels, unfused EXPLICIT in the plain per-edge W contraction between
`seg_expand` and `seg_reduce`, fused in the fused kernel.

The PCG bodies are the JAX package's `_pcg_core`: the
Chronopoulos-Gear single recurrence, or the textbook recurrence with the
stagnation exit (`_pcg_core_classic`), as Python loops, each unguarded
or with the breakdown guard and its in-loop restarts (`guard`); each
exit test reads |rho|, the refuse flag and (guarded) the broken flag on
the host once per iteration.  Either body takes a warm start `x0`
(SolverOption.warm_start): one more S·p product and one more M^-1 apply
per solve.  The same core runs the plain full-system solve
(`plain_pcg_solve`, `use_schur=False`) over a (camera, point) pair.

Both solvers run over a mesh (`plans` a `parallel.mesh.ShardedPlans`,
one device a mesh of one shard; the edge rows per-shard tuples): every
coupling product runs per shard (`make_coupling_matvecs` over the
shard's own plans) and is summed across the shards on the first shard's
device (`summed_matvecs`, the psums at JAX pcg.py:270-417, 1095, 1309
and 1333); the CG vectors, scalars and the preconditioner apply are
replicated state and live there once.  With `bf16_collectives` the S.p
product's sums over several shards carry bfloat16 payloads, the reduced
RHS and the back-substitution full precision.  On the 2-D camera x edge
mesh (`plans.tile_plan`) the S.p product is `make_matvec_2d`: subgroup
sums and a ring over the camera columns.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from megba_tpu_torch.analysis import census
from megba_tpu_torch.common import ComputeKind, PrecondKind, PreconditionerKind
from megba_tpu_torch.core.fm import block_inv_fm, block_matvec_fm, damp_rows_fm
from megba_tpu_torch.linear_system.builder import SchurSystem, damp_blocks
from megba_tpu_torch.ops.accum import comp_dot
from megba_tpu_torch.ops import fused, segtiles
from megba_tpu_torch.ops.segtiles import DualPlans
from megba_tpu_torch.parallel.collectives import (
    REMOTE,
    all_gather,
    for_shards,
    payload_cast,
    per_shard,
    ppermute,
    psum,
    psum_groups,
    psum_scatter,
)
from megba_tpu_torch.parallel.mesh import CAM_AXIS, EDGE_AXIS, ShardedPlans
from megba_tpu_torch.solver.precond import (
    block_inv,
    cam_block_matvec,
    make_schur_preconditioner,
)

# Absolute floor for the relative PCG threshold (guards rho0 == 0).
_TINY_RHO = 1e-30
# Floor of the relative threshold under the bf16 rung (JAX pcg.py:66-75):
# a bf16-operand operator does not resolve relative residual energies
# much below eps_bf16^2.
_BF16_TOL_FLOOR = 1e-3


@dataclasses.dataclass
class PCGResult:
    """Solve output: the Schur update and diagnostics (feature-major)."""

    dx_cam: torch.Tensor  # [cd, Nc]
    dx_pt: torch.Tensor  # [pd, Np]
    iterations: int
    rho: torch.Tensor  # final residual energy <r, M^-1 r>
    # |<r0, M^-1 r0>| / |<b, M^-1 b>| of a warm start (1 for a cold one).
    r0_ratio: torch.Tensor
    # Under guards: the in-loop cold restarts the breakdown guard made and
    # whether the solve exited broken (device tensors; 0 and False
    # without guards).  The enum-coded preconditioner fallback count
    # (solver/precond.encode_precond_fallback; 0 on the HPP diagonal).
    breakdowns: Union[int, torch.Tensor] = 0
    broken: Union[bool, torch.Tensor] = False
    precond_fallback: Union[int, torch.Tensor] = 0


def _ident(x):
    return x


def _edge_precision(bf16_ops: bool):
    """(vec, acc) casts of the unfused per-edge W contraction (JAX
    pcg.py:133-163): `vec` applies to the gathered vector rows (the bf16
    rung's rounding to bfloat16) and `acc` to every product before it
    enters a sum (the bf16 rung's float32 accumulation).  The bf16 rung
    multiplies bfloat16 by bfloat16, which PyTorch rounds to bfloat16
    once, as the JAX package's strict lowering does.  The mixed rung's
    `up` needs no cast here: PyTorch's type promotion takes a bfloat16
    row times a float32 or float64 vector in the vector's dtype."""
    if bf16_ops:
        return lambda x: x.to(torch.bfloat16), lambda x: x.to(torch.float32)
    return _ident, _ident


def _edge_cam_to_pt_explicit(W, pe, cd, pd, acc=_ident):
    """W^T applied per edge: [cd, n] camera rows -> [pd, n]."""
    return torch.stack([
        sum(acc(W[a * pd + b] * pe[a]) for a in range(cd))
        for b in range(pd)])


def _edge_pt_to_cam_explicit(W, qe, cd, pd, acc=_ident):
    """W applied per edge: [pd, n] point rows -> [cd, n]."""
    return torch.stack([
        sum(acc(W[a * pd + b] * qe[b]) for b in range(pd))
        for a in range(cd)])


MatvecPair = Tuple[Callable[[torch.Tensor], torch.Tensor],
                   Callable[[torch.Tensor], torch.Tensor]]


def shard_matvec_pairs(Jc, Jp, plans: ShardedPlans,
                       compute_kind: ComputeKind = ComputeKind.IMPLICIT,
                       W=None, fused_kernels: bool = False,
                       bf16_ops: bool = False) -> list:
    """Each shard's (hpl, hlp) over its own edges (`make_coupling_matvecs`
    over the shard's plans): per-vertex partial sums on the shard's
    device, not yet summed across the shards."""
    n = len(plans.shards)
    return for_shards(
        lambda jc, jp, w, pl: make_coupling_matvecs(
            jc, jp, pl, compute_kind, w, fused_kernels, bf16_ops),
        per_shard(Jc, n), per_shard(Jp, n), per_shard(W, n), plans.shards)


def summed_matvecs(pairs: list, devices,
                   bf16_collectives: bool = False) -> MatvecPair:
    """The world-wide (hpl, hlp) of the shards' pairs: each shard applies
    its own to the vector (moved to its device), and the partial sums are
    summed in shard order on the vector's device, as bfloat16 payloads
    under `bf16_collectives` when there are several (one shard's sum
    moves nothing)."""
    wire = bf16_collectives and len(pairs) > 1

    def reduced(i):
        def apply(x: torch.Tensor) -> torch.Tensor:
            down, up = payload_cast(wire, x.dtype)
            parts = for_shards(lambda pr, d: down(pr[i](x.to(d))), pairs,
                               devices)
            return up(psum(parts, x.device))
        return apply

    return reduced(0), reduced(1)


def make_coupling_matvecs(
    Jc: Optional[torch.Tensor],
    Jp: Optional[torch.Tensor],
    plans: DualPlans,
    compute_kind: ComputeKind = ComputeKind.IMPLICIT,
    W: Optional[torch.Tensor] = None,
    fused_kernels: bool = False,
    bf16_ops: bool = False,
) -> MatvecPair:
    """Build hpl(q_pt [pd,Np]) -> [cd,Nc] and hlp(p_cam [cd,Nc]) -> [pd,Np].

    IMPLICIT reads only `Jc` (cam-slot order) and `Jp` (pt-slot order,
    algo/lm.py carries it there): unfused, each direction is expand ->
    cross permute -> reduce, and the expanded [cd]/[pd] per-edge rows
    never exist.  EXPLICIT reads only `W` (cam-slot order).  With
    `fused_kernels` each direction is one fused kernel and `plans` must
    carry the fused directions (ops/fused.with_fused_plans).  The rows
    may be bfloat16 (a precision rung): each kernel, and the unfused
    EXPLICIT contraction, takes them upcast before each multiply, or
    multiplied in bfloat16 under `bf16_ops`.  One device's (or one
    shard's) edges: `shard_matvec_pairs` and `summed_matvecs` make the
    pair of a mesh.
    """
    if fused_kernels:
        if plans.fused_to_pt is None or plans.fused_to_cam is None:
            raise ValueError("fused_kernels needs the fused plans on the "
                             "dual plans (ops/fused.with_fused_plans; "
                             "flat_solve plans them)")
        if compute_kind == ComputeKind.EXPLICIT:
            return _fused_explicit_matvecs(_need_w(W), plans, bf16_ops)
        return _fused_implicit_matvecs(Jc, Jp, plans, bf16_ops)
    if compute_kind == ComputeKind.EXPLICIT:
        return _explicit_matvecs(_need_w(W), plans,
                                 *_edge_precision(bf16_ops))
    ocd, opd = Jc.shape[0], Jp.shape[0]

    def hlp(p_cam: torch.Tensor) -> torch.Tensor:
        cd = p_cam.shape[0]
        od = ocd // cd
        pd = opd // od
        u = segtiles.coupling_expand(p_cam, Jc, plans.cam, cd, bf16_ops)
        return segtiles.coupling_reduce(Jp, plans.to_pt(u), plans.pt, pd,
                                        bf16_ops)

    def hpl(q_pt: torch.Tensor) -> torch.Tensor:
        pd = q_pt.shape[0]
        od = opd // pd
        cd = ocd // od
        u = segtiles.coupling_expand(q_pt, Jp, plans.pt, pd, bf16_ops)
        return segtiles.coupling_reduce(Jc, plans.to_cam(u), plans.cam, cd,
                                        bf16_ops)

    return hpl, hlp


def _need_w(W: Optional[torch.Tensor]) -> torch.Tensor:
    if W is None:
        raise ValueError("EXPLICIT coupling products need the stored "
                         "W rows (SchurSystem.W)")
    return W


def _explicit_matvecs(W: torch.Tensor, plans: DualPlans, vec=_ident,
                      acc=_ident) -> MatvecPair:
    """EXPLICIT, unfused (JAX pcg.py:333-349): gather the vector to the
    edges, contract with W per edge (with the rung's casts), permute,
    segment-sum."""
    cdpd = W.shape[0]

    def hlp(p_cam: torch.Tensor) -> torch.Tensor:
        cd = p_cam.shape[0]
        pd = cdpd // cd
        pe = vec(segtiles.seg_expand(p_cam, plans.cam))  # [cd, n] cam slots
        te = _edge_cam_to_pt_explicit(W, pe, cd, pd, acc)
        return segtiles.seg_reduce(plans.to_pt(te), plans.pt)

    def hpl(q_pt: torch.Tensor) -> torch.Tensor:
        pd = q_pt.shape[0]
        cd = cdpd // pd
        qe = vec(plans.to_cam(segtiles.seg_expand(q_pt, plans.pt)))
        te = _edge_pt_to_cam_explicit(W, qe, cd, pd, acc)
        return segtiles.seg_reduce(te, plans.cam)

    return hpl, hlp


def _fused_explicit_matvecs(W: torch.Tensor, plans: DualPlans,
                            bf16_ops: bool) -> MatvecPair:
    """EXPLICIT, fused (JAX pcg.py:291-303): one kernel per direction.
    W is brought into point-slot order here, once per PCG solve."""
    fp_tp, fp_tc = plans.fused_to_pt, plans.fused_to_cam
    W_tp = plans.to_pt(W)

    def hlp(p_cam: torch.Tensor) -> torch.Tensor:
        return fused.fused_coupling_apply(W_tp, p_cam, fp_tp, w_in_major=True,
                                          bf16_operands=bf16_ops)

    def hpl(q_pt: torch.Tensor) -> torch.Tensor:
        return fused.fused_coupling_apply(W, q_pt, fp_tc, w_in_major=False,
                                          bf16_operands=bf16_ops)

    return hpl, hlp


def _fused_implicit_matvecs(Jc: torch.Tensor, Jp: torch.Tensor,
                            plans: DualPlans, bf16_ops: bool) -> MatvecPair:
    """IMPLICIT, fused (JAX pcg.py:305-326): one kernel per direction.
    Each direction reads its input side's rows in the output side's slot
    order, so Jc goes to point order and Jp to camera order here, once
    per PCG solve (the permute keeps the rows' dtype)."""
    fp_tp, fp_tc = plans.fused_to_pt, plans.fused_to_cam
    Jc_tp = plans.to_pt(Jc)
    Jp_tc = plans.to_cam(Jp)

    def hlp(p_cam: torch.Tensor) -> torch.Tensor:
        return fused.fused_coupling_apply_implicit(
            Jc_tp, Jp, p_cam, fp_tp, bf16_operands=bf16_ops)

    def hpl(q_pt: torch.Tensor) -> torch.Tensor:
        return fused.fused_coupling_apply_implicit(
            Jp_tc, Jc, q_pt, fp_tc, bf16_operands=bf16_ops)

    return hpl, hlp


# The PCG vector is one tensor (the Schur solve) or a (camera, point)
# pair (the plain full-system solve): leafwise helpers, as the JAX
# package's tree_map / tree_reduce.


def _tmap(fn, *trees):
    if isinstance(trees[0], tuple):
        return tuple(fn(*leaves) for leaves in zip(*trees))
    return fn(*trees)


def _tdot(a, c) -> torch.Tensor:
    """Compensated dot summed over the leaves, camera leaf first."""
    if isinstance(a, tuple):
        out = None
        for ai, ci in zip(a, c):
            d = comp_dot(ai, ci)
            out = d if out is None else out + d
        return out
    return comp_dot(a, c)


def _axpy(a, x, y):
    """y + a * x, leafwise (the unguarded bodies' expression forms)."""
    return _tmap(lambda xi, yi: yi + a * xi, x, y)


def _select(pred, a, c):
    return _tmap(lambda ai, ci: torch.where(pred, ai, ci), a, c)


def _zeros_like(b):
    return _tmap(torch.zeros_like, b)


def _pcg_core(matvec, precond, b, max_iter, tol, refuse_ratio, tol_relative,
              fused=True, x0=None, guard=False, max_restarts=0):
    """Preconditioned CG (JAX `_pcg_core`) over a tensor or a (camera,
    point) pair.

    Exits when |rho| < threshold (absolute `tol`, or `tol` times the RHS
    energy <b, M^-1 b> under `tol_relative`; `tol` may be a device
    scalar), after `max_iter` iterations, or when rho exceeds
    refuse_ratio * min(rho) — then the best iterate is restored.
    `fused` runs the Chronopoulos-Gear single recurrence (one priming
    matvec, then one matvec a step); otherwise the textbook body
    `_pcg_core_classic`.

    `x0` warm-starts the iteration: r0 = b - A x0 (one more matvec) and
    one more preconditioner apply for the RHS energy, which stays the
    anchor of the relative threshold.  A warm start whose residual
    energy exceeds the RHS energy falls back to the cold start.

    `guard` (RobustOption.guards) arms breakdown detection: a non-finite
    or sign-flipped gamma = <r, M^-1 r> or delta = <u, A u> starts an
    in-loop cold restart from the current iterate: the next body
    iteration's one matvec computes A x for the true residual r = b - A x,
    the one after re-primes the recurrence.  At most `max_restarts`
    restarts; one more breakdown exits `broken` with the best iterate.
    The phase, restart count and `broken` are device tensors selected by
    `torch.where`, every body iteration keeps one matvec and one
    preconditioner apply, `broken` folds into the loop's one host read,
    and a run with no breakdown selects the unguarded values bitwise.

    Returns (x, iterations, rho, r0_ratio, restarts, broken): r0_ratio =
    |rho0| / |<b, M^-1 b>| before the warm-start fallback (1 for a cold
    start); restarts and broken are device tensors under `guard`, 0 and
    False otherwise.
    """
    if x0 is None:
        x = _zeros_like(b)
        r = b
        u0 = precond(r)
        rho = _tdot(r, u0)
        rhs_energy = rho
        r0_ratio = torch.ones_like(rho)
    else:
        r = _tmap(lambda bi, ai: bi + (-1.0) * ai, b, matvec(x0))
        u0 = precond(r)
        rho = _tdot(r, u0)
        ub = precond(b)
        rhs_energy = _tdot(b, ub)
        r0_ratio = rho.abs() / torch.clamp(rhs_energy.abs(), min=_TINY_RHO)
        use_ws = rho.abs() <= rhs_energy.abs()
        x = _select(use_ws, x0, _zeros_like(b))
        r = _select(use_ws, r, b)
        u0 = _select(use_ws, u0, ub)
        rho = torch.where(use_ws, rho, rhs_energy)
    threshold = (torch.clamp(tol * rhs_energy.abs(), min=_TINY_RHO)
                 if tol_relative else torch.as_tensor(tol, dtype=rho.dtype,
                                                      device=rho.device))
    if not fused:
        return _pcg_core_classic(matvec, precond, b, max_iter, threshold,
                                 refuse_ratio, x, r, u0, rho, rhs_energy,
                                 r0_ratio, guard, max_restarts)
    # Prime the recurrence: p0 = u0, s0 = A p0, alpha0 = rho0 / <p0, A p0>.
    w0 = matvec(u0)
    delta0 = _tdot(u0, w0)
    alpha = rho / torch.where(delta0 == 0, torch.ones_like(delta0), delta0)
    p, s = u0, w0
    rho_min = rho.abs()
    x_best = x
    refused = torch.zeros((), dtype=torch.bool, device=rho.device)
    k = 0
    if not guard:
        while k < max_iter and bool((rho.abs() >= threshold) & ~refused):
            census.mark("pcg")
            x = _axpy(alpha, p, x)
            r = _axpy(-alpha, s, r)
            u = precond(r)
            w = matvec(u)
            rho_new = _tdot(r, u)
            delta = _tdot(u, w)
            beta = rho_new / rho
            alpha = rho_new / (delta - beta * rho_new / alpha)
            p = _axpy(beta, p, u)  # u + beta p
            s = _axpy(beta, s, w)  # w + beta s == A p, by linearity
            refused = rho_new.abs() > refuse_ratio * rho_min
            improved = rho_new.abs() < rho_min
            rho_min = torch.where(improved, rho_new.abs(), rho_min)
            x_best = _select(improved, x, x_best)
            rho = rho_new
            k += 1
        census.mark("pcg_done")
        return _select(refused, x_best, x), k, rho, r0_ratio, 0, False

    # Guarded body (JAX pcg.py:801-874): phase 0 advances, 1 refreshes
    # the residual r = b - A x, 2 re-primes (p = M^-1 r, s = A p,
    # alpha = rho / delta).  Each phase runs the same one precond and
    # one matvec.
    dev = rho.device
    keepalive = torch.maximum(rhs_energy.abs(), threshold) * 2.0 + 1.0
    phase = torch.zeros((), dtype=torch.int32, device=dev)
    restarts = torch.zeros((), dtype=torch.int32, device=dev)
    broken = torch.zeros((), dtype=torch.bool, device=dev)
    one, two = (torch.ones((), dtype=torch.int32, device=dev),
                torch.full((), 2, dtype=torch.int32, device=dev))
    while k < max_iter and bool((rho.abs() >= threshold) & ~refused
                                & ~broken):
        census.mark("pcg")
        advancing = phase == 0
        refresh = phase == 1
        reprime = phase == 2
        step = torch.where(advancing, alpha, torch.zeros_like(alpha))
        x = _axpy(step, p, x)
        r = _axpy(-step, s, r)
        u = precond(r)
        # The one matvec: A u normally, A x during the residual refresh.
        w = matvec(_select(refresh, x, u))
        r = _select(refresh, _tmap(lambda bi, wi: bi + (-1.0) * wi, b, w), r)
        rho_new = _tdot(r, u)  # stale u during a refresh: masked below
        delta = _tdot(u, w)
        beta = rho_new / rho
        alpha_cg = rho_new / (delta - beta * rho_new / alpha)
        alpha_fresh = rho_new / torch.where(delta == 0,
                                            torch.ones_like(delta), delta)
        breakdown = ~refresh & (
            ~(torch.isfinite(rho_new) & torch.isfinite(delta))
            | (rho_new < 0) | (delta < 0))
        enter = breakdown & (restarts < max_restarts)
        broken = broken | (breakdown & (restarts >= max_restarts))
        phase = torch.where(enter, one, torch.where(refresh, two,
                                                    torch.zeros_like(phase)))
        restarts = restarts + enter.to(torch.int32)
        ok_adv = advancing & ~breakdown
        ok_rep = reprime & ~breakdown
        alpha = torch.where(ok_rep, alpha_fresh,
                            torch.where(ok_adv, alpha_cg, alpha))
        rho_next = torch.where(enter | refresh, keepalive, rho_new)
        p = _select(ok_rep, u, _select(ok_adv, _axpy(beta, p, u), p))
        s = _select(ok_rep, w, _select(ok_adv, _axpy(beta, s, w), s))
        refused = ok_adv & (rho_new.abs() > refuse_ratio * rho_min)
        improved = ok_adv & (rho_new.abs() < rho_min)
        rho_min = torch.where(improved, rho_new.abs(), rho_min)
        x_best = _select(improved, x, x_best)
        rho = rho_next
        k += 1
    census.mark("pcg_done")
    return (_select(~refused & ~broken, x, x_best), k, rho, r0_ratio,
            restarts, broken)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / torch.where(den == 0, torch.ones_like(den), den)


def _pcg_core_classic(matvec, precond, b, max_iter, threshold, refuse_ratio,
                      x, r, u0, rho, rhs_energy, r0_ratio, guard=False,
                      max_restarts=0):
    """The textbook PCG body (JAX pcg.py:877-1010): s = A p fresh each
    step, alpha = rho / <p, s>, no priming matvec.  A finite sign flip of
    rho = <r, M^-1 r> or delta = <p, A p> (a bf16-operand operator at its
    resolution) is a stall: the best iterate is restored and the solve
    stops, as a refused step does.  Under `guard` only a non-finite
    scalar is a breakdown; its restart is one iteration whose matvec
    computes A x for r = b - A x, p = M^-1 r."""
    p = u0
    rho_min = rho.abs()
    x_best = x
    refused = torch.zeros((), dtype=torch.bool, device=rho.device)
    k = 0
    if not guard:
        while k < max_iter and bool((rho.abs() >= threshold) & ~refused):
            census.mark("pcg")
            s = matvec(p)
            delta = _tdot(p, s)
            alpha = _safe_div(rho, delta)
            x = _axpy(alpha, p, x)
            r = _axpy(-alpha, s, r)
            u = precond(r)
            rho_new = _tdot(r, u)
            beta = _safe_div(rho_new, rho)
            p = _axpy(beta, p, u)
            stall = (rho_new < 0) | (delta < 0)
            refused = stall | (rho_new.abs() > refuse_ratio * rho_min)
            improved = ~stall & (rho_new.abs() < rho_min)
            rho_min = torch.where(improved, rho_new.abs(), rho_min)
            x_best = _select(improved, x, x_best)
            rho = rho_new
            k += 1
        census.mark("pcg_done")
        return _select(refused, x_best, x), k, rho, r0_ratio, 0, False

    dev = rho.device
    keepalive = torch.maximum(rhs_energy.abs(), threshold) * 2.0 + 1.0
    phase = torch.zeros((), dtype=torch.int32, device=dev)
    restarts = torch.zeros((), dtype=torch.int32, device=dev)
    broken = torch.zeros((), dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    while k < max_iter and bool((rho.abs() >= threshold) & ~refused
                                & ~broken):
        census.mark("pcg")
        advancing = phase == 0
        refresh = phase == 1
        # The one matvec: A p normally, A x during the refresh.
        w = matvec(_select(refresh, x, p))
        delta = _tdot(p, w)  # stale during a refresh: masked below
        alpha = _safe_div(rho, delta)
        step = torch.where(advancing, alpha, torch.zeros_like(alpha))
        x_new = _axpy(step, p, x)
        r_new = _select(refresh, _tmap(lambda bi, wi: bi + (-1.0) * wi, b, w),
                        _axpy(-step, w, r))
        u = precond(r_new)
        rho_new = _tdot(r_new, u)
        finite = torch.isfinite(rho_new) & torch.isfinite(delta)
        stall = advancing & finite & ((rho_new < 0) | (delta < 0))
        breakdown = advancing & ~finite
        enter = breakdown & (restarts < max_restarts)
        broken = broken | (breakdown & (restarts >= max_restarts))
        restarts = restarts + enter.to(torch.int32)
        phase = torch.where(enter, one, torch.zeros_like(phase))
        ok_adv = advancing & ~breakdown & ~stall
        x = _select(ok_adv, x_new, x)
        r = _select(ok_adv | refresh, r_new, r)
        beta = _safe_div(rho_new, rho)
        p = _select(refresh, u, _select(ok_adv, _axpy(beta, p, u), p))
        rho_next = torch.where(enter, keepalive, rho_new)
        refused = stall | (ok_adv & (rho_new.abs() > refuse_ratio * rho_min))
        improved = ok_adv & (rho_new.abs() < rho_min)
        rho_min = torch.where(improved, rho_new.abs(), rho_min)
        x_best = _select(improved, x, x_best)
        rho = rho_next
        k += 1
    census.mark("pcg_done")
    return (_select(~refused & ~broken, x, x_best), k, rho, r0_ratio,
            restarts, broken)


def _scale_rows(Jc, Jp, W, plans: DualPlans, d_cam: torch.Tensor,
                d_pt: torch.Tensor, compute_kind: ComputeKind):
    """One shard's coupling rows scaled per edge by the equilibration
    scales and cast to bfloat16 (the scales' `seg_expand`s are kernel 5
    on the card)."""
    cd, pd = d_cam.shape[0], d_pt.shape[0]
    bf = torch.bfloat16
    dc_e = segtiles.seg_expand(d_cam, plans.cam)
    dp_e = segtiles.seg_expand(d_pt, plans.pt)  # pt slots, like Jp
    if compute_kind == ComputeKind.EXPLICIT:
        dp_e = plans.to_cam(dp_e)
        W = torch.stack([W[a * pd + b] * dc_e[a] * dp_e[b]
                         for a in range(cd) for b in range(pd)]).to(bf)
    else:
        od = Jc.shape[0] // cd
        Jc = torch.stack([Jc[o * cd + a] * dc_e[a]
                          for o in range(od) for a in range(cd)]).to(bf)
        Jp = torch.stack([Jp[o * pd + b] * dp_e[b]
                          for o in range(od) for b in range(pd)]).to(bf)
    return Jc, Jp, W


def _equilibrate(system: SchurSystem, Jc, Jp, W, plans: ShardedPlans,
                 Hpp_d: torch.Tensor, Hll_d: torch.Tensor,
                 compute_kind: ComputeKind):
    """Jacobi (scale-then-cast) equilibration of both precision rungs
    (JAX pcg.py:1196-1243): with d = diag(damped H)^-1/2, scale Hpp_d and
    Hll_d symmetrically, g by d, the coupling rows per edge, and cast the
    scaled rows to bfloat16 (`_scale_rows`, per shard).  Returns
    the scaled system's pieces and the scales (d_cam [cd, Nc], d_pt
    [pd, Np]) that unscale the solution."""
    pd = int(round(Hll_d.shape[0] ** 0.5))
    dc = torch.rsqrt(torch.diagonal(Hpp_d, dim1=-2, dim2=-1))  # [Nc, cd]
    Hpp_d = Hpp_d * dc[:, :, None] * dc[:, None, :]
    d_cam = dc.T.contiguous()
    d_pt = torch.rsqrt(torch.stack([Hll_d[i * (pd + 1)]
                                    for i in range(pd)]))  # [pd, Np]
    Hll_d = Hll_d * torch.stack([d_pt[i] * d_pt[j]
                                 for i in range(pd) for j in range(pd)])
    g_cam = system.g_cam * d_cam
    g_pt = system.g_pt * d_pt
    n = len(plans.shards)
    out = for_shards(
        lambda jc, jp, w, pl, d: _scale_rows(
            jc, jp, w, pl, d_cam.to(d), d_pt.to(d), compute_kind),
        per_shard(Jc, n), per_shard(Jp, n), per_shard(W, n),
        plans.shards, plans.devices)
    Jc, Jp, W = (None if out[0][i] is None else
                 tuple(o[i] for o in out) for i in range(3))
    return Hpp_d, Hll_d, g_cam, g_pt, Jc, Jp, W, d_cam, d_pt


def make_matvec_2d(Jc, Jp, W, plans: ShardedPlans, Hpp_d: torch.Tensor,
                   Hll_inv: torch.Tensor,
                   compute_kind: ComputeKind = ComputeKind.IMPLICIT,
                   bf16_ops: bool = False, bf16_collectives: bool = False,
                   fused_kernels: bool = False, pairs: Optional[list] = None):
    """The Schur S.p product on the 2-D camera x edge mesh (JAX
    pcg.py:423-635), in five stages; device (e, c) is shard e*C + c, and
    the column-wide work of camera column c (its summed point shard, the
    Hll^-1 product and the camera reduction) runs on device (0, c), where
    the JAX package's subgroup psums leave a copy on every device.  On a
    mesh across processes that work runs in the process that owns
    (0, c), the hops between processes are point-to-point sends
    (collectives.ppermute) and the sums complete as the 1-D sums do, so
    the result is bitwise the one-process product:

      1. camera gather and product: each device's own hlp over its edges
         (every edge of device (e, c) has a camera in tile c), partial
         point sums [pd, Np] padded to C * Sp;
      2. point reduction: psum_scatter over the column (device (e, c)'s
         partials of point shard c summed over c'), then psum over the
         edge shards e;
      3. Hll^-1 on the owned point shard;
      4. the ring: device (e, c) first takes point shard c from device
         (0, c) (the broadcast half of the edge-axis psum); at step j it
         holds point shard s = (c + j) mod C, contracts its bucket over
         s with it and passes it one hop on, to device (e, c - 1), so
         each shard goes around the row's ring of columns (C - 1 hops);
         each step adds onto the device's [cd, Tc] tile in step order:
         one kernel 7 or 8 launch a step in its ring-step form
         (`fused.fused_single_block_apply`) with `fused_kernels`, or the
         unfused kernels (2 then 3 on IMPLICIT, 5, the plain W
         contraction and 4 on EXPLICIT) over the bucket's plans;
      5. camera reduction: the tiles summed over the edge shards, the
         camera blocks' own product Hpp_d p subtracted from, and all
         gathered over the columns.

    With `bf16_collectives` every payload of stages 2-5 (the scatter,
    both subgroup sums, the ring and the gather) is rounded to bfloat16
    (parallel/collectives.py), as the JAX package casts them.  The
    bucket rows are gathered into each bucket's entry order once here,
    per PCG solve.  An empty bucket adds nothing and launches nothing.
    `pairs` are the shards' (hpl, hlp) (`shard_matvec_pairs`, built here
    when not given).  Returns s_matvec(p [cd, Nc]) -> [cd, Nc] on p's
    device.
    """
    tp = plans.tile_plan
    C, Tc, Sp = tp.cam_blocks, tp.tile_cams, tp.shard_points
    devs = plans.devices
    Nc, cd = Hpp_d.shape[0], Hpp_d.shape[-1]
    Np = Hll_inv.shape[1]
    pd = int(round(Hll_inv.shape[0] ** 0.5))
    dtype = Hpp_d.dtype
    down, up = payload_cast(bf16_collectives, dtype)
    wire = torch.bfloat16 if bf16_collectives else dtype
    vec, acc = _edge_precision(bf16_ops)
    # Device (0, c) is shard c; None when another process owns it.
    col_dev = [devs[c] for c in range(C)]
    edge_groups = plans.mesh.axis_groups(EDGE_AXIS)
    cam_groups = plans.mesh.axis_groups(CAM_AXIS)
    Hpp_pad = F.pad(Hpp_d, (0, 0, 0, 0, 0, C * Tc - Nc))
    Hll_pad = F.pad(Hll_inv, (0, C * Sp - Np))
    Hpp_t = [None if col_dev[c] is None else
             Hpp_pad[c * Tc:(c + 1) * Tc].to(col_dev[c]) for c in range(C)]
    Hll_t = [None if col_dev[c] is None else
             Hll_pad[:, c * Sp:(c + 1) * Sp].contiguous().to(col_dev[c])
             for c in range(C)]
    n = len(plans.shards)
    if pairs is None:
        pairs = shard_matvec_pairs(Jc, Jp, plans, compute_kind, W,
                                   fused_kernels, bf16_ops)
    hlp_parts = [pr[1] for pr in pairs]

    def bucket_rows(jc, jp, w, pl, d):
        """Device d's rows in each bucket's entry order: (Jin, Jout) =
        (Jp, Jc) on IMPLICIT, W on EXPLICIT (camera-slot order)."""
        if compute_kind == ComputeKind.EXPLICIT:
            return [(w.index_select(1, ring.out.inv),)
                    for ring in tp.rings[d]]
        jp_cam = pl.to_cam(jp)
        return [(jp_cam.index_select(1, ring.out.inv),
                 jc.index_select(1, ring.out.inv)) for ring in tp.rings[d]]

    rows = for_shards(bucket_rows, per_shard(Jc, n), per_shard(Jp, n),
                      per_shard(W, n), plans.shards, range(n))

    def ring_step(d: int, s: int, cur: torch.Tensor) -> torch.Tensor:
        ring, rr = tp.rings[d][s], rows[d][s]
        if fused_kernels:
            if compute_kind == ComputeKind.EXPLICIT:
                return fused.fused_single_block_apply(
                    rr[0], cur, ring, w_in_major=False,
                    bf16_operands=bf16_ops)
            return fused.fused_single_block_apply(
                rr[0], cur, ring, rows_out=rr[1], bf16_operands=bf16_ops)
        in_plan = tp.in_plans[d][s]
        if compute_kind == ComputeKind.EXPLICIT:
            qe = vec(segtiles.seg_expand(cur, in_plan))
            te = _edge_pt_to_cam_explicit(rr[0], qe, cd, pd, acc)
            return segtiles.seg_reduce(te, ring.out)
        u = segtiles.coupling_expand(cur, rr[0], in_plan, pd, bf16_ops)
        return segtiles.coupling_reduce(rr[1], u, ring.out, cd, bf16_ops)

    # The ring's hops: device d first takes point shard c = d mod C from
    # device (0, c) (shard c), then at every step from (e, c + 1).
    take = [(d % C, d) for d in range(n)]
    hop = [(d - d % C + (d + 1) % C, d) for d in range(n)]
    held_like = ((pd, Sp), wire)

    def ring(curs: list) -> list:
        """Stage 4: every device's [cd, Tc] tile, summed over the steps
        in step order; `held[d]` is the point shard device d holds.
        Another process's device is `REMOTE` throughout."""
        held = ppermute(list(curs) + [None] * (n - C), take, devs, held_like)
        tiles = [REMOTE if devs[d] is None else
                 torch.zeros((cd, Tc), dtype=dtype, device=devs[d])
                 for d in range(n)]
        for j in range(C):
            if j:
                held = ppermute(held, hop, devs, held_like)

            def step(d: int):
                s = (d % C + j) % C
                if tp.rings[d][s].out.n_slots == 0:
                    return None
                return ring_step(d, s, up(held[d])).to(dtype)

            for d, t in enumerate(for_shards(step, range(n))):
                if t is not None and t is not REMOTE:
                    tiles[d] = tiles[d] + t
        return [t if t is REMOTE else down(t) for t in tiles]

    def s_matvec(p: torch.Tensor) -> torch.Tensor:
        # (1) per device: partial point sums of its edges.
        t_part = for_shards(
            lambda h, d: down(F.pad(h(p.to(d)), (0, C * Sp - Np))),
            hlp_parts, devs)
        # (2) scatter over the camera axis (shard (e, c) takes point
        # shard c of its row's partials), then sum over the edge axis.
        scattered = psum_scatter(t_part, C, 1, devs, groups=cam_groups)
        t_sh = [x if x is REMOTE else up(x)
                for x in psum_groups(scattered, edge_groups, col_dev)]
        # (3) Hll^-1 on each owned shard, by the process that owns (0, c).
        curs = [REMOTE if col_dev[c] is None else
                down(block_matvec_fm(Hll_t[c], t_sh[c])) for c in range(C)]
        # (4) the ring, per device.
        tiles = ring(curs)
        # (5) sum over the edge shards, Hpp p - Hpl t, gather the tiles.
        p_pad = F.pad(p, (0, C * Tc - Nc))
        hpl_t = psum_groups(tiles, edge_groups, col_dev)
        y_t = []
        for c in range(C):
            if col_dev[c] is None:
                y_t.append(REMOTE)
                continue
            p_t = p_pad[:, c * Tc:(c + 1) * Tc].to(col_dev[c])
            y_t.append(down(cam_block_matvec(Hpp_t[c], p_t) - up(hpl_t[c])))
        y = all_gather(y_t, 1, p.device, shards=range(C),
                       like=((cd, Tc), wire))
        return up(y)[:, :Nc].contiguous()

    return s_matvec


def plain_pcg_solve(
    system: SchurSystem,
    Jc: Optional[Tuple[torch.Tensor, ...]],
    Jp: Optional[Tuple[torch.Tensor, ...]],
    plans: ShardedPlans,
    region: torch.Tensor,
    max_iter: int = 100,
    tol: float = 1e-1,
    refuse_ratio: float = 1.0,
    tol_relative: bool = False,
    compute_kind: ComputeKind = ComputeKind.IMPLICIT,
    mixed_precision: bool = False,
    bf16: bool = False,
    x0: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    guard: bool = False,
    max_restarts: int = 0,
) -> PCGResult:
    """Solve the damped FULL system H dx = g without Schur reduction
    (JAX pcg.py:1013-1109): CG over the (camera, point) pair, the damped
    block diagonal (Hpp, Hll) inverted as the preconditioner, and each
    product (Hpp_d xc + hpl(xp), hlp(xc) + Hll_d xp) through the same
    coupling products as the Schur path (IMPLICIT: kernels 2 and 3;
    EXPLICIT: kernels 5 and 4).  The pair is never concatenated: the
    dots sum per leaf, camera first, as the JAX package's tree dots do.

    `x0` (a (dx_cam, dx_pt) pair) warm-starts the CG; `tol` may be a
    device scalar.  The precision rungs are Schur-only.
    """
    if mixed_precision:
        raise NotImplementedError(
            "mixed_precision is only implemented for the Schur solver")
    if bf16:
        raise NotImplementedError(
            "SolverOption.bf16 is only implemented for the Schur solver "
            "(validate_options refuses it with use_schur=False)")
    Hpp_d = damp_blocks(system.Hpp, region)
    Hll_d = damp_rows_fm(system.Hll, region)
    Minv_c = block_inv(Hpp_d)
    Minv_p = block_inv_fm(Hll_d)
    hpl, hlp = summed_matvecs(shard_matvec_pairs(
        Jc, Jp, plans, compute_kind, system.W), plans.devices)

    def h_matvec(x):
        xc, xp = x
        return (cam_block_matvec(Hpp_d, xc) + hpl(xp),
                hlp(xc) + block_matvec_fm(Hll_d, xp))

    def precond(r):
        rc, rp = r
        return cam_block_matvec(Minv_c, rc), block_matvec_fm(Minv_p, rp)

    (xc, xp), k, rho, r0_ratio, restarts, broken = _pcg_core(
        h_matvec, precond, (system.g_cam, system.g_pt), max_iter, tol,
        refuse_ratio, tol_relative, x0=x0, guard=guard,
        max_restarts=max_restarts)
    return PCGResult(dx_cam=xc, dx_pt=xp, iterations=k, rho=rho,
                     r0_ratio=r0_ratio, breakdowns=restarts, broken=broken)


def schur_pcg_solve(
    system: SchurSystem,
    Jc: Optional[Tuple[torch.Tensor, ...]],
    Jp: Optional[Tuple[torch.Tensor, ...]],
    plans: ShardedPlans,
    region: torch.Tensor,
    max_iter: int = 100,
    tol: float = 1e-1,
    refuse_ratio: float = 1.0,
    tol_relative: bool = False,
    compute_kind: ComputeKind = ComputeKind.IMPLICIT,
    fused_kernels: bool = False,
    mixed_precision: bool = False,
    bf16: bool = False,
    bf16_collectives: bool = False,
    x0: Optional[torch.Tensor] = None,
    guard: bool = False,
    max_restarts: int = 0,
    precond: PrecondKind = PrecondKind.JACOBI,
    preconditioner: PreconditionerKind = PreconditionerKind.HPP,
    neumann_order: int = 2,
    cluster_plan=None,
    cam_fixed: Optional[torch.Tensor] = None,
    smooth_omega: float = 0.0,
) -> PCGResult:
    """Solve the damped Schur system for (dx_cam, dx_pt), feature-major.

    `region` is the LM trust region: damping multiplies the block
    diagonals' diagonals by (1 + 1/region).  EXPLICIT reads the coupling
    from `system.W` and not `Jc`/`Jp` (which may be None then);
    `fused_kernels` runs each coupling direction and the block-Jacobi
    apply as one fused kernel.  `mixed_precision` (float32 or float64)
    and `bf16` (float32) solve the equilibrated system with bfloat16
    coupling rows, and unscale the solution; `bf16` runs the textbook CG
    body and floors a relative `tol` at `_BF16_TOL_FLOOR`, and
    `bf16_collectives` carries the S.p product's sums across the shards
    as bfloat16 payloads.  `Jc`, `Jp` and `system.W` are per-shard
    tuples.  `tol` may be
    a device scalar (the LM loop's forcing term).  `x0` ([cd, Nc], the
    original variables) warm-starts the reduced CG; on a precision rung
    it is brought into the equilibrated variables.  `guard` and
    `max_restarts` arm the PCG breakdown guard (`_pcg_core`); `precond`
    (JACOBI, NEUMANN, TWO_LEVEL or MULTILEVEL) and `preconditioner` (HPP
    or SCHUR_DIAG) pick the preconditioner (solver/precond.py), whose
    fallback code rides `PCGResult.precond_fallback`.  The coarse families
    need `cluster_plan` (ops/segtiles.device_cluster_plan for TWO_LEVEL,
    device_multilevel_plan for MULTILEVEL, over the camera-slot stream);
    `cam_fixed` keeps their correction off fixed cameras and
    `smooth_omega` > 0 smooths the prolongator.
    """
    Hpp_d = damp_blocks(system.Hpp, region)
    Hll_d = damp_rows_fm(system.Hll, region)
    g_cam, g_pt, W = system.g_cam, system.g_pt, system.W
    equil = mixed_precision or bf16
    if equil:
        (Hpp_d, Hll_d, g_cam, g_pt, Jc, Jp, W, d_cam,
         d_pt) = _equilibrate(system, Jc, Jp, W, plans, Hpp_d, Hll_d,
                              compute_kind)
    Hll_inv = block_inv_fm(Hll_d)
    pairs = shard_matvec_pairs(Jc, Jp, plans, compute_kind, W,
                               fused_kernels, bf16)
    hpl, hlp = summed_matvecs(pairs, plans.devices)
    if plans.tile_plan is not None:
        # The 2-D mesh: S.p alone runs the subgroup stages and the ring;
        # the reduced RHS, the back-substitution and the preconditioner
        # builds keep the world-wide products above.
        s_matvec = make_matvec_2d(Jc, Jp, W, plans, Hpp_d, Hll_inv,
                                  compute_kind, bf16, bf16_collectives,
                                  fused_kernels, pairs)
    else:
        # Compressed payloads (bf16_collectives) for the S.p product only.
        hpl_c, hlp_c = summed_matvecs(pairs, plans.devices, bf16_collectives)

        def s_matvec(p: torch.Tensor) -> torch.Tensor:
            # S p = Hpp_d p - Hpl Hll_d^-1 Hlp p
            t = block_matvec_fm(Hll_inv, hlp_c(p))
            return cam_block_matvec(Hpp_d, p) - hpl_c(t)

    precond_apply, fallback = make_schur_preconditioner(
        precond, preconditioner, Hpp_d, Hll_inv, W, Jc, Jp, plans,
        compute_kind, neumann_order=neumann_order,
        cluster_plan=cluster_plan, cam_fixed=cam_fixed, s_matvec=s_matvec,
        smooth_omega=smooth_omega, bf16=bf16, fused_kernels=fused_kernels)
    v = g_cam - hpl(block_matvec_fm(Hll_inv, g_pt))
    if x0 is not None and equil:
        x0 = x0 / d_cam
    if bf16 and tol_relative:
        # torch.clamp, not max(): a device tolerance stays on the device.
        tol = (torch.clamp(tol, min=_BF16_TOL_FLOOR)
               if isinstance(tol, torch.Tensor) else max(tol, _BF16_TOL_FLOOR))
    x, k, rho, r0_ratio, restarts, broken = _pcg_core(
        s_matvec, precond_apply, v, max_iter, tol, refuse_ratio,
        tol_relative, fused=not bf16, x0=x0, guard=guard,
        max_restarts=max_restarts)
    dx_pt = block_matvec_fm(Hll_inv, g_pt - hlp(x))
    if equil:
        x = x * d_cam  # back to the original variables
        dx_pt = dx_pt * d_pt
    return PCGResult(dx_cam=x, dx_pt=dx_pt, iterations=k, rho=rho,
                     r0_ratio=r0_ratio, breakdowns=restarts, broken=broken,
                     precond_fallback=fallback)

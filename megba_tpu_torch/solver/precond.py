"""Preconditioners of the reduced camera system.

Counterpart of the JACOBI and NEUMANN families of
`megba_tpu/solver/precond.py` on either block diagonal: the damped camera
blocks Hpp (`PreconditionerKind.HPP`) or the true Schur block diagonal
Hpp - sum_e W_e Hll^-1 W_e^T (`PreconditionerKind.SCHUR_DIAG`,
`_schur_diag_precond`).  JACOBI applies the inverted block diagonal;
NEUMANN applies the truncated series sum_{i<=k} (I - D^-1 S)^i D^-1 by
Horner recursion, k = `neumann_order` extra S products a apply.

The batched 9x9 inverse runs through `torch.linalg` as the JAX package
leaves it to XLA, with `cholesky_ex`: no host read of the factor's
status, and a block that is not positive definite (or not finite) comes
out all NaN, as `jnp.linalg.cholesky` gives it.  SCHUR_DIAG counts the
blocks whose inverse is not finite and falls back to the Hpp inverse
for exactly those; the count rides `PCGResult.precond_fallback`
(`encode_precond_fallback`) into the trace.  The per-camera sum of the
SCHUR_DIAG correction rows is kernel 4 (`segtiles.seg_reduce`), nine
launches of nine rows each over the camera plan.

With `fused_kernels` the base apply is the block-diagonal kernel
(`ops.fused.fused_block_diag_apply`) on M^-1 laid out once per solve as
feature-major rows; under `SolverOption.bf16` those rows are a bfloat16
copy and the kernel runs its bf16 arm (JAX precond.py:938-947): each
product rounded to bfloat16, the sums in float32.  Without fused kernels
the bf16 rung applies `cam_block_matvec_bf16` (JAX precond.py:948-952),
whose XLA einsum keeps the exact float32 products of the bfloat16
operands.  Every family applies its base through the same closure.

TWO_LEVEL and MULTILEVEL (JAX precond.py:304-866) add a camera-graph
coarse space: cameras aggregated into clusters by the host plan
(ops/segtiles.build_cluster_plan / build_multilevel_plan), the exact
Galerkin operator A_c = Pi^T S_d Pi of the damped Schur complement
assembled once per PCG solve (`build_two_level_coarse`; Pi the
piecewise-constant aggregation R^T, or with `smooth_omega` > 0 the
smoothed prolongator R^T - omega D^-1 S_d R^T), factored by the
spectrally filtered pseudo-inverse (solver/dense.py), and applied by the
symmetrized multiplicative cycle `_level1_cycle`; MULTILEVEL recurses
over coarser levels (`_chain_solve`).  The builds and the coarse solves
run in the solve dtype (float32 on the precision rungs, whose bfloat16
coupling rows are upcast); only the base apply narrows.  The build's
edge-scale sums are kernel 4 over host-planned segments, so two runs of
one solve are bitwise equal on the card: the incidence rows V (three
launches of nine rows), the edge-incidence contraction (nine launches of
nine rows a pair chunk) and, when smoothing, the two passes of
`_smooth_correction` (per column block, by point and then by camera).
The small dense algebra runs through `torch.einsum` / matmul.

The builds run over a mesh (`plans` a `parallel.mesh.ShardedPlans`, one
device a mesh of one shard; the coupling rows per-shard tuples, the
coarse plan split over the shards): every edge-scale sum runs per shard
over that shard's edges and is summed across the shards on the first
shard's device, the psums of JAX
precond.py:283 (SCHUR_DIAG), 387 and 409 (the smoothing passes), 483
(the incidence rows V) and 518 (the contraction); everything after them
is replicated work, done there once.

A non-finite coarse operator never raises: its level's `ok` is False,
the cycle truncates there (at level 1 it is bitwise the base apply,
through `torch.where`), and the level's bit is set in the high half of
`precond_fallback`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from megba_tpu_torch.common import ComputeKind, PrecondKind, PreconditionerKind
from megba_tpu_torch.linear_system.builder import coupling_row_provider
from megba_tpu_torch.ops import fused, segtiles
from megba_tpu_torch.ops.segtiles import (
    DeviceClusterPlan,
    DeviceMultiLevelPlan,
    DualPlans,
    SegPlan,
    ShardedClusterPlan,
)
from megba_tpu_torch.parallel.collectives import for_shards, per_shard, psum
from megba_tpu_torch.parallel.mesh import ShardedPlans
from megba_tpu_torch.solver.dense import (
    dense_filtered_factor,
    dense_filtered_solve,
)

# Relative eigenvalue floor of the filtered coarse solve (JAX
# precond.py:143): eigenvalues under it are below the float32 assembly
# noise of A_c, or gauge-like near-null modes of S under weak damping,
# whose inversion would amplify directions the Krylov iteration never
# needed; they fall through to the smoother.
_COARSE_EIG_FLOOR = 1e-5

# Bytes of one column block's camera-side rows ([cd, mc, nE] in the solve
# dtype) in `_smooth_correction`, the largest of its transients: ~2 GB
# holds 9 of venice's 387 coarse columns at float32.
_SMOOTH_BLOCK_BYTES = 2 << 30

# `precond_fallback` is one int32 (JAX precond.py:166-200): the low 16
# bits count SCHUR_DIAG blocks that fell back to the Hpp inverse, the
# high bits are a per-coarse-level bit-field (bit l-1 set when coarse
# level l degraded and the cycle truncated there).
FALLBACK_BLOCK_RADIX = 1 << 16
FALLBACK_MAX_COARSE_LEVELS = 15


def encode_precond_fallback(block_count, coarse_bits=0):
    """Pack the block count and the coarse-level bit-field into one
    int32 (a tensor when either is one)."""
    tensors = [x for x in (block_count, coarse_bits)
               if isinstance(x, torch.Tensor)]
    if tensors:
        dev = tensors[0].device
        block = torch.clamp(torch.as_tensor(block_count, device=dev).to(
            torch.int32), max=FALLBACK_BLOCK_RADIX - 1)
        bits = torch.as_tensor(coarse_bits, device=dev).to(torch.int32)
        return bits * FALLBACK_BLOCK_RADIX + block
    return (int(coarse_bits) * FALLBACK_BLOCK_RADIX
            + min(int(block_count), FALLBACK_BLOCK_RADIX - 1))


def decode_precond_fallback(code) -> dict:
    """Unpack a trace code into {'block': n, 'coarse': bits} (host ints)."""
    c = int(code)
    return {"block": c % FALLBACK_BLOCK_RADIX,
            "coarse": c // FALLBACK_BLOCK_RADIX}


def decode_precond_fallback_levels(code) -> list:
    """Per-coarse-level degrade flags [level 1, level 2, ...] of one
    trace code, trailing healthy levels trimmed."""
    bits = int(code) // FALLBACK_BLOCK_RADIX
    out = []
    level = 0
    while bits and level < FALLBACK_MAX_COARSE_LEVELS:
        out.append(bool(bits & 1))
        bits >>= 1
        level += 1
    return out


def cam_block_matvec(H: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[Nc, d, d] camera blocks times [d, Nc] rows -> contiguous [d, Nc]
    rows (the kernels take contiguous feature rows only)."""
    return torch.einsum("nij,jn->in", H, x).contiguous()


def cam_block_matvec_bf16(H_bf16: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """The unfused bf16 rung's block apply (JAX precond.py:212-226): a
    bfloat16 copy of the blocks [Nc, d, d] times x [d, Nc] rounded to
    bfloat16, every product exact in float32 (two bfloat16 values), the
    sums in float32.  Written as a broadcast product and a sum, not a
    matmul, so no TF32 setting can touch it.  Returns contiguous float32
    [d, Nc] rows."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    return (H_bf16.to(torch.float32) * xb.T[:, None, :]).sum(-1).T.contiguous()


def block_inv(H: torch.Tensor) -> torch.Tensor:
    """Batched inverse of SPD blocks [N, d, d] via Cholesky: L^-T L^-1.

    A block whose factorisation fails (not positive definite) or that
    holds a non-finite value gets an all-NaN factor, hence an all-NaN
    inverse, as `jnp.linalg.cholesky` gives it; `cholesky_ex` reads no
    status back to the host, and healthy blocks are bitwise what
    `torch.linalg.cholesky` gives.
    """
    d = H.shape[-1]
    chol, info = torch.linalg.cholesky_ex(H)
    bad = (info != 0) | ~torch.isfinite(H).all(-1).all(-1)
    chol = torch.where(bad[:, None, None],
                       torch.full_like(chol, float("nan")), chol)
    eye = torch.eye(d, dtype=H.dtype, device=H.device).expand(H.shape)
    inv_l = torch.linalg.solve_triangular(chol, eye, upper=False)
    return torch.einsum("nki,nkj->nij", inv_l, inv_l)


# Per-shard edge rows (W, Jc or Jp), or None.
ShardRows = Optional[Tuple[torch.Tensor, ...]]


def _shard_args(plans: ShardedPlans, *xs):
    """Per-shard operand lists (None -> Nones)."""
    return [per_shard(x, len(plans.shards)) for x in xs]


def _schur_diag_rows(Hll_inv, W, Jc, Jp, plans: DualPlans,
                     compute_kind: ComputeKind, cd: int, pd: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """One shard's correction rows [cd*cd, Nc]: sum_e W_e Hll^-1 W_e^T
    per camera over its edges."""
    od = 0 if Jc is None else Jc.shape[0] // cd
    rows_of = coupling_row_provider(W, Jc, Jp, od, compute_kind, dtype,
                                    plans=plans)
    n = plans.cam.n_slots
    w = rows_of(0, n).view(cd, pd, n)
    # The point of each camera slot, and its Hll^-1 rows there.
    pt_of_slot = plans.pt.seg.long().index_select(0, plans.cam.inv)
    hinv = Hll_inv.index_select(1, pt_of_slot).view(pd, pd, n)

    def fold(terms: torch.Tensor) -> torch.Tensor:
        """Sum over the second axis in index order."""
        out = terms[:, 0]
        for k in range(1, terms.shape[1]):
            out = out + terms[:, k]
        return out

    # Camera row a: t[q] = sum_p w[a, p] hinv[p, q], then corr[a, b] =
    # sum_q t[q] w[b, q], the nine rows formed and summed per camera
    # together, so only nine of the 81 edge rows exist at a time.
    rows = []
    for a in range(cd):
        t = fold((w[a][:, None, :] * hinv).transpose(0, 1))  # [pd(q), n]
        rows.append(segtiles.seg_reduce(fold(t[None] * w).contiguous(),
                                        plans.cam))
    return torch.cat(rows)


def _schur_diag_precond(
    Hpp_d: torch.Tensor,
    Hll_inv: torch.Tensor,
    W,
    Jc,
    Jp,
    plans: ShardedPlans,
    compute_kind: ComputeKind,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The true Schur block diagonal Hpp_d - sum_e W_e Hll^-1 W_e^T,
    inverted, and the number of camera blocks that fell back to the Hpp
    inverse (JAX precond.py:244-299).

    The coupling rows come in camera-slot order (`coupling_row_provider`:
    W in EXPLICIT mode, Jc^T Jp rebuilt in IMPLICIT mode, bfloat16 rows
    upcast); each edge's correction block W_e Hll^-1 W_e^T is formed per
    slot, nine of its 81 rows at a time, and summed per camera by kernel
    4, nine launches of nine rows (per shard, then summed across the
    shards).  The whole edge axis is one chunk.
    """
    cd = Hpp_d.shape[-1]
    pd = int(round(Hll_inv.shape[0] ** 0.5))
    dtype = Hpp_d.dtype
    corr_rows = psum(for_shards(
        lambda w, jc, jp, pl, d: _schur_diag_rows(
            Hll_inv.to(d), w, jc, jp, pl, compute_kind, cd, pd, dtype),
        *_shard_args(plans, W, Jc, Jp), plans.shards, plans.devices),
        Hpp_d.device)
    num_cameras = Hpp_d.shape[0]
    corr = torch.movedim(corr_rows.reshape(cd, cd, num_cameras), -1, 0)
    # Exact arithmetic keeps Hpp_d - corr SPD (a principal block of S);
    # rounding, or a crushed Hll, can push a camera block indefinite.
    # Those blocks fall back to the Hpp inverse, and are counted.
    minv_hpp = block_inv(Hpp_d)
    minv_sd = block_inv(Hpp_d - corr)
    bad = ~torch.isfinite(minv_sd).all(-1).all(-1)
    return (torch.where(bad[:, None, None], minv_hpp, minv_sd),
            bad.sum().to(torch.int32))


# ---------------------------------------------------------------------------
# Two-level coarse operator (Galerkin Pi^T S_d Pi from materialised blocks)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TwoLevelCoarse:
    """Assembled coarse space of one two-level preconditioner (JAX
    precond.py:304-336).

    `coarse_matrix` [C*cd, C*cd] is the Galerkin A_c = Pi^T S_d Pi
    (coarse dof (I, a) at I*cd + a); `eig_q` / `eig_inv` its filtered
    pseudo-inverse factor and `ok` (a 0-dim bool tensor) its health flag;
    `restrict_sel` the [C, Nc] aggregation with fixed cameras masked out;
    `G` the coupling S_d Pi as [cd, Nc, C, cd].  With `omega` > 0, `Y`
    [cd, Nc, C, cd] is the smoothing correction D^-1 S_d R^T of
    Pi = R^T - omega Y; None otherwise.
    """

    coarse_matrix: torch.Tensor
    eig_q: torch.Tensor
    eig_inv: torch.Tensor
    ok: torch.Tensor
    restrict_sel: torch.Tensor
    cluster: torch.Tensor
    G: torch.Tensor
    omega: float = 0.0
    Y: Optional[torch.Tensor] = None


def _reduce_rows(rows: torch.Tensor, plan: SegPlan) -> torch.Tensor:
    """Kernel 4 over [9k, n] plan-ordered rows, nine rows a launch."""
    return torch.cat([segtiles.seg_reduce(rows[i:i + 9], plan)
                      for i in range(0, rows.shape[0], 9)])


def _smooth_block_columns(cd: int, n: int, itemsize: int, m: int) -> int:
    """Coarse columns per block of `_smooth_correction`: the camera-side
    rows [cd, mc, n] near `_SMOOTH_BLOCK_BYTES`, a multiple of 3 (the
    point-side rows [pd, mc, n] then go nine to a launch), at most m."""
    mc = _SMOOTH_BLOCK_BYTES // max(cd * n * itemsize, 1)
    return min(m, max(3, mc // 3 * 3))


def _smooth_u_rows(w: torch.Tensor, plans: DualPlans, Yb: torch.Tensor,
                   pd: int) -> torch.Tensor:
    """One shard's first smoothing pass over a column block: the rows
    W_e^T Y[cam(e)] summed per point, [pd * k, Np]."""
    cd = Yb.shape[0]
    k, n = Yb.shape[2], w.shape[1]
    cam_of_slot = plans.cam.seg.long()
    # U rows [pd, k, n]: W_e^T Y[cam(e)] per column, summed over a in
    # ascending order, each row contiguous.
    u_rows = torch.empty((pd, k, n), dtype=w.dtype, device=w.device)
    for a in range(cd):
        g = Yb[a].T.contiguous().index_select(1, cam_of_slot)
        for q in range(pd):
            if a == 0:
                torch.mul(w[a * pd + q], g, out=u_rows[q])
            else:
                u_rows[q] += w[a * pd + q] * g
    u_rows = u_rows.reshape(pd * k, n)
    return torch.cat([segtiles.seg_reduce(plans.to_pt(u_rows[i:i + 9]),
                                          plans.pt)
                      for i in range(0, pd * k, 9)])


def _smooth_z_rows(w: torch.Tensor, plans: DualPlans, T: torch.Tensor,
                   cd: int) -> torch.Tensor:
    """One shard's second smoothing pass: the rows W_e T[pt(e)] summed
    per camera, [cd * k, Nc]."""
    pd, k = T.shape[0], T.shape[1]
    n = w.shape[1]
    pt_of_slot = plans.pt.seg.long().index_select(0, plans.cam.inv)
    z_rows = torch.empty((cd, k, n), dtype=w.dtype, device=w.device)
    for q in range(pd):
        g = T[q].index_select(1, pt_of_slot)
        for a in range(cd):
            if q == 0:
                torch.mul(w[a * pd + q], g, out=z_rows[a])
            else:
                z_rows[a] += w[a * pd + q] * g
    return _reduce_rows(z_rows.reshape(cd * k, n), plans.cam)


def _smooth_correction(Hpp_d: torch.Tensor, Hll_inv: torch.Tensor,
                       w: Tuple[torch.Tensor, ...], plans: ShardedPlans,
                       Y: torch.Tensor) -> torch.Tensor:
    """Z = S_d Y for the smoothing correction's columns (JAX
    precond.py:337-411).

    Hpp_d Y is blockwise; the coupling half Hpl Hll^-1 Hlp Y runs two
    edge-scale passes per block of coarse columns: the rows W_e^T Y[cam(e)]
    summed per point (over `plans.pt`, after `to_pt`), Hll^-1 per point,
    then the rows W_e (Hll^-1 Hlp Y)[pt(e)] summed per camera (over
    `plans.cam`), each sum by kernel 4, nine rows a launch: 12 C launches
    a build whatever the block (per shard, each pass summed across the
    shards).  `w` are each shard's coupling rows [cd*pd, n_k] in
    camera-slot order.
    """
    cd = Hpp_d.shape[-1]
    pd = int(round(Hll_inv.shape[0] ** 0.5))
    num_cameras = Hpp_d.shape[0]
    Np = Hll_inv.shape[1]
    C = Y.shape[2]
    m = C * cd
    Ym = Y.reshape(cd, num_cameras, m)
    hinv = Hll_inv.reshape(pd, pd, Np)
    # The block size follows the largest shard's edge count.
    n = max(x.shape[1] for x in w)
    mc = _smooth_block_columns(cd, n, w[0].element_size(), m)
    z_cols = []
    for m0 in range(0, m, mc):
        k = min(m0 + mc, m) - m0
        Yb = Ym[:, :, m0:m0 + k]
        U = psum(for_shards(
            lambda ws, pl, d: _smooth_u_rows(ws, pl, Yb.to(d), pd),
            w, plans.shards, plans.devices), Hpp_d.device).reshape(pd, k, Np)
        # Hll^-1 (Hlp Y) per point.
        T = torch.stack([sum(hinv[q, s] * U[s] for s in range(pd))
                         for q in range(pd)])  # [pd, k, Np]
        z = psum(for_shards(
            lambda ws, pl, d: _smooth_z_rows(ws, pl, T.to(d), cd),
            w, plans.shards, plans.devices), Hpp_d.device)
        z_cols.append(z.reshape(cd, k, num_cameras))
    Zcoup = torch.cat(z_cols, dim=1).permute(0, 2, 1).reshape(
        cd, num_cameras, C, cd)
    Z1 = torch.einsum("nac,cnJb->anJb", Hpp_d, Y)
    return Z1 - Zcoup


def build_two_level_coarse(
    Hpp_d: torch.Tensor,
    Hll_inv: torch.Tensor,
    W: ShardRows,
    Jc: ShardRows,
    Jp: ShardRows,
    cluster_plan: Union[DeviceClusterPlan, ShardedClusterPlan],
    compute_kind: ComputeKind,
    plans: ShardedPlans,
    cam_fixed: Optional[torch.Tensor] = None,
    smooth_omega: float = 0.0,
    Minv: Optional[torch.Tensor] = None,
    factor: bool = True,
) -> TwoLevelCoarse:
    """Assemble and factor G = S_d Pi and A_c = Pi^T S_d Pi (JAX
    precond.py:415-578).

    Pi is the aggregation R^T, or with `smooth_omega` > 0 the smoothed
    Pi = R^T - omega Y, Y = D^-1 G_0 (`Minv` is D^-1, by default the
    inverted Hpp_d), G_0 = S_d R^T: then G = G_0 - omega S_d Y and
    A_c = R G - omega Y^T G.  The coupling rows come in camera-slot order
    (`coupling_row_provider`, in Hpp_d's dtype, materialised once: the
    pairs gather their columns from it);
    the edge sums run through kernel 4 over the plan's segments (the
    module note).  Fixed cameras (`cam_fixed`) leave R, so the coarse
    correction never moves them.  `factor=False` skips the
    eigendecomposition (MULTILEVEL factors only its coarsest level), and
    `ok` then reports a finite A_c.
    """
    cd = Hpp_d.shape[-1]
    pd = int(round(Hll_inv.shape[0] ** 0.5))
    dtype = Hpp_d.dtype
    num_cameras = Hpp_d.shape[0]
    C = cluster_plan.num_clusters
    od = 0 if Jc is None else Jc[plans.mesh.home].shape[0] // cd

    def rows_of(w_, jc, jp, pl):
        return coupling_row_provider(w_, jc, jp, od, compute_kind, dtype,
                                     plans=pl)(0, pl.cam.n_slots)

    w = tuple(for_shards(rows_of, *_shard_args(plans, W, Jc, Jp),
                         plans.shards))
    # V rows [cd*pd, n_pc]: each shard's coupling rows summed per (point,
    # cluster) incidence, its real edges gathered to incidence order,
    # summed across the shards.
    V = psum(for_shards(
        lambda ws, cp: _reduce_rows(ws.index_select(1, cp.pc.inv), cp.pc),
        w, cluster_plan.shards), Hpp_d.device)
    # T = V Hll^-1 per incidence (Hll^-1 symmetric: T's columns are the
    # Hll^-1 V^T blocks of the contraction).
    hinv = Hll_inv.index_select(1, cluster_plan.pc_pt)
    T = torch.stack([
        sum(V[a * pd + p] * hinv[p * pd + q] for p in range(pd))
        for a in range(cd) for q in range(pd)])  # [cd*pd, n_pc]
    del V, hinv

    def contraction(ws, cp, T_):
        """The edge-incidence contraction of one edge set:
        corrG[(a, b), (n, J)] sums W_e[a, q] T_s[b, q] over the pairs of
        segment n*C + J, nine of the 81 rows formed and summed at a
        time, pair chunk by pair chunk."""
        blocks = []
        for p0, p1, _, plan in cp.ec_chunks:
            we = ws.index_select(1, plan.inv)
            te = T_.index_select(1, cp.ec_slot[p0:p1])
            blocks.append(torch.cat([
                segtiles.seg_reduce(torch.stack([
                    sum(we[a * pd + q] * te[b * pd + q] for q in range(pd))
                    for b in range(cd)]), plan)
                for a in range(cd)]))
            del we, te
        return torch.cat(blocks, dim=1)

    corrg = psum(for_shards(
        lambda ws, cp, d: contraction(ws, cp, T.to(d)), w,
        cluster_plan.shards, plans.devices), Hpp_d.device)
    corrg = corrg.reshape(cd, cd, num_cameras, C)
    corrg = corrg.permute(0, 2, 3, 1)  # [a, n, J, b]
    del T

    # Fine half Hpp_d R^T: camera n's block in coarse column cluster(n).
    sel = (cluster_plan.cluster[None, :] == torch.arange(
        C, device=Hpp_d.device)[:, None]).to(dtype)
    if cam_fixed is not None:
        sel = sel * (1.0 - cam_fixed.to(dtype))[None, :]
    G = torch.einsum("nab,Jn->anJb", Hpp_d, sel) - corrg  # S_d R^T

    Y = None
    if smooth_omega:
        if Minv is None:
            Minv = block_inv(Hpp_d)
        Y = torch.einsum("nac,cnJb->anJb", Minv, G)
        G = G - smooth_omega * _smooth_correction(Hpp_d, Hll_inv, w, plans,
                                                  Y)
        A = (torch.einsum("In,anJb->IaJb", sel, G)
             - smooth_omega * torch.einsum("anIc,anJb->IcJb", Y, G)
             ).reshape(C * cd, C * cd)
    else:
        A = torch.einsum("In,anJb->IaJb", sel, G).reshape(C * cd, C * cd)
    A = 0.5 * (A + A.T)  # symmetrise away the summation-order rounding
    G = G.contiguous()
    if not factor:
        return TwoLevelCoarse(
            coarse_matrix=A, eig_q=torch.zeros_like(A),
            eig_inv=torch.zeros(A.shape[0], dtype=dtype, device=A.device),
            ok=torch.isfinite(A).all(), restrict_sel=sel,
            cluster=cluster_plan.cluster, G=G, omega=smooth_omega, Y=Y)
    # The filtered pseudo-inverse, not a Cholesky: all-fixed or edge-less
    # clusters and near-null modes fall under the floor and get no coarse
    # correction instead of a NaN factor.
    (Q, inv), ok = dense_filtered_factor(A, _COARSE_EIG_FLOOR)
    return TwoLevelCoarse(coarse_matrix=A, eig_q=Q, eig_inv=inv, ok=ok,
                          restrict_sel=sel, cluster=cluster_plan.cluster,
                          G=G, omega=smooth_omega, Y=Y)


def _restrict(coarse: TwoLevelCoarse, r: torch.Tensor) -> torch.Tensor:
    """Pi^T r: [cd, Nc] fine rows -> [C, cd] coarse residual."""
    rc = torch.einsum("In,an->Ia", coarse.restrict_sel, r)
    if coarse.Y is not None:
        rc = rc - coarse.omega * torch.einsum("anJb,an->Jb", coarse.Y, r)
    return rc


def _inject(coarse: TwoLevelCoarse, y: torch.Tensor) -> torch.Tensor:
    """Pi y: [C, cd] coarse value -> [cd, Nc] fine rows (each camera's
    cluster value, fixed cameras masked, minus omega Y y when smoothed)."""
    z = y.index_select(0, coarse.cluster).T
    z = z * coarse.restrict_sel.amax(0)[None, :]
    if coarse.Y is not None:
        z = z - coarse.omega * torch.einsum("anJb,Jb->an", coarse.Y, y)
    return z


def _level1_cycle(
    coarse: TwoLevelCoarse,
    coarse_solve: Callable[[torch.Tensor], torch.Tensor],
    ok: torch.Tensor,
    base_apply: Callable[[torch.Tensor], torch.Tensor],
    r: torch.Tensor,
) -> torch.Tensor:
    """One symmetrized multiplicative cycle at the fine level (JAX
    precond.py:466-498):

        M^-1 r = Pi B Pi^T r + P^T D^-1 P r,   P = I - G B Pi^T

    with B = `coarse_solve`, symmetric.  Both selects are `torch.where`,
    so with `ok` False the cycle is exactly `base_apply(r)`.  Returns
    contiguous [cd, Nc] rows.
    """
    rc = _restrict(coarse, r)
    y = coarse_solve(rc)
    z_c = _inject(coarse, y)
    gy = torch.einsum("anJb,Jb->an", coarse.G, y)
    w = base_apply(torch.where(ok, r - gy, r).contiguous())
    v = torch.einsum("anJb,an->Jb", coarse.G, w)
    z2 = _inject(coarse, coarse_solve(v))
    return torch.where(ok, z_c + w - z2, w).contiguous()


def two_level_cycle(
    coarse: TwoLevelCoarse,
    base_apply: Callable[[torch.Tensor], torch.Tensor],
    r: torch.Tensor,
) -> torch.Tensor:
    """The `_level1_cycle` with B = the filtered A_c^+."""
    C = coarse.restrict_sel.shape[0]
    cd = r.shape[0]

    def solve(rc: torch.Tensor) -> torch.Tensor:
        return dense_filtered_solve((coarse.eig_q, coarse.eig_inv),
                                    rc.reshape(C * cd)).reshape(C, cd)

    return _level1_cycle(coarse, solve, coarse.ok, base_apply, r)


# ---------------------------------------------------------------------------
# Recursive camera-graph hierarchy (MULTILEVEL)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CoarseLevel:
    """One coarse level of the multilevel hierarchy (JAX
    precond.py:664-686): a mid-hierarchy level carries its operator `A`,
    its block-Jacobi smoother (`D_inv` [C_l, cd, cd], weight `omega_s`),
    the aggregation `assign` [C_l] onto the next level and, for the
    restriction, its one-hot form `restrict_sel` [C_next, C_l] (a matmul
    where the JAX package scatter-adds: deterministic on the card); the
    coarsest carries the filtered factor (`eig_q`, `eig_inv`) instead.
    `ok` is the level's health flag."""

    A: torch.Tensor
    ok: torch.Tensor
    D_inv: Optional[torch.Tensor] = None
    omega_s: Optional[torch.Tensor] = None
    assign: Optional[torch.Tensor] = None
    num_next: int = 0
    eig_q: Optional[torch.Tensor] = None
    eig_inv: Optional[torch.Tensor] = None
    restrict_sel: Optional[torch.Tensor] = None


@dataclasses.dataclass
class MultiLevelCoarse:
    """The level-1 assembly and the dense coarse chain; `level_ok[l-1]`
    gates coarse level l (its own health and its ancestors')."""

    level1: TwoLevelCoarse
    chain: Tuple[CoarseLevel, ...]
    level_ok: Tuple[torch.Tensor, ...]


def _block_diag_inv(A: torch.Tensor, C: int, cd: int) -> torch.Tensor:
    """[C, cd, cd] inverse of the cd-block diagonal of a level operator;
    a block that does not invert (an all-fixed or edge-less aggregate)
    becomes the identity."""
    idx = torch.arange(C, device=A.device)
    inv = block_inv(A.reshape(C, cd, C, cd)[idx, :, idx, :])
    eye = torch.eye(cd, dtype=A.dtype, device=A.device).expand(inv.shape)
    bad = ~torch.isfinite(inv).all(-1).all(-1)
    return torch.where(bad[:, None, None], eye, inv)


def _smoother_weight(A4: torch.Tensor, D_inv: torch.Tensor) -> torch.Tensor:
    """omega_s = 1 / lambda_max(D^-1 A) by a fixed 12-step power
    iteration (JAX precond.py:714-730), 1 where that is not finite."""
    C, cd = D_inv.shape[0], D_inv.shape[1]
    v = torch.ones((C, cd), dtype=A4.dtype, device=A4.device)
    nrm = torch.ones((), dtype=A4.dtype, device=A4.device)
    for _ in range(12):
        w = torch.einsum("iab,ib->ia", D_inv,
                         torch.einsum("iajb,jb->ia", A4, v))
        nrm = torch.sqrt((w * w).sum())
        v = w / torch.clamp(nrm, min=1e-30)
    om = 1.0 / torch.clamp(nrm, min=1.0)
    return torch.where(torch.isfinite(om), om, torch.ones_like(om))


def build_multilevel_coarse(
    Hpp_d: torch.Tensor,
    Hll_inv: torch.Tensor,
    W: ShardRows,
    Jc: ShardRows,
    Jp: ShardRows,
    multilevel_plan: DeviceMultiLevelPlan,
    compute_kind: ComputeKind,
    plans: ShardedPlans,
    cam_fixed: Optional[torch.Tensor] = None,
    smooth_omega: float = 0.0,
    Minv: Optional[torch.Tensor] = None,
) -> MultiLevelCoarse:
    """Assemble the hierarchy (JAX precond.py:733-810): level 1 is
    `build_two_level_coarse` (unfactored when deeper levels exist), each
    further level the dense Galerkin A_{l+1} = R_l A_l R_l^T over the
    planned assignment; only the coarsest level is factored."""
    depth_assign = len(multilevel_plan.assign)
    level1 = build_two_level_coarse(
        Hpp_d, Hll_inv, W, Jc, Jp, multilevel_plan.base, compute_kind,
        plans, cam_fixed=cam_fixed, smooth_omega=smooth_omega, Minv=Minv,
        factor=depth_assign == 0)
    cd = Hpp_d.shape[-1]
    dtype = Hpp_d.dtype
    A = level1.coarse_matrix
    if depth_assign == 0:
        chain = [CoarseLevel(A=A, ok=level1.ok, eig_q=level1.eig_q,
                             eig_inv=level1.eig_inv)]
    else:
        chain = []
        sizes = multilevel_plan.level_sizes
        for i, assign in enumerate(multilevel_plan.assign):
            Cl, Cn = int(sizes[i]), int(sizes[i + 1])
            sel = (assign[None, :] == torch.arange(
                Cn, device=A.device)[:, None]).to(dtype)
            A4 = A.reshape(Cl, cd, Cl, cd)
            D_inv = _block_diag_inv(A, Cl, cd)
            chain.append(CoarseLevel(
                A=A, ok=torch.isfinite(A).all(), D_inv=D_inv,
                omega_s=_smoother_weight(A4, D_inv), assign=assign,
                num_next=Cn, restrict_sel=sel))
            G4 = torch.einsum("iakb,Jk->iaJb", A4, sel)  # A R_l^T
            A_next = torch.einsum("Ii,iaJb->IaJb", sel, G4).reshape(
                Cn * cd, Cn * cd)
            A = 0.5 * (A_next + A_next.T)
        (Q, inv), okc = dense_filtered_factor(A, _COARSE_EIG_FLOOR)
        chain.append(CoarseLevel(A=A, ok=okc, eig_q=Q, eig_inv=inv))
    gated = []
    alive = torch.ones((), dtype=torch.bool, device=A.device)
    for lvl in chain:
        alive = alive & lvl.ok
        gated.append(alive)
    return MultiLevelCoarse(level1=level1, chain=tuple(chain),
                            level_ok=tuple(gated))


def _chain_solve(chain: Tuple[CoarseLevel, ...], level_ok, i: int,
                 rc: torch.Tensor) -> torch.Tensor:
    """Approximate A_{i+1}^-1 rc ([C, cd]) by a recursive symmetric
    V(1,1) cycle over the dense chain (JAX precond.py:813-848):
    damped block-Jacobi pre-smooth, the coarser correction on the true
    residual, post-smooth; the coarsest level solves exactly."""
    lvl = chain[i]
    C, cd = rc.shape
    if lvl.assign is None:
        return dense_filtered_solve((lvl.eig_q, lvl.eig_inv),
                                    rc.reshape(C * cd)).reshape(C, cd)
    ok_next = level_ok[i + 1]
    A4 = lvl.A.reshape(C, cd, C, cd)

    def smooth(x):
        return lvl.omega_s * torch.einsum("iab,ib->ia", lvl.D_inv, x)

    def amat(x):
        return torch.einsum("iajb,jb->ia", A4, x)

    z1 = smooth(rc)
    r1 = rc - amat(z1)
    rn = lvl.restrict_sel @ r1  # R_l r1
    zc = _chain_solve(chain, level_ok, i + 1, rn).index_select(
        0, lvl.assign)  # R_l^T B (R_l r1)
    z2 = z1 + torch.where(ok_next, zc, torch.zeros_like(zc))
    r2 = rc - amat(z2)
    return z2 + smooth(r2)


def multilevel_cycle(
    mlc: MultiLevelCoarse,
    base_apply: Callable[[torch.Tensor], torch.Tensor],
    r: torch.Tensor,
) -> torch.Tensor:
    """The `_level1_cycle` with B = the level-2 recursive cycle (or the
    exact coarse solve when the hierarchy is two levels deep)."""
    cd = r.shape[0]

    def solve(rc: torch.Tensor) -> torch.Tensor:
        return _chain_solve(mlc.chain, mlc.level_ok, 0, rc.reshape(-1, cd))

    return _level1_cycle(mlc.level1, solve, mlc.level_ok[0], base_apply, r)


def make_schur_preconditioner(
    kind: PrecondKind,
    block_kind: PreconditionerKind,
    Hpp_d: torch.Tensor,
    Hll_inv: Optional[torch.Tensor] = None,
    W: ShardRows = None,
    Jc: ShardRows = None,
    Jp: ShardRows = None,
    plans: Optional[ShardedPlans] = None,
    compute_kind: ComputeKind = ComputeKind.IMPLICIT,
    neumann_order: int = 2,
    cluster_plan: Union[None, DeviceClusterPlan, DeviceMultiLevelPlan] = None,
    cam_fixed: Optional[torch.Tensor] = None,
    s_matvec: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    smooth_omega: float = 0.0,
    bf16: bool = False,
    fused_kernels: bool = False,
) -> Tuple[Callable[[torch.Tensor], torch.Tensor], Union[int, torch.Tensor]]:
    """The reduced-system preconditioner of one PCG solve.

    Returns `(apply, fallback_code)`: `apply(r [cd, Nc]) -> [cd, Nc]`,
    and the enum-coded fallback count (`encode_precond_fallback`; a
    device tensor under SCHUR_DIAG and the coarse families, 0
    otherwise).  `kind` picks the operator family: JACOBI, NEUMANN (needs
    `s_matvec`, the CG's own S product), TWO_LEVEL (`cluster_plan` a
    DeviceClusterPlan) or MULTILEVEL (a DeviceMultiLevelPlan), the coarse
    families with `cam_fixed` kept off the coarse correction and
    `smooth_omega` > 0 for smoothed aggregation.  `block_kind` picks the
    base block diagonal every family smooths with: HPP, or SCHUR_DIAG,
    which needs `Hll_inv`, `plans` and the coupling rows of
    `compute_kind` (as do the coarse families).  `bf16` applies a
    bfloat16 copy of the inverted diagonal: through the kernel's bf16 arm
    with `fused_kernels`, through `cam_block_matvec_bf16` without; the
    coarse builds and solves stay in Hpp_d's dtype.
    """
    if block_kind == PreconditionerKind.SCHUR_DIAG:
        if Hll_inv is None or plans is None:
            raise ValueError("the SCHUR_DIAG preconditioner needs Hll^-1 "
                             "and the dual plans")
        Minv, n_bad = _schur_diag_precond(Hpp_d, Hll_inv, W, Jc, Jp, plans,
                                          compute_kind)
    else:
        Minv = block_inv(Hpp_d)
        n_bad = 0

    if fused_kernels:
        Hrows = fused.block_diag_rows(Minv.to(torch.bfloat16) if bf16
                                      else Minv)

        def base_apply(r: torch.Tensor) -> torch.Tensor:
            return fused.fused_block_diag_apply(Hrows, r, bf16_operands=bf16)
    elif bf16:
        Minv_bf16 = Minv.to(torch.bfloat16)

        def base_apply(r: torch.Tensor) -> torch.Tensor:
            return cam_block_matvec_bf16(Minv_bf16, r)
    else:
        def base_apply(r: torch.Tensor) -> torch.Tensor:
            return cam_block_matvec(Minv, r)

    if kind == PrecondKind.JACOBI:
        return base_apply, encode_precond_fallback(n_bad)
    if kind == PrecondKind.NEUMANN:
        if s_matvec is None:
            raise ValueError("NEUMANN preconditioner needs the S matvec")
        order = int(neumann_order)

        def neumann_apply(r: torch.Tensor) -> torch.Tensor:
            # Horner form of sum_{i<=k} E^i D^-1 r, E = I - D^-1 S: each
            # step one S product and one base apply.
            z = base_apply(r)
            for _ in range(order):
                z = z + base_apply(r - s_matvec(z))
            return z

        return neumann_apply, encode_precond_fallback(n_bad)
    if kind not in (PrecondKind.TWO_LEVEL, PrecondKind.MULTILEVEL):
        raise ValueError(f"unknown precond kind {kind}")
    if cluster_plan is None:
        raise ValueError(
            f"precond={kind.name} needs a camera-cluster plan operand; "
            "flat_solve builds one (ops/segtiles.build_cluster_plan / "
            "build_multilevel_plan) - direct schur_pcg_solve callers must "
            "pass cluster_plan=")
    if Hll_inv is None or plans is None:
        raise ValueError(f"precond={kind.name} needs Hll^-1 and the dual "
                         "plans")
    zero, one = (torch.zeros((), dtype=torch.int32, device=Hpp_d.device),
                 torch.ones((), dtype=torch.int32, device=Hpp_d.device))
    if kind == PrecondKind.TWO_LEVEL:
        coarse = build_two_level_coarse(
            Hpp_d, Hll_inv, W, Jc, Jp, cluster_plan, compute_kind, plans,
            cam_fixed=cam_fixed, smooth_omega=smooth_omega, Minv=Minv)

        def two_level_apply(r: torch.Tensor) -> torch.Tensor:
            return two_level_cycle(coarse, base_apply, r)

        return two_level_apply, encode_precond_fallback(
            n_bad, torch.where(coarse.ok, zero, one))

    mlc = build_multilevel_coarse(
        Hpp_d, Hll_inv, W, Jc, Jp, cluster_plan, compute_kind, plans,
        cam_fixed=cam_fixed, smooth_omega=smooth_omega, Minv=Minv)

    def multilevel_apply(r: torch.Tensor) -> torch.Tensor:
        return multilevel_cycle(mlc, base_apply, r)

    # Bit l-1 set when coarse level l (or an ancestor) degraded.
    bits = zero
    for i, ok_l in enumerate(mlc.level_ok):
        bits = bits + torch.where(ok_l, zero, one << i)
    return multilevel_apply, encode_precond_fallback(n_bad, bits)

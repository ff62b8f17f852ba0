"""The port's TWO_LEVEL and MULTILEVEL coarse spaces (solver/precond.py)
vs the JAX package's, float64.

- `build_two_level_coarse`: `coarse_matrix`, `G` (and `Y` when smoothed)
  at 1e-12 of their largest magnitude, on IMPLICIT, EXPLICIT and
  bfloat16 coupling rows, with and without fixed cameras, with
  `smooth_omega` 0 and 2/3; bitwise the same whatever the pair chunk and
  the smoothing column block;
- the `two_level_cycle` and `multilevel_cycle` applies against JAX's;
- `build_multilevel_coarse` at depth 2 and 4 (each level's `A`, `D_inv`,
  `omega_s` and `level_ok`);
- the ports of tests/test_precond.py:119 (the exact Galerkin against the
  dense projection), :164 (SPD), :295 (a poisoned coarse level is bitwise
  the base apply) and :327, and of tests/test_multilevel.py:213, 256, 294,
  329 (depth-2 MULTILEVEL is bitwise TWO_LEVEL), 353, 387 and 494.

The scenes are camera-sorted, so both packages plan the same stream.
CPU only.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import megba_tpu.common as jc
from megba_tpu.linear_system import builder as jb
from megba_tpu.ops import segtiles as jseg
from megba_tpu.ops.residuals import bal_residual_jacobian_analytical_fm as jeng
from megba_tpu.solver import precond as jprecond

import megba_tpu_torch as mt
from megba_tpu_torch.core.fm import block_inv_fm, damp_rows_fm
from megba_tpu_torch.linear_system.builder import damp_blocks
from megba_tpu_torch.ops import segtiles as tseg
from megba_tpu_torch.parallel.mesh import one_shard
from megba_tpu_torch.solver import pcg as tpcg
from megba_tpu_torch.solver import precond as tprecond

from test_torch_plain_pcg import _carry

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

CD, PD = 9, 3
TWO, MULTI = mt.PrecondKind.TWO_LEVEL, mt.PrecondKind.MULTILEVEL
HPP = mt.PreconditionerKind.HPP


def _problem(kind="IMPLICIT", num_cameras=16, num_points=120, seed=2,
             locality="ring", fixed=False, region=50.0, rows=None):
    """One scene's damped system in both packages: JAX's operands (caller
    order, unplanned) and the port's (camera slots, on the mesh of one
    shard: `plans`; `dual` its one device's plans), the same numbers."""
    s = mt.make_synthetic_bal(num_cameras=num_cameras, num_points=num_points,
                              obs_per_point=4, seed=seed, locality=locality)
    assert (np.diff(s.cam_idx) >= 0).all()  # both packages plan one stream
    nc, npt = num_cameras, num_points
    cf = None
    if fixed:
        cf = np.zeros(nc, bool)
        cf[[0, 5]] = True
    ci, pi = jnp.asarray(s.cam_idx), jnp.asarray(s.pt_idx)
    jcf = None if cf is None else jnp.asarray(cf)
    r, Jc, Jp = jeng(jnp.take(jnp.asarray(s.cameras0.T), ci, axis=1),
                     jnp.take(jnp.asarray(s.points0.T), pi, axis=1),
                     jnp.asarray(s.obs.T))
    r, Jc, Jp = jb.weight_system_inputs(r, Jc, Jp, ci, pi,
                                        jnp.ones(s.obs.shape[0]), None, jcf)
    ck = jc.ComputeKind[kind]
    jsys = jb.build_schur_system(r, Jc, Jp, ci, pi, nc, npt, compute_kind=ck,
                                 cam_fixed=jcf)
    tsys, tJc, tJp, plans = _carry(jsys, Jc, Jp, ci, pi)
    t_region = torch.tensor(region, dtype=torch.float64)
    Hpp_d = damp_blocks(tsys.Hpp, t_region)
    Hll_inv = block_inv_fm(damp_rows_fm(tsys.Hll, t_region))
    W, jW = tsys.W, jsys.W
    if rows == "bf16":  # a rung's rows: both packages upcast them
        bf = torch.bfloat16
        W = None if W is None else (W[0].to(bf),)
        tJc, tJp = tJc.to(bf), tJp.to(bf)
        jW = None if jW is None else jnp.asarray(jW).astype(jnp.bfloat16)
        Jc, Jp = Jc.astype(jnp.bfloat16), Jp.astype(jnp.bfloat16)
    return dict(
        s=s, nc=nc, npt=npt, kind=kind, plans=one_shard(plans), dual=plans,
        systems=((jsys, Jc, Jp), (tsys, tJc, tJp)),
        port=(Hpp_d, Hll_inv, W, (tJc,), (tJp,)),
        jax=(jnp.asarray(Hpp_d.numpy()), jnp.asarray(Hll_inv.numpy()), jW,
             Jc, Jp),
        ci=ci, pi=pi, cam_fixed=None if cf is None else torch.from_numpy(cf),
        jcam_fixed=jcf)


def _plans(p, multilevel=False, **knobs):
    """(port device plan, JAX device plan) over the shared stream."""
    s = p["s"]
    args = (s.cam_idx, s.pt_idx, p["nc"], p["npt"])
    if multilevel:
        tp = tseg.build_multilevel_plan(*args, **knobs)
        jp = jseg.build_multilevel_plan(*args, **knobs)
        np.testing.assert_array_equal(tp.base.cluster, jp.base.cluster)
        return (tseg.device_multilevel_plan(tp, torch.device("cpu")),
                jseg.device_multilevel_plan(jp), tp)
    tp = tseg.build_cluster_plan(*args, **knobs)
    jp = jseg.build_cluster_plan(*args, **knobs)
    np.testing.assert_array_equal(tp.cluster, jp.cluster)
    return (tseg.device_cluster_plan(tp, torch.device("cpu")),
            jseg.device_cluster_plan(jp), tp)


def _close(got, want, rel=1e-12, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max(), err_msg=what)


def _builds(p, dplan, jplan, omega):
    got = tprecond.build_two_level_coarse(
        *p["port"], dplan, mt.ComputeKind[p["kind"]], p["plans"],
        cam_fixed=p["cam_fixed"], smooth_omega=omega)
    want = jprecond.build_two_level_coarse(
        *p["jax"], jplan, jc.ComputeKind[p["kind"]],
        cam_fixed=p["jcam_fixed"], smooth_omega=omega, cam_idx=p["ci"],
        pt_idx=p["pi"])
    return got, want


_BUILD_CASES = [("IMPLICIT", None, 0.0, False),
                ("EXPLICIT", None, 0.0, True),
                ("IMPLICIT", "bf16", 0.0, False),
                ("IMPLICIT", None, 2 / 3, True),
                ("EXPLICIT", None, 2 / 3, False),
                ("EXPLICIT", "bf16", 2 / 3, True)]


@pytest.mark.parametrize("kind,rows,omega,fixed", _BUILD_CASES)
def test_two_level_coarse_matches_jax(kind, rows, omega, fixed):
    p = _problem(kind, fixed=fixed, rows=rows)
    dplan, jplan, _ = _plans(p)
    got, want = _builds(p, dplan, jplan, omega)
    assert bool(got.ok) and bool(want.ok)
    _close(got.coarse_matrix, want.coarse_matrix, what="coarse_matrix")
    _close(got.G, want.G, what="G")
    _close(got.restrict_sel, want.restrict_sel, what="restrict_sel")
    if omega:
        _close(got.Y, want.Y, what="Y")
    else:
        assert got.Y is None and want.Y is None
    # The cycle against JAX's, on the same base apply.
    Hpp_d = p["port"][0]
    binv = tprecond.block_inv(Hpp_d)
    jbinv = jnp.asarray(binv.numpy())
    r = np.random.default_rng(0).standard_normal((CD, p["nc"]))
    out = tprecond.two_level_cycle(
        got, lambda x: tprecond.cam_block_matvec(binv, x),
        torch.from_numpy(r))
    jout = jprecond.two_level_cycle(
        want, lambda x: jprecond.cam_block_matvec(jbinv, x), jnp.asarray(r))
    assert out.is_contiguous()
    _close(out, jout, what="two_level_cycle")


_BF16_PCG = dict(max_iter=50, tol=1e-6, refuse_ratio=1e30,
                 tol_relative=True, bf16=True)
_BF16_REGIONS = (0.5, 2.0)


@functools.lru_cache(maxsize=None)
def _bf16_pcg_case(kind):
    """The f32 system of `kind`, its plans and JAX's bf16 TWO_LEVEL PCG
    at each damping of `_BF16_REGIONS` (shared by the unfused and fused
    runs)."""
    import jax

    from megba_tpu.solver import pcg as jpcg

    p = _problem(kind)
    dplan, jplan, _ = _plans(p)
    (jsys, jJc, jJp), _ = p["systems"]
    f32 = np.float32
    jsys = jax.tree_util.tree_map(lambda a: jnp.asarray(a, f32), jsys)
    jJc, jJp = jnp.asarray(jJc, f32), jnp.asarray(jJp, f32)
    refs = [jpcg.schur_pcg_solve(
        jsys, jJc, jJp, p["ci"], p["pi"], jnp.asarray(region, f32),
        compute_kind=jc.ComputeKind[kind],
        precond=jc.PrecondKind.TWO_LEVEL, cluster_plan=jplan, **_BF16_PCG)
        for region in _BF16_REGIONS]
    return p, dplan, jsys, refs


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_bf16_two_level_schur_pcg_matches_jax(kind, fused):
    """The bf16 rung's PCG with TWO_LEVEL on the same float32 system in
    both packages, at strong damping, where the solves stop on their
    relative tolerance within a few iterations (at weak damping the bf16
    iterates drift apart with the block apply's other rounding, JACOBI
    as TWO_LEVEL: tests/test_torch_precision.py): dx within 1e-2."""
    from megba_tpu_torch.convert import schur_system_to_torch
    from megba_tpu_torch.ops import fused as tfused

    p, dplan, jsys, refs = _bf16_pcg_case(kind)
    _, (_, tJc, tJp) = p["systems"]
    tsys = schur_system_to_torch(jsys, device="cpu", dtype=torch.float32)
    plans = one_shard(tfused.with_fused_plans(p["dual"]))
    for region, ref in zip(_BF16_REGIONS, refs):
        got = tpcg.schur_pcg_solve(
            tsys, (tJc.float(),), (tJp.float(),), plans,
            torch.tensor(region, dtype=torch.float32),
            compute_kind=mt.ComputeKind[kind], fused_kernels=fused,
            precond=TWO, cluster_plan=dplan, **_BF16_PCG)
        assert int(got.precond_fallback) == int(ref.precond_fallback) == 0
        want = np.concatenate([np.asarray(ref.dx_cam).ravel(),
                               np.asarray(ref.dx_pt).ravel()])
        have = np.concatenate([got.dx_cam.numpy().ravel(),
                               got.dx_pt.numpy().ravel()])
        gap = np.linalg.norm(have - want) / np.linalg.norm(want)
        assert gap <= 1e-2, (region, gap, got.iterations,
                             int(ref.iterations))


def test_coarse_build_is_bitwise_chunk_and_block_free(monkeypatch):
    """The pair chunks and the smoothing column blocks change only when a
    segment sum runs, never its terms or their order."""
    p = _problem("IMPLICIT", fixed=True)
    s = p["s"]
    plan = tseg.build_cluster_plan(s.cam_idx, s.pt_idx, p["nc"], p["npt"])
    whole = tseg.device_cluster_plan(plan, torch.device("cpu"))
    monkeypatch.setattr(tseg, "EC_CHUNK_PAIRS", 97)
    chunked = tseg.device_cluster_plan(plan, torch.device("cpu"))
    assert len(whole.ec_chunks) == 1 and len(chunked.ec_chunks) > 3

    def build(dplan):
        return tprecond.build_two_level_coarse(
            *p["port"], dplan, mt.ComputeKind.IMPLICIT, p["plans"],
            cam_fixed=p["cam_fixed"], smooth_omega=0.5)

    a = build(whole)
    n = p["dual"].cam.n_slots
    assert tprecond._smooth_block_columns(CD, n, 8, 9 * plan.num_clusters
                                          ) == 9 * plan.num_clusters
    # Blocks of three columns.
    monkeypatch.setattr(tprecond, "_SMOOTH_BLOCK_BYTES", 3 * CD * n * 8)
    assert tprecond._smooth_block_columns(CD, n, 8, 99) == 3
    b = build(chunked)
    for f in ("coarse_matrix", "G", "Y", "eig_inv"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("knobs", [dict(max_levels=2),
                                   dict(coarsen_factor=2.0, max_levels=4)],
                         ids=["depth2", "depth4"])
@pytest.mark.parametrize("omega", [0.0, 0.5])
def test_multilevel_coarse_matches_jax(knobs, omega):
    p = _problem("EXPLICIT", num_cameras=24, num_points=160, seed=1,
                 fixed=omega > 0)
    dplan, jplan, host = _plans(p, multilevel=True, **knobs)
    assert len(host.level_sizes) == (1 if knobs["max_levels"] == 2 else 3)
    got = tprecond.build_multilevel_coarse(
        *p["port"], dplan, mt.ComputeKind.EXPLICIT, p["plans"],
        cam_fixed=p["cam_fixed"], smooth_omega=omega)
    want = jprecond.build_multilevel_coarse(
        *p["jax"], jplan, jc.ComputeKind.EXPLICIT,
        cam_fixed=p["jcam_fixed"], smooth_omega=omega, cam_idx=p["ci"],
        pt_idx=p["pi"])
    assert len(got.chain) == len(want.chain)
    for i, (g, w) in enumerate(zip(got.chain, want.chain)):
        _close(g.A, w.A, what=f"level {i + 2} A")
        assert bool(g.ok) == bool(w.ok) is True
        if w.assign is not None:
            _close(g.D_inv, w.D_inv, what=f"level {i + 2} D_inv")
            _close(g.omega_s, w.omega_s, what=f"level {i + 2} omega_s")
            np.testing.assert_array_equal(g.assign.numpy(), w.assign)
    assert [bool(x) for x in got.level_ok] == [bool(x) for x in
                                               want.level_ok]
    binv = tprecond.block_inv(p["port"][0])
    jbinv = jnp.asarray(binv.numpy())
    r = np.random.default_rng(2).standard_normal((CD, p["nc"]))
    out = tprecond.multilevel_cycle(
        got, lambda x: tprecond.cam_block_matvec(binv, x),
        torch.from_numpy(r))
    jout = jprecond.multilevel_cycle(
        want, lambda x: jprecond.cam_block_matvec(jbinv, x), jnp.asarray(r))
    _close(out, jout, what="multilevel_cycle")


# ------------------------------------------------- ports of the JAX tests


def _dense(p):
    """The explicit damped Schur complement S_d [Nc*cd, Nc*cd], D^-1 and
    a materialiser of an apply, from the port's operands (numpy)."""
    Hpp_d, Hll_inv, _, (Jc,), (Jp,) = p["port"]
    plans = p["dual"]
    from megba_tpu_torch.core.fm import coupling_rows
    W = coupling_rows(Jc, plans.to_cam(Jp), 2).numpy()
    cam = plans.cam.seg.numpy()
    pt = plans.pt.seg.long().index_select(0, plans.cam.inv).numpy()
    nc, npt = p["nc"], p["npt"]
    S = np.zeros((nc * CD, nc * CD))
    for i in range(nc):
        S[i * CD:(i + 1) * CD, i * CD:(i + 1) * CD] = Hpp_d[i].numpy()
    Hpl = np.zeros((nc * CD, npt * PD))
    for e in range(W.shape[1]):
        c, q = cam[e], pt[e]
        Hpl[c * CD:(c + 1) * CD, q * PD:(q + 1) * PD] += W[:, e].reshape(
            CD, PD)
    Hi = Hll_inv.numpy()
    Hlli = np.zeros((npt * PD, npt * PD))
    for q in range(npt):
        Hlli[q * PD:(q + 1) * PD, q * PD:(q + 1) * PD] = Hi[:, q].reshape(
            PD, PD)
    binv = tprecond.block_inv(Hpp_d)
    D_inv = np.zeros_like(S)
    for i in range(nc):
        D_inv[i * CD:(i + 1) * CD, i * CD:(i + 1) * CD] = binv[i].numpy()
    return S - Hpl @ Hlli @ Hpl.T, D_inv, binv


def _materialize(apply_fn, nc):
    cols = []
    for e in np.eye(nc * CD):
        r = torch.from_numpy(e.reshape(nc, CD).T.copy())
        cols.append(apply_fn(r).numpy().T.reshape(-1))
    return np.stack(cols, axis=1)


def _dense_R(cluster, nc, C):
    R = np.zeros((C * CD, nc * CD))
    for n in range(nc):
        R[cluster[n] * CD:(cluster[n] + 1) * CD,
          n * CD:(n + 1) * CD] = np.eye(CD)
    return R


def _filtered_pinv(A):
    lam, Q = np.linalg.eigh(0.5 * (A + A.T))
    keep = lam > 1e-5 * lam.max()
    return (Q[:, keep] / lam[keep]) @ Q[:, keep].T


@pytest.mark.parametrize("omega", [0.0, 0.6])
def test_coarse_is_exact_galerkin_and_cycle_matches_formula(omega):
    """tests/test_precond.py:119 (plain) and tests/test_multilevel.py:213
    and :256 (smoothed): A_c = Pi^T S Pi, G = S Pi, Y = D^-1 S R^T, and the
    cycle Pi A_c^+ Pi^T + P^T D^-1 P with P = I - S Pi A_c^+ Pi^T; SPD."""
    p = _problem("EXPLICIT", num_cameras=7, num_points=40, locality=None,
                 seed=2)
    nc = p["nc"]
    dplan, _, host = _plans(p)
    coarse = tprecond.build_two_level_coarse(
        *p["port"], dplan, mt.ComputeKind.EXPLICIT, p["plans"],
        smooth_omega=omega)
    assert bool(coarse.ok)
    S, D_inv, binv = _dense(p)
    R = _dense_R(host.cluster, nc, host.num_clusters)
    Pi = R.T - omega * D_inv @ S @ R.T
    atol = 1e-9 * np.abs(S).max()

    def rows(X):  # [cd, Nc, C, cd] -> [(n, a), (J, b)]
        return X.numpy().transpose(1, 0, 2, 3).reshape(nc * CD, -1)

    np.testing.assert_allclose(coarse.coarse_matrix.numpy(), Pi.T @ S @ Pi,
                               atol=atol)
    np.testing.assert_allclose(rows(coarse.G), S @ Pi, atol=atol)
    if omega:
        np.testing.assert_allclose(rows(coarse.Y), D_inv @ S @ R.T,
                                   atol=atol)
    M = _materialize(lambda r: tprecond.two_level_cycle(
        coarse, lambda x: tprecond.cam_block_matvec(binv, x), r), nc)
    Aplus = _filtered_pinv(Pi.T @ S @ Pi)
    P = np.eye(nc * CD) - S @ Pi @ Aplus @ Pi.T
    M_ref = Pi @ Aplus @ Pi.T + P.T @ D_inv @ P
    np.testing.assert_allclose(M, M_ref, atol=1e-9 * np.abs(M_ref).max())
    assert np.abs(M - M.T).max() / np.abs(M).max() < 1e-12
    assert np.linalg.eigvalsh(0.5 * (M + M.T)).min() > 0


def test_two_level_preconditioner_is_spd():
    """tests/test_precond.py:164, the TWO_LEVEL case."""
    p = _problem("EXPLICIT", num_cameras=7, num_points=40, locality=None,
                 seed=2)
    dplan, _, _ = _plans(p)
    apply_fn, code = tprecond.make_schur_preconditioner(
        TWO, HPP, *p["port"], p["plans"], mt.ComputeKind.EXPLICIT,
        cluster_plan=dplan)
    M = _materialize(apply_fn, p["nc"])
    assert np.abs(M - M.T).max() / np.abs(M).max() < 1e-12
    assert np.linalg.eigvalsh(0.5 * (M + M.T)).min() > 0
    assert int(code) == 0


def test_multilevel_cycle_is_symmetric_spd_at_depth_3plus():
    """tests/test_multilevel.py:294."""
    p = _problem("EXPLICIT", num_cameras=24, num_points=160, seed=1,
                 region=100.0)
    nc = p["nc"]
    dplan, _, host = _plans(p, multilevel=True, coarsen_factor=2.0,
                            max_levels=4)
    assert len(host.level_sizes) >= 2
    S, _, binv = _dense(p)
    M_j = _materialize(lambda r: tprecond.cam_block_matvec(binv, r), nc)

    def cond_of(Mx):
        evs = np.linalg.eigvals(Mx @ S).real
        evs = evs[evs > 1e-9 * evs.max()]
        return evs.max() / evs.min()

    for omega in (0.0, 0.5):
        apply_fn, code = tprecond.make_schur_preconditioner(
            MULTI, HPP, *p["port"], p["plans"], mt.ComputeKind.EXPLICIT,
            cluster_plan=dplan, smooth_omega=omega)
        M = _materialize(apply_fn, nc)
        assert np.abs(M - M.T).max() / np.abs(M).max() < 1e-12, omega
        assert np.linalg.eigvalsh(0.5 * (M + M.T)).min() > 0, omega
        assert int(code) == 0
        assert cond_of(M) < 0.5 * cond_of(M_j)


def test_multilevel_depth2_is_bitwise_the_two_level_apply():
    """tests/test_multilevel.py:329."""
    p = _problem("IMPLICIT", region=80.0)
    dplan, _, host = _plans(p)
    mplan, _, mhost = _plans(p, multilevel=True, max_levels=2)
    assert not mhost.assign and mhost.level_sizes == (host.num_clusters,)
    two, code2 = tprecond.make_schur_preconditioner(
        TWO, HPP, *p["port"], p["plans"], mt.ComputeKind.IMPLICIT,
        cluster_plan=dplan)
    multi, codem = tprecond.make_schur_preconditioner(
        MULTI, HPP, *p["port"], p["plans"], mt.ComputeKind.IMPLICIT,
        cluster_plan=mplan)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (CD, p["nc"])))
    assert torch.equal(two(r), multi(r))
    assert int(code2) == int(codem) == 0


@pytest.mark.parametrize("kind", ["TWO_LEVEL", "MULTILEVEL"])
def test_poisoned_coarse_truncates_to_base_apply_bitwise(kind):
    """tests/test_precond.py:295 and tests/test_multilevel.py:353: a NaN
    camera block poisons level 1, every level's bit is set (ancestor
    gating), the code equals JAX's and the apply is bitwise the base
    apply on the finite blocks; the healthy build sets no bit."""
    multilevel = kind == "MULTILEVEL"
    p = _problem("IMPLICIT", num_cameras=24, num_points=160, seed=1,
                 region=80.0)
    knobs = dict(coarsen_factor=2.0, max_levels=4) if multilevel else {}
    dplan, jplan, host = _plans(p, multilevel=multilevel, **knobs)
    Hpp_bad = p["port"][0].clone()
    Hpp_bad[0, 0, 0] = float("nan")
    pk, jk = mt.PrecondKind[kind], jc.PrecondKind[kind]
    apply_bad, code = tprecond.make_schur_preconditioner(
        pk, HPP, Hpp_bad, *p["port"][1:], p["plans"],
        mt.ComputeKind.IMPLICIT, cluster_plan=dplan)
    _, jcode = jprecond.make_schur_preconditioner(
        jk, jc.PreconditionerKind.HPP, jnp.asarray(Hpp_bad.numpy()),
        *p["jax"][1:], p["ci"], p["pi"], p["nc"], jc.ComputeKind.IMPLICIT,
        None, False, cluster_plan=jplan)
    n_levels = len(host.level_sizes) if multilevel else 1
    assert int(code) == int(jcode)
    assert tprecond.decode_precond_fallback_levels(int(code)) == (
        [True] * n_levels)
    assert tprecond.decode_precond_fallback(int(code))["block"] == 0
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (CD, p["nc"])))
    want = tprecond.cam_block_matvec(tprecond.block_inv(Hpp_bad), r)
    assert torch.equal(apply_bad(r)[:, 1:], want[:, 1:])
    _, code_ok = tprecond.make_schur_preconditioner(
        pk, HPP, *p["port"], p["plans"], mt.ComputeKind.IMPLICIT,
        cluster_plan=dplan)
    assert int(code_ok) == 0


def test_fallback_bitfield_round_trips_beyond_two_levels():
    """tests/test_multilevel.py:387, on host ints and on tensors."""
    R = tprecond.FALLBACK_BLOCK_RADIX
    for block, bits in ((0, 0), (3, 0b1), (0, 0b101), (37, 0b111),
                        (65535, 0b1000)):
        for code in (tprecond.encode_precond_fallback(block, bits),
                     int(tprecond.encode_precond_fallback(
                         torch.tensor(block), torch.tensor(bits)))):
            assert tprecond.decode_precond_fallback(code) == {
                "block": block, "coarse": bits}
            assert tprecond.decode_precond_fallback_levels(code) == [
                bool(bits >> i & 1) for i in range(bits.bit_length())]
    code = int(tprecond.encode_precond_fallback(torch.tensor(R + 7),
                                                torch.tensor(0b110)))
    assert tprecond.decode_precond_fallback(code) == {"block": R - 1,
                                                      "coarse": 0b110}
    assert tprecond.decode_precond_fallback_levels(code) == [False, True,
                                                             True]


@pytest.mark.parametrize("kind", ["TWO_LEVEL", "MULTILEVEL"])
def test_coarse_family_requires_cluster_plan(kind):
    """tests/test_precond.py:327 and tests/test_multilevel.py:494."""
    p = _problem("IMPLICIT", num_cameras=5, num_points=25, seed=4,
                 locality=None)
    (tsys, tJc, tJp, plans) = _carry_system(p)
    with pytest.raises(ValueError, match="cluster plan"):
        tpcg.schur_pcg_solve(tsys, tJc, tJp, plans,
                             torch.tensor(10.0, dtype=torch.float64),
                             precond=mt.PrecondKind[kind])


def _carry_system(p):
    """An undamped port system of the scene (for `schur_pcg_solve`)."""
    from megba_tpu_torch.linear_system import builder as tb
    from megba_tpu_torch.ops.residuals import (
        bal_residual_jacobian_analytical_fm as teng)

    s, plans = p["s"], p["dual"]
    tci = plans.cam.seg.long()
    tpi = plans.pt.seg.long().index_select(0, plans.cam.inv)
    r, Jc, Jp = teng(torch.from_numpy(s.cameras0.T.copy()).index_select(
        1, tci), torch.from_numpy(s.points0.T.copy()).index_select(1, tpi),
        torch.from_numpy(s.obs.T.copy()))
    r, Jc, Jp = tb.weight_system_inputs(
        r, Jc, Jp, tci, tpi, torch.ones(r.shape[1], dtype=torch.float64))
    Jp = plans.to_pt(Jp)
    return (tb.build_schur_system((r,), (Jc,), (Jp,), p["plans"], p["nc"],
                                  p["npt"]),
            (Jc,), (Jp,), p["plans"])

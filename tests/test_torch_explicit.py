"""The port's explicit-Schur path vs the JAX package.

- `seg_reduce` / `seg_expand` (plain versions on the CPU) against the JAX
  `tile_reduce` / `tile_expand` Pallas kernels in interpret mode at
  float32, and against their XLA fallbacks at float64, on both sides
  (camera F=9, point F=3) with empty, one-edge and 300-edge segments
  (`seg_reduce` also 256-, 4097- and 10,000-edge ones);
- the stored coupling rows `SchurSystem.W` against JAX
  `build_schur_system(compute_kind=EXPLICIT)` at float64;
- `schur_pcg_solve` EXPLICIT, fused off and on, against the JAX solve on
  the same system (carried across with `convert.schur_system_to_torch`);
- `flat_solve` EXPLICIT, fused off and on, against JAX `flat_solve` at
  float64 (cost trajectory, accept pattern, counts) and against the JAX
  tiled lowering at float32;
- `validate_options` on the compute-kind / fused combinations.

CPU only; the CUDA kernels are held to the same plain versions by
tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import megba_tpu.common as jc
from megba_tpu.linear_system import builder as jb
from megba_tpu.ops import segtiles as jseg
from megba_tpu.ops.residuals import bal_residual_jacobian_analytical_fm as jeng
from megba_tpu.ops.residuals import make_residual_jacobian_fn
from megba_tpu.solve import flat_solve as j_flat_solve
from megba_tpu.solver import pcg as jpcg

import megba_tpu_torch as mt
from megba_tpu_torch import common as tc
from megba_tpu_torch.convert import result_to_numpy, schur_system_to_torch
from megba_tpu_torch.linear_system import builder as tb
from megba_tpu_torch.ops import fused as tfused
from megba_tpu_torch.ops import segtiles as tseg
from megba_tpu_torch.parallel.mesh import one_shard
from megba_tpu_torch.ops.residuals import (
    bal_residual_jacobian_analytical_fm as teng)
from megba_tpu_torch.solver import pcg as tpcg

# The tolerances of tests/test_torch_segtiles.py: f32 a few ulps of the
# segment's magnitude (another summation order), f64 reordering only.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
F64_TOL = dict(rtol=1e-12, atol=1e-12)

EXPLICIT = tc.ComputeKind.EXPLICIT


# ---------------------------------------------------------------------------
# Kernels 4 and 5: seg_reduce / seg_expand
# ---------------------------------------------------------------------------


def _segment_ids(seed, num_segments, long=()):
    """Ids with an empty segment, a one-edge segment and a 300-edge one,
    then segments of the `long` lengths, the rest 0..7 edges each,
    shuffled into edge order."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 8, num_segments)
    counts[0], counts[1], counts[2] = 0, 1, 300
    counts[3:3 + len(long)] = long
    idx = np.repeat(np.arange(num_segments), counts)
    return idx[rng.permutation(idx.shape[0])].astype(np.int32)


def _plans(idx, num_segments, F):
    """The JAX tile plan (host and device) and the port's CSR plan (host
    and device) of the same segment ids."""
    tile, block = (128, 8) if F == 9 else (64, 16)
    jplan = jseg.build_tile_plan(idx, num_segments, tile, block)
    hplan = tseg.build_seg_plan(idx, num_segments)
    tplan = tseg.device_plan(hplan, np.zeros_like(hplan.perm), "cpu")
    return jplan, jseg.device_plan(jplan), hplan, tplan


def _jax_slots(a, jplan):
    return jnp.asarray((a[:, jplan.perm] * jplan.mask).astype(a.dtype))


def _port_slots(a, hplan):
    return torch.from_numpy(np.ascontiguousarray(a[:, hplan.perm]))


SEG_CASES = [(dtype, F, seed) for dtype in (np.float32, np.float64)
             for F in (9, 3) for seed in (0, 1)]


# Kernel 4's launch shapes on the card: a segment of 256 slots is summed
# by a whole block, one of 4097 and one of 10,000 in split chunks.  At
# float32 two summation orders of thousands of terms part by more than
# F32_TOL of a sum that cancels: those segments are held within 1e-5 of
# the sum of their terms' magnitudes (chip_smoke.py's F32_REL_TO_ABS_SUM
# rule), every other segment to F32_TOL as before.
LONG_SEGMENTS = (256, 4097, 10_000)
F32_REL_TO_ABS_SUM = 1e-5


@pytest.mark.parametrize("dtype,F,seed", SEG_CASES)
def test_seg_reduce_matches_jax(dtype, F, seed):
    ns = 40
    idx = _segment_ids(seed, ns, LONG_SEGMENTS)
    jplan, jdp, hplan, tplan = _plans(idx, ns, F)
    data = np.random.default_rng(seed + 7).standard_normal(
        (F, idx.shape[0])).astype(dtype)
    if dtype == np.float32:
        want = jseg.tile_reduce(_jax_slots(data, jplan), jdp, interpret=True)
        tol = F32_TOL
    else:
        want = jseg.reduce_fallback(_jax_slots(data, jplan), jdp)
        tol = F64_TOL
    got = tseg.seg_reduce(_port_slots(data, hplan), tplan)
    assert got.dtype == torch.from_numpy(data).dtype
    assert got.shape == (F, ns)
    want = np.asarray(want)
    long = np.arange(3, 3 + len(LONG_SEGMENTS))
    short = np.setdiff1d(np.arange(ns), long) if dtype == np.float32 else (
        np.arange(ns))
    np.testing.assert_allclose(got.numpy()[:, short], want[:, short], **tol)
    if dtype == np.float32:
        abs_sum = tseg.seg_reduce(_port_slots(np.abs(data), hplan),
                                  tplan).numpy()[:, long]
        err = np.abs(got.numpy()[:, long] - want[:, long])
        assert np.all(err <= F32_REL_TO_ABS_SUM * abs_sum)
    assert np.array_equal(np.diff(tplan.seg_ptr.numpy())[long],
                          LONG_SEGMENTS)
    assert not got[:, 0].any()  # the empty segment sums to exactly 0
    np.testing.assert_array_equal(got[:, 1].numpy(),
                                  data[:, np.nonzero(idx == 1)[0][0]])


@pytest.mark.parametrize("dtype,F,seed", SEG_CASES)
def test_seg_expand_matches_jax(dtype, F, seed):
    ns = 40
    idx = _segment_ids(seed, ns)
    jplan, jdp, hplan, tplan = _plans(idx, ns, F)
    n = idx.shape[0]
    table = np.random.default_rng(seed + 9).standard_normal(
        (F, ns)).astype(dtype)
    if dtype == np.float32:
        jout = np.asarray(jseg.tile_expand(jnp.asarray(table), jdp,
                                           interpret=True))
        tol = F32_TOL
    else:
        jout = np.asarray(jseg.expand_fallback(jnp.asarray(table), jdp))
        tol = F64_TOL
    # Back to edge order: the two plans order their slots differently,
    # and the JAX plan's padding slots hold no edge.
    real = jplan.mask > 0
    want = np.empty((F, n), jout.dtype)
    want[:, jplan.perm[real]] = jout[:, real]
    got = tseg.seg_expand(torch.from_numpy(table), tplan).numpy()
    assert got.dtype == dtype and got.shape == (F, n)
    edges = np.empty_like(got)
    edges[:, hplan.perm] = got
    np.testing.assert_allclose(edges, want.astype(dtype), **tol)
    np.testing.assert_array_equal(edges, table[:, idx])


def test_seg_wrappers_validate_operands():
    idx = _segment_ids(0, 40)
    _, _, hplan, tplan = _plans(idx, 40, 9)
    data = _port_slots(np.ones((9, idx.shape[0])), hplan)
    with pytest.raises(ValueError, match="disagree"):
        tseg.seg_reduce(data[:, :-1].contiguous(), tplan)
    with pytest.raises(ValueError, match="disagree"):
        tseg.seg_expand(torch.ones(9, 39, dtype=torch.float64), tplan)
    with pytest.raises(ValueError, match="contiguous"):
        tseg.seg_expand(torch.ones(40, 9, dtype=torch.float64).T, tplan)
    with pytest.raises(TypeError, match="dtype"):
        tseg.seg_reduce(data.to(torch.int64), tplan)


# ---------------------------------------------------------------------------
# Schur build and PCG on the same system
# ---------------------------------------------------------------------------


def _scene(seed, fixed):
    """A scene with one unobserved camera and point appended, a soft edge
    mask and, optionally, fixed vertices."""
    s = mt.make_synthetic_bal(num_cameras=6, num_points=50, obs_per_point=3.5,
                              seed=seed)
    cams = np.concatenate([s.cameras0, s.cameras0[:1] + 0.01])
    pts = np.concatenate([s.points0, s.points0[:1] + 0.01])
    cam_fixed = pt_fixed = None
    if fixed:
        cam_fixed = np.zeros(cams.shape[0], bool)
        cam_fixed[0] = True
        pt_fixed = np.zeros(pts.shape[0], bool)
        pt_fixed[[3, 7]] = True
    rng = np.random.default_rng(seed)
    mask = (rng.random(s.obs.shape[0]) > 0.1).astype(np.float64)
    return s, cams, pts, mask, cam_fixed, pt_fixed


def _explicit_systems(seed, fixed):
    """Both packages' EXPLICIT systems of one scene: JAX in the caller's
    edge order (its unplanned float64 path), the port in camera-slot
    order with Jp in point-slot order."""
    s, cams, pts, mask, cf, pf = _scene(seed, fixed)
    nc, npt = cams.shape[0], pts.shape[0]

    ci, pi = jnp.asarray(s.cam_idx), jnp.asarray(s.pt_idx)
    jcf = None if cf is None else jnp.asarray(cf)
    jpf = None if pf is None else jnp.asarray(pf)
    r, Jc, Jp = jeng(jnp.take(jnp.asarray(cams.T), ci, axis=1),
                     jnp.take(jnp.asarray(pts.T), pi, axis=1),
                     jnp.asarray(s.obs.T))
    r, Jc, Jp = jb.weight_system_inputs(r, Jc, Jp, ci, pi, jnp.asarray(mask),
                                        None, jcf, jpf)
    jsys = jb.build_schur_system(r, Jc, Jp, ci, pi, nc, npt,
                                 compute_kind=jc.ComputeKind.EXPLICIT,
                                 cam_fixed=jcf, pt_fixed=jpf)

    plan_c, plans = tseg.make_dual_plans(s.cam_idx, s.pt_idx, nc, npt, "cpu")
    perm = plan_c.perm
    tci = plans.cam.seg.long()
    tpi = torch.from_numpy(s.pt_idx[perm].astype(np.int64))
    tcf = None if cf is None else torch.from_numpy(cf)
    tpf = None if pf is None else torch.from_numpy(pf)
    r, tJc, tJp = teng(torch.from_numpy(cams.T.copy()).index_select(1, tci),
                       torch.from_numpy(pts.T.copy()).index_select(1, tpi),
                       torch.from_numpy(s.obs[perm].T.copy()))
    r, tJc, tJp = tb.weight_system_inputs(
        r, tJc, tJp, tci, tpi, torch.from_numpy(mask[perm]), None, tcf, tpf)
    tJp = plans.to_pt(tJp)
    tsys = tb.build_schur_system((r,), (tJc,), (tJp,), one_shard(plans), nc,
                                 npt, tcf, tpf, EXPLICIT)
    return (jsys, Jc, Jp, ci, pi), (tsys, plans, perm)


@pytest.mark.parametrize("seed,fixed", [(0, False), (1, True)])
def test_explicit_schur_system_W_matches_jax(seed, fixed):
    (jsys, *_), (tsys, plans, perm) = _explicit_systems(seed, fixed)
    want = np.asarray(jsys.W)[:, perm]  # JAX edge order -> cam slots
    assert tsys.W is not None and len(tsys.W) == 1  # one shard's rows
    W = tsys.W[0]
    assert W.shape == want.shape == (27, perm.size) and W.is_contiguous()
    np.testing.assert_allclose(W.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    for name in ("Hpp", "Hll", "g_cam", "g_pt"):
        ref = np.asarray(getattr(jsys, name))
        np.testing.assert_allclose(getattr(tsys, name).numpy(), ref,
                                   rtol=1e-10, atol=1e-10 * np.abs(ref).max(),
                                   err_msg=name)


def test_implicit_build_stores_no_W():
    s, cams, pts, mask, _, _ = _scene(0, False)
    _, plans = tseg.make_dual_plans(s.cam_idx, s.pt_idx, cams.shape[0],
                                    pts.shape[0], "cpu")
    n = s.obs.shape[0]
    r, Jc, Jp = (torch.ones(2, n, dtype=torch.float64),
                 torch.ones(18, n, dtype=torch.float64),
                 torch.ones(6, n, dtype=torch.float64))
    sys = tb.build_schur_system((r,), (Jc,), (Jp,), one_shard(plans),
                                cams.shape[0], pts.shape[0])
    assert sys.W is None
    with pytest.raises(ValueError, match="W rows"):
        tpcg.make_coupling_matvecs(Jc, Jp, plans, EXPLICIT, None)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("seed,fixed,tol,refuse,rel", [
    (0, False, 1e-10, 1e30, False),   # the venice solver options
    (1, True, 1e-10, 1e30, False),
    (2, False, 1e-6, 1.0, True),      # relative tol, refuse-ratio restore
])
def test_explicit_schur_pcg_matches_jax(fused, seed, fixed, tol, refuse, rel):
    (jsys, jJc, jJp, ci, pi), (_, plans, perm) = _explicit_systems(seed,
                                                                    fixed)
    # The JAX system, carried across: the port solves the same numbers.
    tsys = schur_system_to_torch(jsys, device="cpu", edge_perm=perm)
    if fused:
        plans = tfused.with_fused_plans(plans)
    for region in (1e3, 0.5):
        kw = dict(max_iter=30, tol=tol, refuse_ratio=refuse, tol_relative=rel,
                  compute_kind=EXPLICIT)
        ref = jpcg.schur_pcg_solve(
            jsys, jJc, jJp, ci, pi, jnp.asarray(region),
            **dict(kw, compute_kind=jc.ComputeKind.EXPLICIT))
        got = tpcg.schur_pcg_solve(
            tsys, None, None, one_shard(plans),
            torch.tensor(region, dtype=torch.float64),
            fused_kernels=fused, **kw)
        assert got.iterations == int(ref.iterations)
        for name in ("dx_cam", "dx_pt"):
            r = np.asarray(getattr(ref, name))
            np.testing.assert_allclose(getattr(got, name).numpy(), r,
                                       rtol=1e-10,
                                       atol=1e-10 * np.abs(r).max(),
                                       err_msg=f"{name} at region {region}")


def test_schur_system_to_torch_reorders_W():
    rng = np.random.default_rng(0)

    class Sys:  # the JAX SchurSystem's fields, as numpy
        Hpp = rng.standard_normal((3, 9, 9))
        Hll = rng.standard_normal((9, 5))
        g_cam = rng.standard_normal((9, 3))
        g_pt = rng.standard_normal((3, 5))
        W = rng.standard_normal((27, 7))

    perm = rng.permutation(7)
    t = schur_system_to_torch(Sys, device="cpu", dtype=torch.float32,
                              edge_perm=perm)
    assert t.Hpp.dtype == torch.float32 and t.Hpp.shape == (3, 9, 9)
    assert len(t.W) == 1  # the rows of a one-shard mesh
    np.testing.assert_array_equal(t.W[0].numpy(),
                                  Sys.W[:, perm].astype(np.float32))
    Sys.W = None
    assert schur_system_to_torch(Sys, device="cpu").W is None


# ---------------------------------------------------------------------------
# The whole slice: flat_solve
# ---------------------------------------------------------------------------


def _options(dtype, max_iter, fused):
    kw = dict(max_iter=max_iter, epsilon1=1e-12, epsilon2=1e-15)
    skw = dict(max_iter=30, tol=1e-10, refuse_ratio=1e30)
    j = jc.ProblemOption(
        dtype=dtype, jacobian_mode=jc.JacobianMode.ANALYTICAL,
        compute_kind=jc.ComputeKind.EXPLICIT,
        algo_option=jc.AlgoOption(**kw), solver_option=jc.SolverOption(**skw))
    t = mt.ProblemOption(
        dtype=dtype, jacobian_mode=mt.JacobianMode.ANALYTICAL,
        compute_kind=EXPLICIT, algo_option=mt.AlgoOption(**kw),
        solver_option=mt.SolverOption(fused_kernels=fused, **skw))
    return j, t


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("case", ["plain", "masked_fixed_weighted"])
def test_explicit_flat_solve_matches_jax_f64(case, fused):
    s = mt.make_synthetic_bal(num_cameras=8, num_points=120,
                              obs_per_point=3.5, seed=3)
    jopt, topt = _options(np.float64, max_iter=8, fused=fused)
    extra = {}
    if case != "plain":
        rng = np.random.default_rng(3)
        n = s.obs.shape[0]
        cam_fixed = np.zeros(8, bool)
        cam_fixed[[0, 1]] = True
        pt_fixed = np.zeros(120, bool)
        pt_fixed[5] = True
        L = np.tril(0.3 * rng.standard_normal((n, 2, 2))) + np.eye(2)
        extra = dict(sqrt_info=L, cam_fixed=cam_fixed, pt_fixed=pt_fixed,
                     edge_mask=(rng.random(n) > 0.05).astype(np.float64))
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    # The JAX package fuses only on its tiled lowering; its unfused
    # EXPLICIT solve computes the same products.
    jres = j_flat_solve(make_residual_jacobian_fn(
        mode=jc.JacobianMode.ANALYTICAL), *args, jopt, use_tiled=False,
        **extra)
    tres = mt.flat_solve(*args, topt, device="cpu", **extra)
    t = result_to_numpy(tres)
    k = int(jres.iterations)
    assert k > 1
    assert (t["iterations"], t["accepted"], t["pcg_iterations"]) == (
        k, int(jres.accepted), int(jres.pcg_iterations))
    assert t["status"] == int(jres.status)
    np.testing.assert_array_equal(t["trace"]["accept"],
                                  np.asarray(jres.trace.accept)[:k])
    np.testing.assert_array_equal(t["trace"]["pcg_iters"],
                                  np.asarray(jres.trace.pcg_iters)[:k])
    np.testing.assert_allclose(t["trace"]["cost"],
                               np.asarray(jres.trace.cost)[:k], rtol=1e-9)
    np.testing.assert_allclose(t["cost"], float(jres.cost), rtol=1e-9)
    if case != "plain":
        np.testing.assert_array_equal(t["cameras"][:2], s.cameras0[:2])
        np.testing.assert_array_equal(t["points"][5], s.points0[5])


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_explicit_flat_solve_matches_jax_tiled_f32(fused):
    s = mt.make_synthetic_bal(num_cameras=8, num_points=120,
                              obs_per_point=3.5, seed=1, dtype=np.float32)
    jopt, topt = _options(np.float32, max_iter=6, fused=fused)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    jres = j_flat_solve(make_residual_jacobian_fn(
        mode=jc.JacobianMode.ANALYTICAL), *args, jopt, use_tiled=True)
    tres = mt.flat_solve(*args, topt, device="cpu")
    assert tres.cameras.dtype == torch.float32
    k = int(jres.iterations)
    assert tres.iterations == k
    # Near the optimum the trial costs differ by f32 rounding, where an
    # accept decision may go either way: the costs are what is compared.
    np.testing.assert_allclose(tres.trace.cost[:k].numpy(),
                               np.asarray(jres.trace.cost)[:k], rtol=1e-4)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-4)


def test_explicit_solve_bal_runs_on_cpu():
    s = mt.make_synthetic_bal(num_cameras=5, num_points=40, obs_per_point=3,
                              seed=2)
    bal = mt.BALFile(cameras=s.cameras0, points=s.points0, obs=s.obs,
                     cam_idx=s.cam_idx, pt_idx=s.pt_idx)
    _, topt = _options(np.float64, max_iter=3, fused=True)
    solved, res = mt.solve_bal(bal, topt, device="cpu")
    assert res.iterations >= 1 and float(res.cost) < float(res.initial_cost)
    assert solved.cameras.shape == (5, 9)


# ---------------------------------------------------------------------------
# Options
# ---------------------------------------------------------------------------


def _opt(**kw):
    so = kw.pop("solver_option", {})
    return tc.ProblemOption(jacobian_mode=tc.JacobianMode.ANALYTICAL,
                            solver_option=tc.SolverOption(**so), **kw)


@pytest.mark.parametrize("fused", [False, True])
def test_validate_options_accepts_explicit(fused):
    tc.validate_options(_opt(compute_kind=EXPLICIT,
                             solver_option=dict(fused_kernels=fused)))


@pytest.mark.parametrize("kw,err,match", [
    # Accepted since the fused implicit kernel and the whole
    # single-device precision ladder (fused or not, mixed at f32 or f64)
    # were ported (err None); tests/test_torch_precision.py holds the
    # refusals that remain.
    (dict(solver_option=dict(fused_kernels=True)), None, None),
    (dict(compute_kind=EXPLICIT, dtype=np.float32,
          solver_option=dict(bf16=True)), None, None),
    (dict(compute_kind=EXPLICIT, dtype=np.float32,
          solver_option=dict(fused_kernels=True, bf16=True)), None, None),
    (dict(compute_kind=EXPLICIT, mixed_precision_pcg=True), None, None),
    (dict(use_schur=False, solver_option=dict(fused_kernels=True)),
     ValueError, "fused_kernels"),
    (dict(compute_kind=1), ValueError, "ComputeKind"),
], ids=["implicit_fused", "explicit_bf16", "explicit_fused_bf16",
        "explicit_mixed_precision", "fused_without_schur", "bad_kind"])
def test_validate_options_refuses_typed(kw, err, match):
    if err is None:
        tc.validate_options(_opt(**kw))
        return
    with pytest.raises(err, match=match):
        tc.validate_options(_opt(**kw))
    if err is NotImplementedError:  # names what is missing
        with pytest.raises(err, match="fused_kernels"):
            tc.validate_options(_opt(**kw))

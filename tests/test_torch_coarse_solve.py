"""`flat_solve` with the TWO_LEVEL and MULTILEVEL preconditioners in the
port vs the JAX package's unfused solve, float64.

Each case runs the port unfused and with fused kernels against one JAX
solve: trial costs at rtol 1e-9 (NaN at the same iterations), equal
accept patterns, LM / PCG counts, status and `precond_fallback` traces
(`test_torch_guards.compare_robust`).  Between them the cases put each
family on both Schur kinds and both kernel routes: TWO_LEVEL with fixed
cameras on EXPLICIT and under a guarded NaN burst on IMPLICIT (the
residuals poisoned, the coarse operator finite: no coarse bit, as in
JAX), MULTILEVEL (four levels, coarsen factor 2) under SCHUR_DIAG on
IMPLICIT and smoothed (omega 2/3) on EXPLICIT, smoothed TWO_LEVEL on a
shuffled scene under COOBS on IMPLICIT; the mixed rung at f64 against
JAX's and the bf16 rung end to end; then a NaN camera (the coarse
operator poisoned: every level's bit set in every iteration, as in JAX);
and the port of
tests/test_multilevel.py:520 (MULTILEVEL reaches block-Jacobi's optimum
in fewer PCG iterations on a locality scene).  Each JAX program is
compiled once (a few seconds each, the bulk of this file's time): the
fused and unfused runs share one JAX solve, and the NaN-camera cases run
the options of another case.  CPU only.
"""

import functools

import numpy as np
import pytest
import torch

from megba_tpu.robustness import faults as jfaults

import megba_tpu_torch as mt
from megba_tpu_torch.convert import fault_plan_to_torch
from megba_tpu_torch.solver.precond import decode_precond_fallback_levels

from test_torch_guards import _jax_solve, _options, compare_robust

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

TWO, MULTI = mt.PrecondKind.TWO_LEVEL, mt.PrecondKind.MULTILEVEL
_ML = dict(precond=MULTI, coarsen_factor=2.0, max_levels=4)
_SMOOTH = dict(precond=TWO, smooth_omega=2 / 3)

# name: (kind, solver options, flat_solve extras: "fixed" fixes cameras 0
# and 5, "shuffle" puts the caller's edges in a seeded order).
_ML_SD = dict(_ML, preconditioner=mt.PreconditionerKind.SCHUR_DIAG)
_CASES = {
    "two_level_fixed": ("EXPLICIT", dict(precond=TWO), ("fixed",)),
    "multilevel_schur_diag": ("IMPLICIT", _ML_SD, ()),
    "multilevel_smoothed": ("EXPLICIT", dict(_ML, smooth_omega=2 / 3), ()),
    "smoothed_coobs": ("IMPLICIT", dict(_SMOOTH,
                                        edge_order=mt.EdgeOrder.COOBS),
                       ("shuffle",)),
}


def _scene():
    return mt.make_synthetic_bal(num_cameras=16, num_points=120,
                                 obs_per_point=4, seed=0, locality="ring")


def _inputs(extras):
    s = _scene()
    ci, pi, obs = s.cam_idx, s.pt_idx, s.obs
    if "shuffle" in extras:
        order = np.random.default_rng(7).permutation(ci.shape[0])
        ci, pi, obs = ci[order], pi[order], obs[order]
    kw = {}
    if "fixed" in extras:
        cf = np.zeros(s.cameras0.shape[0], bool)
        cf[[0, 5]] = True
        kw["cam_fixed"] = cf
    return (s.cameras0, s.points0, obs, ci, pi), kw


@functools.lru_cache(maxsize=None)
def _jax_result(name):
    kind, solver, extras = _CASES[name]
    args, kw = _inputs(extras)
    jopt, _ = _options(False, kind, False, **solver)
    return _jax_solve(args, jopt, **kw)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", list(_CASES))
def test_flat_solve_coarse_matches_jax(name, fused):
    kind, solver, extras = _CASES[name]
    args, kw = _inputs(extras)
    _, topt = _options(False, kind, fused, **solver)
    tres = mt.flat_solve(None, *args, topt, device="cpu", **kw)
    t = compare_robust(_jax_result(name), tres)
    assert float(tres.cost) < float(tres.initial_cost)
    assert not t["trace"]["precond_fallback"].any()
    assert tres.coarse_plan_seconds is not None
    if "fixed" in extras:
        np.testing.assert_array_equal(tres.cameras[[0, 5]].numpy(),
                                      args[0][[0, 5]])


def _burst(s, edges, stop):
    return jfaults.make_nan_burst(s.obs.shape[0], edges, start=0, stop=stop)


@functools.lru_cache(maxsize=None)
def _jax_nan_burst():
    s = _scene()
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    jopt, _ = _options(True, "IMPLICIT", False, precond=TWO)
    return _jax_solve(args, jopt, fault_plan=_burst(s, [2, 9], 1))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_guarded_nan_burst_matches_jax(fused):
    """Two poisoned edges over iteration 0: the residuals, hence the
    gradient and the trial costs, are not finite, but the Jacobians are,
    so the coarse operator stays finite and no coarse bit is set, in
    either package; the solve ends RECOVERED."""
    s = _scene()
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    _, topt = _options(True, "IMPLICIT", fused, precond=TWO)
    tres = mt.flat_solve(None, *args, topt, device="cpu",
                         fault_plan=fault_plan_to_torch(_burst(s, [2, 9], 1)))
    t = compare_robust(_jax_nan_burst(), tres)
    assert t["trace"]["recovery"][0]
    assert not t["trace"]["precond_fallback"].any()
    assert tres.status == int(mt.SolveStatus.RECOVERED)
    assert np.isfinite(float(tres.cost))


@pytest.mark.parametrize("kind", ["TWO_LEVEL", "MULTILEVEL"])
def test_nan_camera_sets_the_coarse_bits_as_jax(kind):
    """One NaN camera parameter: its Jacobian rows, Hpp block and so the
    coarse operator are not finite in every system; each level's bit is
    set in every iteration, as in JAX's trace, and the apply falls back to
    block-Jacobi (nothing raises).  TWO_LEVEL runs guarded, with an inert
    fault plan (no edge, an empty window: the NaN-burst case's program),
    and ends FATAL_NONFINITE; MULTILEVEL runs unguarded under SCHUR_DIAG
    (the `multilevel_schur_diag` case's program), whose block level falls
    back too, and ends STALLED."""
    s = _scene()
    cams = s.cameras0.copy()
    cams[2, 4] = np.nan
    args = (cams, s.points0, s.obs, s.cam_idx, s.pt_idx)
    if kind == "TWO_LEVEL":
        plan = _burst(s, [], 0)
        jopt, topt = _options(True, "IMPLICIT", False, precond=TWO)
        jres = _jax_solve(args, jopt, fault_plan=plan)
        tres = mt.flat_solve(None, *args, topt, device="cpu",
                             fault_plan=fault_plan_to_torch(plan))
        status = mt.SolveStatus.FATAL_NONFINITE
    else:
        jopt, topt = _options(False, "IMPLICIT", False, **_ML_SD)
        jres = _jax_solve(args, jopt)
        tres = mt.flat_solve(None, *args, topt, device="cpu")
        status = mt.SolveStatus.STALLED
    t = compare_robust(jres, tres)
    levels = {tuple(decode_precond_fallback_levels(int(c)))
              for c in t["trace"]["precond_fallback"]}
    assert len(levels) == 1 and all(levels.pop())
    assert t["status"] == int(status)


def test_mixed_f64_multilevel_smoothed_fused_matches_jax():
    """The mixed rung at f64 (from trust region 1, as every mixed-f64
    gate): the coarse build reads the equilibrated bfloat16 rows upcast,
    and the solve stays at rtol 1e-9 of JAX's."""
    s = _scene()
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    solver = dict(_ML, smooth_omega=0.5)
    jopt, _ = _options(False, "IMPLICIT", False, rung="mixed", **solver)
    _, topt = _options(False, "IMPLICIT", True, rung="mixed", **solver)
    t = compare_robust(_jax_solve(args, jopt),
                       mt.flat_solve(None, *args, topt, device="cpu"))
    assert not t["trace"]["precond_fallback"].any()


@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_bf16_coarse_flat_solve_runs(kind):
    """The bf16 rung at f32 end to end: TWO_LEVEL smooths with the bf16
    base apply and builds its coarse space in f32; the cost falls and no
    level falls back.  (Its PCG is held to JAX's in
    test_torch_coarse.py; after a few LM iterations the bf16 rung's cost
    is not in the band of the f32 solve on this scene, with JACOBI as
    with TWO_LEVEL, in either package.)"""
    s = mt.make_synthetic_bal(num_cameras=16, num_points=120,
                              obs_per_point=4, seed=0, locality="ring",
                              dtype=np.float32)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    _, b16 = _options(False, kind, kind == "IMPLICIT", dtype=np.float32,
                      rung="bf16", max_iter=6, precond=TWO, tol=1e-6,
                      tol_relative=True)
    res = mt.flat_solve(None, *args, b16, device="cpu")
    assert res.cameras.dtype == torch.float32
    assert np.isfinite(float(res.cost))
    assert float(res.cost) < 0.9 * float(res.initial_cost)
    assert not res.trace.precond_fallback[:res.iterations].any()


def test_multilevel_reaches_jacobi_optimum_with_fewer_pcg_iters():
    """tests/test_multilevel.py:520 on the port."""
    s = mt.make_synthetic_bal(num_cameras=16, num_points=120,
                              obs_per_point=4, seed=0, param_noise=5e-2,
                              pixel_noise=0.3, locality="ring")

    def solve(**skw):
        option = mt.ProblemOption(
            jacobian_mode=mt.JacobianMode.ANALYTICAL,
            algo_option=mt.AlgoOption(max_iter=12, epsilon1=1e-9,
                                      epsilon2=1e-12),
            solver_option=mt.SolverOption(max_iter=200, tol=1e-10,
                                          tol_relative=True,
                                          refuse_ratio=1e30, **skw))
        return mt.flat_solve(None, s.cameras0, s.points0, s.obs, s.cam_idx,
                             s.pt_idx, option, device="cpu")

    jac = solve()
    multi = solve(**_ML)
    np.testing.assert_allclose(float(multi.cost), float(jac.cost),
                               rtol=1e-6)
    assert multi.pcg_iterations < jac.pcg_iterations
    codes = multi.trace.precond_fallback[:multi.iterations].tolist()
    assert not any(any(decode_precond_fallback_levels(c)) for c in codes)

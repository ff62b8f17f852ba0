"""The port's Jacobian engines and its default solve vs the JAX package.

float64 throughout (the conftest enables x64 for JAX):

- per-edge r / Jc / Jp of AUTODIFF (reverse mode: vjp pullbacks of the
  batched residual under vmap) and AUTODIFF_FORWARD (jvp pushforwards
  under vmap) against the JAX engines, and against the port's
  ANALYTICAL engine, with cameras under the small-angle threshold
  (theta^2 < 1e-12, one of them exactly zero) among the edges;
- a custom residual written in both packages, through both autodiff
  modes, per edge and through `flat_solve`;
- `flat_solve` with AUTODIFF on IMPLICIT and EXPLICIT, unfused and fused,
  against the JAX package's unfused solve: trial costs at rtol 1e-9,
  equal accept patterns and LM / PCG counts;
- `solve_bal(bal)` with no option against the JAX package's: both run
  `ProblemOption()`, AUTODIFF at float64.

CPU only; tests/test_torch_cuda.py runs the engines and the new solve
paths on the card.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import megba_tpu.common as jc
from megba_tpu.io.bal import BALFile as JBALFile
from megba_tpu.ops import geo as jgeo
from megba_tpu.ops.residuals import make_residual_jacobian_fn as j_engine
from megba_tpu.solve import flat_solve as j_flat_solve
from megba_tpu.solve import solve_bal as j_solve_bal

import megba_tpu_torch as mt
from megba_tpu_torch.ops import geo as tgeo
from megba_tpu_torch.ops import residuals

from test_torch_solve import _compare

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

MODES = ["AUTODIFF", "AUTODIFF_FORWARD"]


def _edges(seed=0, n_small=6):
    """Feature-major edge rows of a synthetic scene, f64; the first
    cameras' angle-axis is zero or scaled under the small-angle
    threshold."""
    s = mt.make_synthetic_bal(num_cameras=10, num_points=80,
                              obs_per_point=3, seed=seed)
    cams = s.cameras0.copy()
    cams[0, 0:3] = 0.0
    cams[1:n_small, 0:3] *= 1e-7
    assert (np.sum(cams[:n_small, 0:3] ** 2, axis=1) < 1e-12).all()
    return (np.ascontiguousarray(cams[s.cam_idx].T),
            np.ascontiguousarray(s.points0[s.pt_idx].T),
            np.ascontiguousarray(s.obs.T), s.cam_idx)


def _close_per_row(got, want, rtol):
    """|got - want| <= rtol times the largest |want| of the row."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max(axis=-1, keepdims=True)
    err = np.abs(got - want)
    assert (err <= rtol * scale).all(), float((err / scale).max())


def _port(fn, *rows):
    return [t.numpy() for t in fn(*(torch.from_numpy(a) for a in rows))]


def _port_r(fn, *rows):
    """A value-only residual's r as numpy."""
    return fn(*(torch.from_numpy(a) for a in rows)).numpy()


@pytest.mark.parametrize("mode", MODES)
def test_engine_matches_jax_per_edge(mode):
    cam, pt, obs, cam_idx = _edges()
    want = j_engine(mode=jc.JacobianMode[mode])(
        jnp.asarray(cam), jnp.asarray(pt), jnp.asarray(obs))
    got = _port(mt.make_residual_jacobian_fn(mode=mt.JacobianMode[mode]),
                cam, pt, obs)
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max())
    # The small-angle cameras' edges are among them, with finite rows.
    assert (cam_idx < 6).sum() > 0


@pytest.mark.parametrize("mode", MODES)
def test_engine_matches_analytical(mode):
    cam, pt, obs, _ = _edges(seed=2)
    ref = _port(mt.make_residual_jacobian_fn(
        mode=mt.JacobianMode.ANALYTICAL), cam, pt, obs)
    got = _port(mt.make_residual_jacobian_fn(mode=mt.JacobianMode[mode]),
                cam, pt, obs)
    for g, w in zip(got, ref):
        _close_per_row(g, w, 1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_zero_angle_camera_has_finite_jacobian(mode):
    """The small-angle `where` selects between safe operands, so the
    gradient through the branch not taken stays finite."""
    cam, pt, obs, _ = _edges(seed=1)
    cam[0:3] = 0.0
    r, Jc, Jp = _port(mt.make_residual_jacobian_fn(
        mode=mt.JacobianMode[mode]), cam, pt, obs)
    assert np.isfinite(Jc).all() and np.isfinite(Jp).all()
    # d(R(w) x)/dw at w = 0 is -[x]_x: the closed form's limit.
    _, Jc_a, _ = _port(mt.make_residual_jacobian_fn(
        mode=mt.JacobianMode.ANALYTICAL), cam, pt, obs)
    _close_per_row(Jc, Jc_a, 1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_nonfinite_residual_stays_on_its_edge(mode):
    """The cotangent / tangent basis is exactly one-hot: an edge whose
    residual is not finite poisons only its own rows, and every other
    edge's rows are bitwise those of the clean batch."""
    cam, pt, obs, _ = _edges(seed=4)
    engine = mt.make_residual_jacobian_fn(mode=mt.JacobianMode[mode])
    clean = _port(engine, cam, pt, obs)
    pt[:, 3] = np.inf
    bad = _port(engine, cam, pt, obs)
    assert not np.isfinite(bad[0][:, 3]).any()
    keep = np.arange(cam.shape[1]) != 3
    for b, c in zip(bad, clean):
        np.testing.assert_array_equal(b[:, keep], c[:, keep])


# A custom residual, written once per package: BAL's camera and point,
# a division-model distortion in place of the polynomial one.
def t_division_residual(camera, point, obs):
    P = tgeo.angle_axis_rotate_point(camera[0:3], point) + camera[3:6]
    p = -P[0:2] / P[2]
    n = (p * p).sum(0)
    return camera[6] * p / (1.0 + camera[7] * n + camera[8] * n * n) - obs


def j_division_residual(camera, point, obs):
    P = jgeo.angle_axis_rotate_point(camera[0:3], point) + camera[3:6]
    p = -P[0:2] / P[2]
    n = jnp.dot(p, p)
    return camera[6] * p / (1.0 + camera[7] * n + camera[8] * n * n) - obs


@pytest.mark.parametrize("mode", MODES)
def test_custom_residual_matches_jax(mode):
    cam, pt, obs, _ = _edges(seed=5)
    want = j_engine(j_division_residual, jc.JacobianMode[mode])(
        jnp.asarray(cam), jnp.asarray(pt), jnp.asarray(obs))
    engine = mt.make_residual_jacobian_fn(t_division_residual,
                                          mt.JacobianMode[mode])
    got = _port(engine, cam, pt, obs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max())
    # Its value-only residual is the residual function itself.
    np.testing.assert_array_equal(_port_r(engine.residual, cam, pt, obs),
                                  got[0])


def test_custom_residual_flat_solve_matches_jax():
    s = mt.make_synthetic_bal(num_cameras=6, num_points=60, obs_per_point=3,
                              seed=6)
    jopt, topt = _options("IMPLICIT", "AUTODIFF_FORWARD", max_iter=5)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    jres = j_flat_solve(j_engine(j_division_residual,
                                 jc.JacobianMode.AUTODIFF_FORWARD),
                        *args, jopt)
    engine = mt.make_residual_jacobian_fn(t_division_residual,
                                          mt.JacobianMode.AUTODIFF_FORWARD)
    tres = mt.flat_solve(engine, *args, topt, device="cpu")
    _compare(jres, tres, cost_rtol=1e-9)


def test_engine_construction_rules():
    with pytest.raises(ValueError, match="analytical_fn"):
        mt.make_residual_jacobian_fn(t_division_residual,
                                     mt.JacobianMode.ANALYTICAL)
    # Memoised and call-shape normalised: one configuration, one engine.
    assert (mt.make_residual_jacobian_fn()
            is mt.make_residual_jacobian_fn(mode=mt.JacobianMode.AUTODIFF)
            is mt.make_residual_jacobian_fn(mt.bal_residual,
                                            mt.JacobianMode.AUTODIFF))
    assert (mt.build_residual_jacobian_fn()
            is not mt.build_residual_jacobian_fn())
    assert mt.make_residual_fn(t_division_residual) is t_division_residual
    # An analytical function given for a custom residual is the engine,
    # and its r is the trial cost's residual.
    engine = mt.build_residual_jacobian_fn(
        t_division_residual, mt.JacobianMode.ANALYTICAL,
        analytical_fn=residuals.bal_residual_jacobian_analytical_fm)
    cam, pt, obs, _ = _edges()
    r = _port_r(engine.residual, cam, pt, obs)
    np.testing.assert_array_equal(r, _port(engine, cam, pt, obs)[0])
    # A plain callable engine costs its trial points by its own r.
    plain = residuals.residual_only(
        residuals.bal_residual_jacobian_analytical_fm)
    np.testing.assert_array_equal(_port_r(plain, cam, pt, obs), r)


def _options(kind, mode, max_iter=8, fused=False):
    """(JAX, port) options: the JAX package fuses only on its tiled
    lowering, which float64 never takes, so its option is unfused."""
    kw = dict(max_iter=max_iter, epsilon1=1e-12, epsilon2=1e-15)
    skw = dict(max_iter=30, tol=1e-10, refuse_ratio=1e30)
    j = jc.ProblemOption(
        jacobian_mode=jc.JacobianMode[mode],
        compute_kind=jc.ComputeKind[kind], algo_option=jc.AlgoOption(**kw),
        solver_option=jc.SolverOption(**skw))
    t = mt.ProblemOption(
        jacobian_mode=mt.JacobianMode[mode],
        compute_kind=mt.ComputeKind[kind], algo_option=mt.AlgoOption(**kw),
        solver_option=mt.SolverOption(fused_kernels=fused, **skw))
    return j, t


def _scene():
    return mt.make_synthetic_bal(num_cameras=8, num_points=120,
                                 obs_per_point=3.5, seed=3)


@functools.lru_cache(maxsize=None)
def _jax_solve(kind, mode):
    s = _scene()
    jopt, _ = _options(kind, mode)
    return j_flat_solve(j_engine(mode=jc.JacobianMode[mode]), s.cameras0,
                        s.points0, s.obs, s.cam_idx, s.pt_idx, jopt)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_autodiff_flat_solve_matches_jax(kind, fused):
    s = _scene()
    _, topt = _options(kind, "AUTODIFF", fused=fused)
    tres = mt.flat_solve(None,
                         s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
                         topt, device="cpu")
    jres = _jax_solve(kind, "AUTODIFF")
    assert int(jres.iterations) > 1
    _compare(jres, tres, cost_rtol=1e-9)


@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_autodiff_forward_flat_solve_matches_jax(kind):
    s = _scene()
    _, topt = _options(kind, "AUTODIFF_FORWARD", fused=kind == "EXPLICIT")
    tres = mt.flat_solve(None,
                         s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
                         topt, device="cpu")
    _compare(_jax_solve(kind, "AUTODIFF_FORWARD"), tres, cost_rtol=1e-9)


def test_solve_bal_default_option_matches_jax():
    """`solve_bal(bal)` with no option: the reference's default solve,
    ProblemOption() (float64, IMPLICIT, JACOBI/HPP, AUTODIFF)."""
    s = mt.make_synthetic_bal(num_cameras=8, num_points=120,
                              obs_per_point=3.5, seed=3)
    arrays = dict(cameras=s.cameras0, points=s.points0, obs=s.obs,
                  cam_idx=s.cam_idx, pt_idx=s.pt_idx)
    jbal, jres = j_solve_bal(JBALFile(**arrays))
    tbal, tres = mt.solve_bal(mt.BALFile(**arrays), device="cpu")
    assert mt.ProblemOption().jacobian_mode == mt.JacobianMode.AUTODIFF
    assert tres.cameras.dtype == torch.float64
    assert int(jres.iterations) > 1 and int(jres.accepted) > 1
    _compare(jres, tres, cost_rtol=1e-9)
    np.testing.assert_allclose(tbal.cameras, jbal.cameras, rtol=1e-7,
                               atol=1e-9)

"""The port's robust losses vs the JAX package.

- `rho_and_weight` and `robustify` (HUBER, CAUCHY and NONE) against JAX's
  at float64, rtol 1e-14, over squared norms from 0 through the Huber
  threshold to far outliers;
- `flat_solve` with HUBER and CAUCHY (`robust_delta=1.0`) on IMPLICIT
  and EXPLICIT, unfused and fused, on a scene with gross outliers,
  against the JAX package's unfused float64 solve: trial costs (Sum rho)
  at rtol 1e-9, equal accept patterns and LM / PCG counts.

CPU only.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import megba_tpu.common as jc
from megba_tpu.ops import robust as jrobust
from megba_tpu.ops.residuals import make_residual_jacobian_fn as j_engine
from megba_tpu.solve import flat_solve as j_flat_solve

import megba_tpu_torch as mt

from test_torch_solve import _compare

KINDS = ["NONE", "HUBER", "CAUCHY"]


def _squared_norms(delta):
    rng = np.random.default_rng(0)
    d2 = delta * delta
    return np.concatenate([
        [0.0, 1e-40, 1e-30, d2, d2 * (1 - 1e-15), d2 * (1 + 1e-15)],
        d2 * rng.random(50), d2 * np.exp(rng.uniform(0, 20, 50))])


@pytest.mark.parametrize("delta", [1.0, 0.37, 25.0])
@pytest.mark.parametrize("kind", KINDS)
def test_rho_and_weight_matches_jax(kind, delta):
    s = _squared_norms(delta)
    jrho, jw = jrobust.rho_and_weight(jnp.asarray(s), jrobust.RobustKind[kind],
                                      delta)
    rho, w = mt.rho_and_weight(torch.from_numpy(s), mt.RobustKind[kind],
                               delta)
    np.testing.assert_allclose(rho.numpy(), np.asarray(jrho), rtol=1e-14,
                               atol=0)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-14, atol=0)
    assert (w.numpy() <= 1.0).all() and np.isfinite(w.numpy()).all()


@pytest.mark.parametrize("kind", KINDS)
def test_robustify_matches_jax(kind):
    rng = np.random.default_rng(1)
    n = 300
    r = rng.standard_normal((2, n)) * np.exp(rng.uniform(-3, 4, n))
    Jc, Jp = rng.standard_normal((18, n)), rng.standard_normal((6, n))
    want = jrobust.robustify(jnp.asarray(r), jnp.asarray(Jc), jnp.asarray(Jp),
                             jrobust.RobustKind[kind], 1.5)
    got = mt.robustify(torch.from_numpy(r), torch.from_numpy(Jc),
                       torch.from_numpy(Jp), mt.RobustKind[kind], 1.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14,
                                   atol=0)


def test_robust_delta_must_be_positive():
    with pytest.raises(ValueError, match="robust_delta"):
        mt.ProblemOption(robust_kind=mt.RobustKind.HUBER, robust_delta=0.0)


def _outlier_scene():
    """The 8-camera parity scene with 5 % of the observations thrown
    10-60 pixels off: gross outliers the losses must down-weight."""
    s = mt.make_synthetic_bal(num_cameras=8, num_points=120,
                              obs_per_point=3.5, seed=3)
    rng = np.random.default_rng(3)
    obs = s.obs.copy()
    bad = rng.random(obs.shape[0]) < 0.05
    obs[bad] += rng.uniform(10, 60, (int(bad.sum()), 2)) * rng.choice(
        [-1, 1], (int(bad.sum()), 2))
    assert bad.sum() > 5
    return (s.cameras0, s.points0, obs, s.cam_idx, s.pt_idx)


def _options(kind, loss, fused=False):
    kw = dict(max_iter=8, epsilon1=1e-12, epsilon2=1e-15)
    skw = dict(max_iter=30, tol=1e-10, refuse_ratio=1e30)
    j = jc.ProblemOption(
        jacobian_mode=jc.JacobianMode.ANALYTICAL,
        compute_kind=jc.ComputeKind[kind],
        robust_kind=jrobust.RobustKind[loss], robust_delta=1.0, algo_option=jc.AlgoOption(**kw),
        solver_option=jc.SolverOption(**skw))
    t = mt.ProblemOption(
        jacobian_mode=mt.JacobianMode.ANALYTICAL,
        compute_kind=mt.ComputeKind[kind], robust_kind=mt.RobustKind[loss],
        robust_delta=1.0, algo_option=mt.AlgoOption(**kw),
        solver_option=mt.SolverOption(fused_kernels=fused, **skw))
    return j, t


@functools.lru_cache(maxsize=None)
def _jax_solve(kind, loss):
    jopt, _ = _options(kind, loss)
    return j_flat_solve(j_engine(mode=jc.JacobianMode.ANALYTICAL),
                        *_outlier_scene(), jopt)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
@pytest.mark.parametrize("loss", ["HUBER", "CAUCHY"])
def test_robust_flat_solve_matches_jax(loss, kind, fused):
    _, topt = _options(kind, loss, fused)
    tres = mt.flat_solve(*_outlier_scene(), topt, device="cpu")
    jres = _jax_solve(kind, loss)
    assert int(jres.iterations) > 1 and int(jres.accepted) > 1
    _compare(jres, tres, cost_rtol=1e-9)
    # The cost is Sum rho: below the squared cost of the same residuals.
    plain = dataclasses.replace(topt, robust_kind=mt.RobustKind.NONE,
                                algo_option=mt.AlgoOption(max_iter=1))
    c_plain = float(mt.flat_solve(*_outlier_scene(), plain,
                                  device="cpu").initial_cost)
    assert float(tres.initial_cost) < c_plain

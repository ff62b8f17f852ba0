"""Port residual engine vs the JAX package at float64: the analytical
r/Jc/Jp, the cost-only residual, the geometry helpers and sqrt-info
weighting.  CPU only."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megba_tpu.ops import geo as jgeo
from megba_tpu.ops.residuals import apply_sqrt_info as j_apply_sqrt_info
from megba_tpu.ops.residuals import bal_residual as j_bal_residual
from megba_tpu.ops.residuals import bal_residual_jacobian_analytical_fm as j_fm

from megba_tpu_torch.io.synthetic import make_synthetic_bal
from megba_tpu_torch.ops import geo
from megba_tpu_torch.ops.residuals import (
    apply_sqrt_info,
    bal_residual,
    bal_residual_analytical_fm,
    bal_residual_jacobian_analytical_fm,
)

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)


def _edges(seed, small_angle=False):
    s = make_synthetic_bal(num_cameras=7, num_points=60, obs_per_point=3,
                           seed=seed)
    cam = s.cameras0[s.cam_idx].T.copy()
    if small_angle:
        # Exercise both sides of the small-angle guard: exact zero, below
        # and just above the 1e-12 threshold on theta^2.
        cam[0:3, 0::3] = 0.0
        cam[0:3, 1::3] = 3e-7
        cam[0:3, 2::3] = 1e-5
    return cam, s.points0[s.pt_idx].T.copy(), s.obs.T.copy()


@pytest.mark.parametrize("seed,small", [(0, False), (1, False), (2, True)])
def test_analytical_engine_matches_f64(seed, small):
    cam, pt, obs = _edges(seed, small)
    ref = j_fm(jnp.asarray(cam), jnp.asarray(pt), jnp.asarray(obs))
    got = bal_residual_jacobian_analytical_fm(
        torch.from_numpy(cam), torch.from_numpy(pt), torch.from_numpy(obs))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12)
    r_only = bal_residual_analytical_fm(
        torch.from_numpy(cam), torch.from_numpy(pt), torch.from_numpy(obs))
    assert torch.equal(r_only, got[0])


@pytest.mark.parametrize("small", [False, True])
def test_bal_residual_matches(small):
    cam, pt, obs = _edges(3, small)
    ref = jax.vmap(j_bal_residual, in_axes=(-1, -1, -1), out_axes=-1)(
        jnp.asarray(cam), jnp.asarray(pt), jnp.asarray(obs))
    got = bal_residual(torch.from_numpy(cam), torch.from_numpy(pt),
                       torch.from_numpy(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-10)
    # The Rodrigues residual and the analytical engine's agree.
    r2 = bal_residual_analytical_fm(torch.from_numpy(cam),
                                    torch.from_numpy(pt),
                                    torch.from_numpy(obs))
    np.testing.assert_allclose(got.numpy(), r2.numpy(), rtol=1e-9,
                               atol=1e-9)


def test_geo_helpers_match():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 20)) * 0.3
    w[:, 0] = 0.0
    w[:, 1] = 1e-8
    x = rng.standard_normal((3, 20))
    ref = jax.vmap(jgeo.angle_axis_rotate_point, in_axes=(-1, -1),
                   out_axes=-1)(jnp.asarray(w), jnp.asarray(x))
    got = geo.angle_axis_rotate_point(torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13,
                               atol=1e-15)
    p = rng.standard_normal((2, 20)) * 0.1
    f, k1, k2 = 500.0, 1e-2, 1e-4
    ref = jax.vmap(lambda q: jgeo.radial_distortion(q, f, k1, k2),
                   in_axes=-1, out_axes=-1)(jnp.asarray(p))
    got = geo.radial_distortion(torch.from_numpy(p), f, k1, k2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-14)


def test_apply_sqrt_info_matches():
    cam, pt, obs = _edges(5)
    r, Jc, Jp = j_fm(jnp.asarray(cam), jnp.asarray(pt), jnp.asarray(obs))
    rng = np.random.default_rng(6)
    L = np.tril(rng.standard_normal((cam.shape[1], 2, 2))) + 2 * np.eye(2)
    si = L.reshape(-1, 4).T.copy()
    ref = j_apply_sqrt_info(r, Jc, Jp, jnp.asarray(si))
    got = apply_sqrt_info(*(torch.from_numpy(np.array(a)) for a in (r, Jc, Jp)),
                          torch.from_numpy(si))
    for g, e in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-13,
                                   atol=1e-12)

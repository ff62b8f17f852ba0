"""Port Schur system build and Schur PCG vs the JAX package at float64.

The same synthetic scene (with an unobserved camera and point, and fixed
vertices) goes through each package's residual engine, weighting and
`build_schur_system`; the port plans its edges into CSR segment orders,
the JAX package takes its float64 unplanned path.  Then both run
`schur_pcg_solve` on their systems: dx at rtol 1e-8 and equal PCG
iteration counts.  CPU only.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megba_tpu.core import fm as jfm
from megba_tpu.linear_system import builder as jb
from megba_tpu.ops.residuals import bal_residual_jacobian_analytical_fm as jeng
from megba_tpu.solver import pcg as jpcg
from megba_tpu.solver import precond as jprecond

from megba_tpu_torch.core import fm as tfm
from megba_tpu_torch.io.synthetic import make_synthetic_bal
from megba_tpu_torch.linear_system import builder as tb
from megba_tpu_torch.ops import segtiles as tseg
from megba_tpu_torch.parallel.mesh import one_shard
from megba_tpu_torch.ops.residuals import (
    bal_residual_jacobian_analytical_fm as teng)
from megba_tpu_torch.solver import pcg as tpcg
from megba_tpu_torch.solver import precond as tprecond

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)


def _scene(seed, fixed):
    """A scene with one unobserved camera and point appended (empty
    Hessian blocks) and, optionally, fixed vertices."""
    s = make_synthetic_bal(num_cameras=6, num_points=50, obs_per_point=3.5,
                           seed=seed)
    cams = np.concatenate([s.cameras0, s.cameras0[:1] + 0.01])
    pts = np.concatenate([s.points0, s.points0[:1] + 0.01])
    nc, npt = cams.shape[0], pts.shape[0]
    cam_fixed = pt_fixed = None
    if fixed:
        cam_fixed = np.zeros(nc, bool)
        cam_fixed[0] = True
        pt_fixed = np.zeros(npt, bool)
        pt_fixed[[3, 7]] = True
    rng = np.random.default_rng(seed)
    mask = (rng.random(s.obs.shape[0]) > 0.1).astype(np.float64)
    return s, cams, pts, mask, cam_fixed, pt_fixed


def one(x):
    """One device's edge rows as the per-shard tuple of a one-shard mesh
    (parallel.mesh.one_shard); None stays None."""
    return None if x is None else (x,)


def _systems(seed, fixed):
    s, cams, pts, mask, cf, pf = _scene(seed, fixed)
    nc, npt = cams.shape[0], pts.shape[0]

    # JAX: caller edge order, unplanned float64 path.
    ci, pi = jnp.asarray(s.cam_idx), jnp.asarray(s.pt_idx)
    jcf = None if cf is None else jnp.asarray(cf)
    jpf = None if pf is None else jnp.asarray(pf)
    r, Jc, Jp = jeng(jnp.take(jnp.asarray(cams.T), ci, axis=1),
                     jnp.take(jnp.asarray(pts.T), pi, axis=1),
                     jnp.asarray(s.obs.T))
    r, Jc, Jp = jb.weight_system_inputs(r, Jc, Jp, ci, pi, jnp.asarray(mask),
                                        None, jcf, jpf)
    jsys = jb.build_schur_system(r, Jc, Jp, ci, pi, nc, npt, cam_fixed=jcf,
                                 pt_fixed=jpf)
    jax_side = (jsys, Jc, Jp, ci, pi)

    # Port: camera-slot edge order, Jp carried in point-slot order.
    plan_c, plans = tseg.make_dual_plans(s.cam_idx, s.pt_idx, nc, npt, "cpu")
    perm = plan_c.perm
    tci = plans.cam.seg.long()
    tpi = torch.from_numpy(s.pt_idx[perm].astype(np.int64))
    tcf = None if cf is None else torch.from_numpy(cf)
    tpf = None if pf is None else torch.from_numpy(pf)
    r, Jc, Jp = teng(torch.from_numpy(cams.T.copy()).index_select(1, tci),
                     torch.from_numpy(pts.T.copy()).index_select(1, tpi),
                     torch.from_numpy(s.obs[perm].T.copy()))
    r, Jc, Jp = tb.weight_system_inputs(
        r, Jc, Jp, tci, tpi, torch.from_numpy(mask[perm]), None, tcf, tpf)
    Jp = plans.to_pt(Jp)
    # One device: the mesh of one shard, its rows 1-tuples.
    tsys = tb.build_schur_system((r,), (Jc,), (Jp,), one_shard(plans), nc,
                                 npt, tcf, tpf)
    return jax_side, (tsys, Jc, Jp, plans)


@pytest.mark.parametrize("seed,fixed", [(0, False), (1, True)])
def test_build_schur_system_matches_jax(seed, fixed):
    (jsys, *_), (tsys, *_) = _systems(seed, fixed)
    for name in ("Hpp", "Hll", "g_cam", "g_pt"):
        ref = np.asarray(getattr(jsys, name))
        got = getattr(tsys, name).numpy()
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=1e-10,
                                   atol=1e-10 * np.abs(ref).max(), err_msg=name)
    # The unobserved camera and point get identity blocks, zero gradient.
    np.testing.assert_array_equal(tsys.Hpp[-1].numpy(), np.eye(9))
    np.testing.assert_array_equal(tsys.Hll[:, -1].numpy(),
                                  np.eye(3).reshape(-1))
    assert not tsys.g_cam[:, -1].any() and not tsys.g_pt[:, -1].any()


@pytest.mark.parametrize("seed,fixed,tol,refuse,rel", [
    (0, False, 1e-10, 1e30, False),   # the venice solver options
    (1, True, 1e-10, 1e30, False),
    (2, False, 1e-6, 1.0, True),      # relative tol, refuse-ratio restore
])
def test_schur_pcg_solve_matches_jax(seed, fixed, tol, refuse, rel):
    (jsys, jJc, jJp, ci, pi), (tsys, tJc, tJp, plans) = _systems(seed, fixed)
    for region in (1e3, 0.5):
        kw = dict(max_iter=30, tol=tol, refuse_ratio=refuse, tol_relative=rel)
        ref = jpcg.schur_pcg_solve(jsys, jJc, jJp, ci, pi,
                                   jnp.asarray(region), **kw)
        got = tpcg.schur_pcg_solve(tsys, (tJc,), (tJp,), one_shard(plans),
                                   torch.tensor(region, dtype=torch.float64),
                                   **kw)
        assert got.iterations == int(ref.iterations)
        for name in ("dx_cam", "dx_pt"):
            r = np.asarray(getattr(ref, name))
            np.testing.assert_allclose(getattr(got, name).numpy(), r,
                                       rtol=1e-8, atol=1e-8 * np.abs(r).max(),
                                       err_msg=f"{name} at region {region}")
        np.testing.assert_allclose(float(got.rho), float(ref.rho), rtol=1e-6,
                                   atol=1e-300)


def test_block_helpers_match_jax():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((20, 9, 9))
    H = A @ A.transpose(0, 2, 1) + 9 * np.eye(9)
    np.testing.assert_allclose(
        tprecond.block_inv(torch.from_numpy(H)).numpy(),
        np.asarray(jprecond.block_inv(jnp.asarray(H))), rtol=1e-10)
    x = rng.standard_normal((9, 20))
    np.testing.assert_allclose(
        tprecond.cam_block_matvec(torch.from_numpy(H),
                                  torch.from_numpy(x)).numpy(),
        np.asarray(jprecond.cam_block_matvec(jnp.asarray(H), jnp.asarray(x))),
        rtol=1e-12)
    f64 = torch.float64
    np.testing.assert_allclose(
        tb.damp_blocks(torch.from_numpy(H), torch.tensor(0.3, dtype=f64)),
        np.asarray(jb.damp_blocks(jnp.asarray(H), jnp.asarray(0.3))),
        rtol=1e-14)
    B = rng.standard_normal((20, 3, 3))
    Hr = (B @ B.transpose(0, 2, 1) + 3 * np.eye(3)).reshape(20, 9).T.copy()
    got = tfm.block_inv_fm(tfm.damp_rows_fm(torch.from_numpy(Hr),
                                            torch.tensor(2.0, dtype=f64)))
    ref = jfm.block_inv_fm(jfm.damp_rows_fm(jnp.asarray(Hr),
                                            jnp.asarray(2.0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)

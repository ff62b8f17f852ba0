"""The port's whole slice vs the JAX package: `flat_solve` / `solve_bal`.

float64: the same scene and options through both packages' `flat_solve`
(ANALYTICAL Jacobians, IMPLICIT Schur, JACOBI preconditioner): the
per-iteration trial costs agree at rtol 1e-9, and the accept pattern, LM
iterations and PCG totals are equal.  float32: against the JAX tiled
lowering (its Pallas kernels' XLA fallbacks) at rtol 1e-4 on cost.  Also
the device contract of the entry points and of chip_smoke.py.  CPU only.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import megba_tpu.common as jc
from megba_tpu.io.bal import load_bal as j_load_bal
from megba_tpu.ops.residuals import make_residual_jacobian_fn
from megba_tpu.solve import flat_solve as j_flat_solve
from megba_tpu.solve import solve_bal as j_solve_bal

import megba_tpu_torch as mt
from megba_tpu_torch.convert import result_to_numpy, to_torch

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _options(dtype, max_iter, tol=1e-10, refuse=1e30):
    kw = dict(max_iter=max_iter, epsilon1=1e-12, epsilon2=1e-15)
    skw = dict(max_iter=30, tol=tol, refuse_ratio=refuse)
    j = jc.ProblemOption(
        dtype=dtype, jacobian_mode=jc.JacobianMode.ANALYTICAL,
        compute_kind=jc.ComputeKind.IMPLICIT,
        algo_option=jc.AlgoOption(**kw), solver_option=jc.SolverOption(**skw))
    t = mt.ProblemOption(
        dtype=dtype, jacobian_mode=mt.JacobianMode.ANALYTICAL,
        compute_kind=mt.ComputeKind.IMPLICIT,
        algo_option=mt.AlgoOption(**kw), solver_option=mt.SolverOption(**skw))
    return j, t


def _compare(jres, tres, cost_rtol):
    t = result_to_numpy(tres)
    k = int(jres.iterations)
    assert t["iterations"] == k
    assert t["accepted"] == int(jres.accepted)
    assert t["pcg_iterations"] == int(jres.pcg_iterations)
    assert t["status"] == int(jres.status)
    jtr = jres.trace
    np.testing.assert_array_equal(t["trace"]["accept"],
                                  np.asarray(jtr.accept)[:k])
    np.testing.assert_array_equal(t["trace"]["pcg_iters"],
                                  np.asarray(jtr.pcg_iters)[:k])
    np.testing.assert_allclose(t["trace"]["cost"], np.asarray(jtr.cost)[:k],
                               rtol=cost_rtol)
    np.testing.assert_allclose(t["cost"], float(jres.cost), rtol=cost_rtol)
    np.testing.assert_allclose(t["initial_cost"], float(jres.initial_cost),
                               rtol=cost_rtol)
    return t


@pytest.mark.parametrize("case", ["plain", "masked_fixed_weighted"])
def test_flat_solve_matches_jax_f64(case):
    s = mt.make_synthetic_bal(num_cameras=8, num_points=120,
                              obs_per_point=3.5, seed=3)
    jopt, topt = _options(np.float64, max_iter=8)
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
    jres = j_flat_solve(make_residual_jacobian_fn(
        mode=jc.JacobianMode.ANALYTICAL), *args, jopt, **extra)
    tres = mt.flat_solve(None, *args, topt, device="cpu", **extra)
    t = _compare(jres, tres, cost_rtol=1e-9)
    assert t["cameras"].shape == (8, 9) and t["points"].shape == (120, 3)
    if case != "plain":
        # Fixed vertices do not move.
        np.testing.assert_array_equal(t["cameras"][:2], s.cameras0[:2])
        np.testing.assert_array_equal(t["points"][5], s.points0[5])


def test_flat_solve_matches_jax_tiled_f32():
    s = mt.make_synthetic_bal(num_cameras=8, num_points=120,
                              obs_per_point=3.5, seed=1, dtype=np.float32)
    jopt, topt = _options(np.float32, max_iter=6)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    jres = j_flat_solve(make_residual_jacobian_fn(
        mode=jc.JacobianMode.ANALYTICAL), *args, jopt, use_tiled=True)
    tres = mt.flat_solve(None, *args, topt, device="cpu")
    assert tres.cameras.dtype == torch.float32
    k = int(jres.iterations)
    # Near the optimum the trial costs differ by f32 rounding, where an
    # accept decision may go either way: the costs are what is compared.
    assert tres.iterations == k
    np.testing.assert_allclose(tres.trace.cost[:k].numpy(),
                               np.asarray(jres.trace.cost)[:k], rtol=1e-4)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-4)


def test_solve_bal_matches_jax(tmp_path):
    s = mt.make_synthetic_bal(num_cameras=6, num_points=80, obs_per_point=3,
                              seed=5)
    path = tmp_path / "scene.txt"
    mt.save_bal(path, mt.BALFile(cameras=s.cameras0, points=s.points0,
                                 obs=s.obs, cam_idx=s.cam_idx,
                                 pt_idx=s.pt_idx))
    jopt, topt = _options(np.float64, max_iter=5, tol=1e-1, refuse=1.0)
    jbal, jres = j_solve_bal(j_load_bal(path), jopt)
    tbal, tres = mt.solve_bal(str(path), topt, device="cpu")
    _compare(jres, tres, cost_rtol=1e-9)
    np.testing.assert_array_equal(tbal.obs, jbal.obs)
    np.testing.assert_array_equal(tbal.cam_idx, jbal.cam_idx)
    np.testing.assert_allclose(tbal.cameras, jbal.cameras, rtol=1e-7,
                               atol=1e-9)


def test_convert_roundtrip():
    s = mt.make_synthetic_bal(num_cameras=4, num_points=24, seed=0)
    si = np.tile(np.eye(2), (s.obs.shape[0], 1, 1))
    t = to_torch(s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx, si,
                 device="cpu", dtype=torch.float32)
    assert t["cameras"].shape == (9, 4) and t["cameras"].is_contiguous()
    assert t["sqrt_info"].shape == (4, s.obs.shape[0])
    assert t["cam_idx"].dtype == torch.int64
    fm = to_torch(s.cameras0.T, s.points0.T, s.obs.T, s.cam_idx, s.pt_idx,
                  device="cpu", feature_major=True)
    np.testing.assert_array_equal(fm["points"].numpy(), s.points0.T)
    with pytest.raises(ValueError, match="feature rows"):
        to_torch(s.cameras0[:, :8], s.points0, s.obs, s.cam_idx, s.pt_idx,
                 device="cpu")


def test_entry_points_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = mt.make_synthetic_bal(num_cameras=4, num_points=24, seed=0)
    _, topt = _options(np.float64, max_iter=2)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx, topt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.flat_solve(None, *args)
    bal = mt.BALFile(cameras=s.cameras0, points=s.points0, obs=s.obs,
                     cam_idx=s.cam_idx, pt_idx=s.pt_idx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.solve_bal(bal, topt)
    assert mt.flat_solve(None, *args, device="cpu").iterations >= 1


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    script = REPO / "chip_smoke.py"
    text = script.read_text()
    assert "import jax" not in text and "megba_tpu." not in text
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(script, lone)
    for path, cwd in ((script, REPO), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(path)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0, out.stdout
        assert '"ok"' not in out.stdout

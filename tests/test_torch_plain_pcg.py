"""The plain full-system PCG (`use_schur=False`) in the port vs the JAX
package, float64.

- `plain_pcg_solve` on IMPLICIT and EXPLICIT systems (the JAX system and
  Jacobian rows carried across, so both solve the same numbers) against
  JAX's at rtol 1e-12, and against the JAX package's dense direct solve
  (`solver/dense.dense_reference_solve`);
- `flat_solve(use_schur=False)` against JAX's at rtol 1e-9 (trial costs,
  accept pattern, counts), plain and with forcing and warm starts (the
  (camera, point) pair carry);
- the plain solve against the Schur solve: the same final cost (rtol
  1e-6), as tests/test_plain_solver.py;
- the plain-mode validation cases of tests/test_plain_solver.py.

CPU only.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import megba_tpu.common as jc
from megba_tpu.solver import pcg as jpcg
from megba_tpu.solver.dense import dense_reference_solve

import megba_tpu_torch as mt
from megba_tpu_torch.convert import schur_system_to_torch
from megba_tpu_torch.ops import segtiles as tseg
from megba_tpu_torch.parallel.mesh import one_shard
from megba_tpu_torch.solver import pcg as tpcg

from tests.test_solver import build_test_system
from test_torch_explicit import _explicit_systems
from test_torch_guards import _args, _jax_solve, _options, _scene
from test_torch_guards import compare_robust
from test_torch_schur import _systems

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)


def _carry(jsys, jJc, jJp, ci, pi):
    """The same numbers in the port's layout: cam-slot edge order, Jp in
    point-slot order."""
    plan_c, plans = tseg.make_dual_plans(
        np.asarray(ci), np.asarray(pi), jsys.Hpp.shape[0], jsys.Hll.shape[1],
        "cpu")
    order = plan_c.perm
    tsys = schur_system_to_torch(jsys, device="cpu", edge_perm=order)
    tJc = torch.from_numpy(np.ascontiguousarray(np.asarray(jJc)[:, order]))
    tJp = plans.to_pt(torch.from_numpy(
        np.ascontiguousarray(np.asarray(jJp)[:, order])))
    return tsys, tJc, tJp, plans


def _carried(kind, seed):
    """A JAX system with its Jacobian rows (the scenes of
    test_torch_schur.py / test_torch_explicit.py), and the port's copy."""
    if kind == "IMPLICIT":
        jax_side, _ = _systems(seed, seed == 1)
    else:
        jax_side, _ = _explicit_systems(seed, seed == 1)
    return jax_side, _carry(*jax_side)


@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_pcg_solve_matches_jax(kind, seed):
    (jsys, jJc, jJp, ci, pi), (tsys, tJc, tJp, plans) = _carried(kind, seed)
    for region in (1e3, 0.5):
        kw = dict(max_iter=30, tol=1e-10, refuse_ratio=1e30)
        ref = jpcg.plain_pcg_solve(jsys, jJc, jJp, ci, pi,
                                   jnp.asarray(region),
                                   compute_kind=jc.ComputeKind[kind], **kw)
        got = tpcg.plain_pcg_solve(tsys, (tJc,), (tJp,), one_shard(plans),
                                   torch.tensor(region, dtype=torch.float64),
                                   compute_kind=mt.ComputeKind[kind], **kw)
        assert got.iterations == int(ref.iterations)
        for name in ("dx_cam", "dx_pt"):
            r = np.asarray(getattr(ref, name))
            np.testing.assert_allclose(getattr(got, name).numpy(), r,
                                       rtol=1e-12,
                                       atol=1e-12 * np.abs(r).max(),
                                       err_msg=f"{name} at region {region}")
        np.testing.assert_allclose(float(got.rho), float(ref.rho),
                                   rtol=1e-9, atol=1e-300)


@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_plain_pcg_matches_dense(kind):
    """The system of tests/test_plain_solver.py (3 cameras, 12 points)."""
    jsys, _, jJc, jJp, ci, pi = build_test_system(
        compute_kind=jc.ComputeKind[kind])
    tsys, tJc, tJp, plans = _carry(jsys, jJc, jJp, ci, pi)
    region = 100.0
    dx_cam, dx_pt = dense_reference_solve(jsys, jJc, jJp, ci, pi,
                                          jnp.asarray(region))
    got = tpcg.plain_pcg_solve(tsys, (tJc,), (tJp,), one_shard(plans),
                               torch.tensor(region, dtype=torch.float64),
                               max_iter=2000, tol=1e-14, tol_relative=True,
                               refuse_ratio=1e30,
                               compute_kind=mt.ComputeKind[kind])
    np.testing.assert_allclose(got.dx_cam.numpy(), np.asarray(dx_cam),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.dx_pt.numpy(), np.asarray(dx_pt),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("variant", ["plain", "forcing_warm"])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_plain_flat_solve_matches_jax(kind, variant):
    s = _scene()
    solver = (dict(tol=1e-1, forcing=True, warm_start=True)
              if variant == "forcing_warm" else {})
    jopt, topt = _options(False, kind, use_schur=False, **solver)
    jres = _jax_solve(_args(s), jopt)
    tres = mt.flat_solve(None, *_args(s), topt, device="cpu")
    t = compare_robust(jres, tres)
    assert float(tres.cost) < float(tres.initial_cost)
    if variant == "forcing_warm":
        k = t["iterations"]
        for f in ("pcg_eta", "pcg_r0_ratio"):
            np.testing.assert_allclose(
                t["trace"][f], np.asarray(getattr(jres.trace, f))[:k],
                rtol=1e-9, err_msg=f)
        assert (t["trace"]["pcg_r0_ratio"][1:] != 1.0).any()
        assert tres.dx_cam.shape == s.cameras0.shape
        np.testing.assert_allclose(tres.dx_cam.numpy(),
                                   np.asarray(jres.dx_cam), rtol=1e-6,
                                   atol=1e-9)


def test_plain_lm_converges_and_matches_schur():
    s = mt.make_synthetic_bal(num_cameras=6, num_points=40, obs_per_point=4,
                              seed=0, param_noise=4e-2, pixel_noise=0.3)

    def opt(use_schur):
        return mt.ProblemOption(
            use_schur=use_schur, jacobian_mode=mt.JacobianMode.ANALYTICAL,
            algo_option=mt.AlgoOption(max_iter=25, epsilon1=1e-9,
                                      epsilon2=1e-12),
            solver_option=mt.SolverOption(max_iter=800, tol=1e-12,
                                          tol_relative=True,
                                          refuse_ratio=1e30))

    schur = mt.flat_solve(None, *_args(s), opt(True), device="cpu")
    plain = mt.flat_solve(None, *_args(s), opt(False), device="cpu")
    np.testing.assert_allclose(float(plain.cost), float(schur.cost),
                               rtol=1e-6)
    assert plain.accepted > 0


def test_plain_mode_option_validation():
    validate = mt.common.validate_options
    validate(mt.ProblemOption(
        use_schur=False,
        linear_system_kind=mt.LinearSystemKind.BASE_LINEAR_SYSTEM))
    with pytest.raises(ValueError, match="use_schur=True requires"):
        validate(mt.ProblemOption(
            use_schur=True,
            linear_system_kind=mt.LinearSystemKind.BASE_LINEAR_SYSTEM))
    for kw, msg in (
            (dict(mixed_precision_pcg=True), "mixed_precision_pcg"),
            (dict(solver_option=mt.SolverOption(bf16=True)), "bf16"),
            (dict(solver_option=mt.SolverOption(fused_kernels=True)),
             "fused_kernels"),
            (dict(solver_option=mt.SolverOption(
                precond=mt.PrecondKind.NEUMANN)), "precond=NEUMANN")):
        with pytest.raises(ValueError, match=msg):
            validate(mt.ProblemOption(use_schur=False, dtype=np.float32,
                                      **kw))
    # The solver refuses the rungs for direct callers too.
    _, (tsys, tJc, tJp, plans) = _carried("IMPLICIT", 0)
    for kw in (dict(mixed_precision=True), dict(bf16=True)):
        with pytest.raises(NotImplementedError):
            tpcg.plain_pcg_solve(tsys, (tJc,), (tJp,), one_shard(plans),
                                 torch.tensor(10.0, dtype=torch.float64),
                                 **kw)

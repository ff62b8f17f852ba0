"""Fault containment in the port vs the JAX package (tests/test_robustness.py,
single device), float64 unless stated.

- the repair of `solver.precond.block_inv`: a block that is not positive
  definite or not finite comes out all NaN (no raise, no host read),
  healthy blocks bitwise as `torch.linalg.cholesky` gives them; a solve
  with one NaN camera parameter against JAX's, guards off and on (cost
  NaN, iteration count, status);
- guards bitwise free: the guarded port against the unguarded port
  (`torch.equal` on the trace, cameras and points) on the four kinds at
  float64 and on the mixed and bf16 rungs at float32;
- a NaN residual burst with guards off (JAX's NaN pattern, STALLED) and
  on (RECOVERED), a persistent burst (FATAL_NONFINITE after
  max_recoveries + 1 iterations) and an Hll crush (PCG breakdowns, then a
  recovery), each against JAX's solve: finite trial costs at rtol 1e-9,
  NaN at the same iterations, equal accept / recovery / pcg_breakdown
  traces, status, recoveries and LM / PCG counts; determinism;
- `_pcg_core`'s guard on a 12x12 operator, both bodies, against JAX's;
- status semantics, RobustOption validation, the fault plan's size check,
  `lower_edge_vector`, `with_offset` and the plan converter.

CPU only.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import megba_tpu.common as jc
from megba_tpu.ops.residuals import make_residual_jacobian_fn as j_engine
from megba_tpu.robustness import faults as jfaults
from megba_tpu.solve import flat_solve as j_flat_solve
from megba_tpu.solver import pcg as jpcg

import megba_tpu_torch as mt
from megba_tpu_torch.convert import fault_plan_to_torch
from megba_tpu_torch.robustness import faults as tfaults
from megba_tpu_torch.solver import pcg as tpcg
from megba_tpu_torch.solver import precond as tprecond

from test_torch_solve import _compare

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

ROBUST_FIELDS = ("recovery", "pcg_breakdown", "precond_fallback")


def _scene(dtype=np.float64):
    return mt.make_synthetic_bal(num_cameras=8, num_points=120,
                                 obs_per_point=3.5, seed=3, dtype=dtype)


def _args(s):
    return (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)


def _options(guards=True, kind="IMPLICIT", fused=False, dtype=np.float64,
             rung=None, max_iter=8, use_schur=True, **solver):
    """(JAX, port) options: the parity options of test_torch_solve.py;
    `solver` may name the port's enums (carried to JAX's by name)."""
    kw = dict(max_iter=max_iter, epsilon1=1e-12, epsilon2=1e-15,
              initial_region=1.0 if rung == "mixed" else 1e3)
    skw = dict(max_iter=30, tol=1e-10, refuse_ratio=1e30,
               bf16=rung == "bf16")
    skw.update(solver)
    jskw = {k: (getattr(jc, type(v).__name__)[v.name]
                if hasattr(v, "name") else v) for k, v in skw.items()}
    common = dict(dtype=dtype, mixed_precision_pcg=rung == "mixed",
                  use_schur=use_schur)
    j = jc.ProblemOption(
        jacobian_mode=jc.JacobianMode.ANALYTICAL,
        compute_kind=jc.ComputeKind[kind], algo_option=jc.AlgoOption(**kw),
        solver_option=jc.SolverOption(**jskw),
        robust_option=jc.RobustOption(guards=guards), **common)
    t = mt.ProblemOption(
        jacobian_mode=mt.JacobianMode.ANALYTICAL,
        compute_kind=mt.ComputeKind[kind], algo_option=mt.AlgoOption(**kw),
        solver_option=mt.SolverOption(fused_kernels=fused, **skw),
        robust_option=mt.RobustOption(guards=guards), **common)
    return j, t


def _jax_solve(args, jopt, **kw):
    return j_flat_solve(j_engine(mode=jc.JacobianMode.ANALYTICAL), *args,
                        jopt, **kw)


def compare_robust(jres, tres, cost_rtol=1e-9):
    """`_compare` (trial costs with NaN at the same iterations, accept
    pattern, counts, status) plus the robustness trace and the
    recoveries."""
    t = _compare(jres, tres, cost_rtol=cost_rtol)
    k = t["iterations"]
    for f in ROBUST_FIELDS:
        np.testing.assert_array_equal(
            t["trace"][f], np.asarray(getattr(jres.trace, f))[:k], err_msg=f)
    assert t["recoveries"] == int(jres.recoveries)
    np.testing.assert_array_equal(np.isnan(t["trace"]["cost"]),
                                  np.isnan(np.asarray(jres.trace.cost)[:k]))
    return t


def _nan_plan(n_edges):
    """Two poisoned edges covering iteration 0: the initial linearisation
    is poisoned too (tests/test_robustness.py:84-90)."""
    return jfaults.make_nan_burst(n_edges, [2, 9], start=0, stop=1)


# ---------------------------------------------------------------- repair


def test_block_inv_nans_bad_blocks_without_raising():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((5, 9, 9))
    H = A @ A.transpose(0, 2, 1) + 9 * np.eye(9)
    H[1] -= 40 * np.eye(9)  # indefinite
    H[3, 2, 4] = H[3, 4, 2] = np.nan  # not finite
    got = tprecond.block_inv(torch.from_numpy(H))
    for i in (1, 3):
        assert torch.isnan(got[i]).all(), i
    healthy = torch.from_numpy(H[[0, 2, 4]])
    chol = torch.linalg.cholesky(healthy)
    eye = torch.eye(9, dtype=torch.float64).expand(healthy.shape)
    inv_l = torch.linalg.solve_triangular(chol, eye, upper=False)
    want = torch.einsum("nki,nkj->nij", inv_l, inv_l)
    assert torch.equal(got[[0, 2, 4]], want)


@pytest.mark.parametrize("guards", [False, True], ids=["unguarded",
                                                      "guarded"])
def test_nan_camera_solve_matches_jax(guards):
    """One NaN camera parameter: the JAX package ends with cost NaN
    (STALLED unguarded, FATAL_NONFINITE guarded); the port used to raise
    from torch.linalg.cholesky on the non-finite camera block."""
    s = mt.make_synthetic_bal(6, 40, 4, seed=1)
    cams = s.cameras0.copy()
    cams[2, 4] = np.nan
    args = (cams, s.points0, s.obs, s.cam_idx, s.pt_idx)
    jopt = jc.ProblemOption(
        jacobian_mode=jc.JacobianMode.ANALYTICAL,
        algo_option=jc.AlgoOption(max_iter=4),
        robust_option=jc.RobustOption(guards=guards))
    topt = mt.ProblemOption(
        jacobian_mode=mt.JacobianMode.ANALYTICAL,
        algo_option=mt.AlgoOption(max_iter=4),
        robust_option=mt.RobustOption(guards=guards))
    jres = _jax_solve(args, jopt)
    tres = mt.flat_solve(None, *args, topt, device="cpu")
    assert np.isnan(float(jres.cost)) and np.isnan(float(tres.cost))
    assert tres.iterations == int(jres.iterations) == 4
    assert tres.status == int(jres.status) == (
        mt.SolveStatus.FATAL_NONFINITE if guards else mt.SolveStatus.STALLED)
    compare_robust(jres, tres)


# ------------------------------------------------------------------ free


_FREE_CASES = [("IMPLICIT", False, np.float64, None),
               ("EXPLICIT", False, np.float64, None),
               ("IMPLICIT", True, np.float64, None),
               ("EXPLICIT", True, np.float64, None)] + [
    (kind, fused, np.float32, rung) for rung in ("mixed", "bf16")
    for kind, fused in (("IMPLICIT", False), ("EXPLICIT", True))]


@pytest.mark.parametrize("kind,fused,dtype,rung", _FREE_CASES)
def test_clean_run_bitwise_unchanged_with_guards(kind, fused, dtype, rung):
    s = _scene(dtype)
    solver = dict(tol=1e-6, tol_relative=True) if rung == "bf16" else {}
    runs = [mt.flat_solve(None, *_args(s), _options(
        g, kind, fused, dtype, rung, max_iter=6, **solver)[1], device="cpu")
        for g in (False, True)]
    off, on = runs
    assert on.iterations == off.iterations and on.status == off.status
    assert on.recoveries == 0
    assert torch.equal(off.cameras, on.cameras)
    assert torch.equal(off.points, on.points)
    assert torch.equal(off.cost, on.cost)
    for f in dataclasses.fields(off.trace):
        assert torch.equal(getattr(off.trace, f.name),
                           getattr(on.trace, f.name)), f.name


# ------------------------------------------------------- NaN residual burst


@functools.lru_cache(maxsize=None)
def _jax_faulted(name, guards):
    s = _scene()
    jopt, _ = _options(guards)
    return _jax_solve(_args(s), jopt, fault_plan=_plans(s)[name])


def _plans(s):
    n = s.obs.shape[0]
    return {
        "nan": _nan_plan(n),
        "persistent": jfaults.make_nan_burst(n, [2], start=0, stop=10_000),
        "crush": jfaults.make_point_indefinite_burst(
            120, list(range(8)), start=2, stop=3, n_edges=n),
    }


def _port_faulted(name, guards, **kw):
    s = _scene()
    _, topt = _options(guards)
    return mt.flat_solve(None, *_args(s), topt, device="cpu",
                         fault_plan=fault_plan_to_torch(_plans(s)[name]),
                         **kw)


def test_nan_burst_poisons_unguarded_solve_as_jax():
    jres = _jax_faulted("nan", False)
    tres = _port_faulted("nan", False)
    compare_robust(jres, tres)
    assert np.isnan(float(tres.cost))
    assert tres.status == mt.SolveStatus.STALLED and tres.accepted == 0


def test_nan_burst_recovers_with_guards_as_jax():
    jres = _jax_faulted("nan", True)
    tres = _port_faulted("nan", True)
    t = compare_robust(jres, tres)
    assert tres.status == mt.SolveStatus.RECOVERED and tres.recoveries >= 1
    assert np.isfinite(float(tres.cost))
    rec = t["trace"]["recovery"]
    assert rec[:2].any() and not rec[2:].any()


def test_fault_injection_is_deterministic():
    a = _port_faulted("nan", True)
    b = _port_faulted("nan", True)
    assert torch.equal(a.cameras, b.cameras)
    assert torch.equal(a.points, b.points)
    assert float(a.cost) == float(b.cost)


def test_fatal_after_max_recoveries_as_jax():
    jres = _jax_faulted("persistent", True)
    tres = _port_faulted("persistent", True)
    compare_robust(jres, tres)
    assert tres.status == mt.SolveStatus.FATAL_NONFINITE
    assert tres.iterations == mt.RobustOption().max_recoveries + 1
    assert tres.stopped


def test_indefinite_fault_triggers_pcg_breakdown_as_jax():
    jres = _jax_faulted("crush", True)
    tres = _port_faulted("crush", True)
    t = compare_robust(jres, tres)
    assert t["trace"]["pcg_breakdown"].sum() >= 1
    assert t["trace"]["recovery"].any()
    assert tres.status == mt.SolveStatus.RECOVERED


def test_closed_window_is_the_clean_solve():
    s = _scene()
    _, topt = _options(True)
    clean = mt.flat_solve(None, *_args(s), topt, device="cpu")
    closed = mt.flat_solve(None,
        *_args(s), topt, device="cpu", fault_plan=tfaults.close_fault_window(
            fault_plan_to_torch(_plans(s)["nan"])))
    assert torch.equal(clean.trace.cost, closed.trace.cost)
    assert torch.equal(clean.cameras, closed.cameras)


# ------------------------------------------------------------ PCG guard


def _ops12(kind):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((12, 12))
    M = {"spd": a @ a.T + 12 * np.eye(12),
         "indefinite": a @ a.T - 30 * np.eye(12),
         "nan": np.where(np.arange(144).reshape(12, 12) == 5, np.nan,
                         a @ a.T + 12 * np.eye(12))}[kind]
    return M, rng.standard_normal(12)


@pytest.mark.parametrize("fused", [True, False], ids=["cg", "classic"])
@pytest.mark.parametrize("kind", ["spd", "indefinite", "nan"])
def test_pcg_core_guard_matches_jax(kind, fused):
    """SPD: the guarded body is bitwise the unguarded one.  Indefinite:
    the Chronopoulos-Gear body restarts twice and exits broken; the
    textbook body stalls on the finite sign flip and keeps its best
    iterate.  NaN: both bodies take the breakdown ladder."""
    M, b = _ops12(kind)
    Mt, bt = torch.from_numpy(M), torch.from_numpy(b)

    def port(guard):
        return tpcg._pcg_core(lambda x: Mt @ x, lambda r: r, bt, 50, 1e-12,
                              1e30, False, fused=fused, guard=guard,
                              max_restarts=2)

    jx, jk, jrho, _, jre, jbr = jpcg._pcg_core(
        lambda x: jnp.asarray(M) @ x, lambda r: r, jnp.asarray(b), 50, 1e-12,
        1e30, False, guard=True, max_restarts=2, fused=fused)
    x1, k1, rho1, _, re1, br1 = port(True)
    assert k1 == int(jk) and int(re1) == int(jre) and bool(br1) == bool(jbr)
    np.testing.assert_allclose(x1.numpy(), np.asarray(jx), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(float(rho1), float(jrho), rtol=1e-6,
                               atol=1e-20)
    if kind == "spd":
        x0, k0, rho0, _, re0, br0 = port(False)
        assert torch.equal(x0, x1) and k0 == k1 and torch.equal(rho0, rho1)
        assert int(re1) == 0 and not bool(br1) and (re0, br0) == (0, False)
    if kind == "indefinite" and fused:
        assert bool(br1) and int(re1) == 2


def test_pcg_core_guard_keeps_one_product_and_one_apply_per_iteration():
    M, b = _ops12("indefinite")
    Mt, bt = torch.from_numpy(M), torch.from_numpy(b)
    for fused, prime in ((True, 1), (False, 0)):
        counts = {"A": 0, "M": 0}

        def matvec(v):
            counts["A"] += 1
            return Mt @ v

        def precond(r):
            counts["M"] += 1
            return r

        _, k, *_ = tpcg._pcg_core(matvec, precond, bt, 50, 1e-12, 1e30,
                                  False, fused=fused, guard=True,
                                  max_restarts=2)
        assert counts == {"A": k + prime, "M": k + 1}


# ------------------------------------------------------------ semantics


def test_status_consistent_with_stop_flag():
    s = _scene()
    for guards in (False, True):
        res = mt.flat_solve(None, *_args(s), _options(guards)[1], device="cpu")
        want = (mt.SolveStatus.CONVERGED if res.stopped
                else (mt.SolveStatus.MAX_ITER if res.accepted > 0
                      else mt.SolveStatus.STALLED))
        assert res.status == want and res.recoveries == 0


def test_robust_option_validation():
    base = mt.ProblemOption()
    for kw, msg in ((dict(max_recoveries=0), "max_recoveries"),
                    (dict(damping_inflation=1.0), "damping_inflation"),
                    (dict(pcg_max_restarts=-1), "pcg_max_restarts")):
        opt = dataclasses.replace(base,
                                  robust_option=mt.RobustOption(**kw))
        with pytest.raises(ValueError, match=msg):
            mt.common.validate_options(opt)
        with pytest.raises(ValueError, match=msg):
            jc.validate_options(dataclasses.replace(
                jc.ProblemOption(), robust_option=jc.RobustOption(**kw)))


def test_fault_plan_size_mismatch_rejected():
    s = _scene()
    plan = mt.make_nan_burst(3, [0], start=0, stop=1)
    with pytest.raises(ValueError, match="edge_nan"):
        mt.flat_solve(None, *_args(s), _options(False)[1], device="cpu",
                      fault_plan=plan)


def test_lower_edge_vector_matches_jax():
    vec = np.array([np.nan, 0.0, np.nan, 0.0])
    perm = np.array([2, 0, 1, 3, 0, 0])  # padded perm reuses real rows
    mask = np.array([1.0, 1.0, 1.0, 1.0, 0.0, 0.0])
    out = tfaults.lower_edge_vector(vec, perm, mask, n_padded=8)
    np.testing.assert_array_equal(
        out, jfaults.lower_edge_vector(vec, perm, mask, n_padded=8))
    assert out.shape == (8,) and np.isnan(out[:2]).all()
    assert (out[3:] == 0).all()


def test_fault_plans_match_jax_and_slide():
    jplan = jfaults.make_nan_burst(6, [1, 4], start=3, stop=5, n_points=2)
    tplan = mt.make_nan_burst(6, [1, 4], start=3, stop=5, n_points=2)
    conv = fault_plan_to_torch(jplan)
    for p in (tplan, conv):
        np.testing.assert_array_equal(p.edge_nan.numpy(),
                                      np.asarray(jplan.edge_nan))
        np.testing.assert_array_equal(p.point_crush.numpy(),
                                      np.asarray(jplan.point_crush))
        assert p.window == (3, 5) and p.offset == 0
    moved = tfaults.with_offset(tplan, 3)
    assert isinstance(moved, mt.FaultPlan) and moved.offset == 3
    assert moved.window == tplan.window
    for k in range(8):
        assert tfaults.fault_active(moved, k) == bool(
            jfaults.fault_active(jfaults.with_offset(jplan, 3), k))
    crush = mt.make_point_indefinite_burst(5, [0, 3], start=0, stop=1,
                                           n_edges=4)
    jcrush = jfaults.make_point_indefinite_burst(5, [0, 3], start=0, stop=1,
                                                 n_edges=4)
    np.testing.assert_array_equal(crush.point_crush.numpy(),
                                  np.asarray(jcrush.point_crush))
    inert = tfaults.inert_fault_plan(4, 5)
    assert not any(tfaults.fault_active(inert, k) for k in range(4))

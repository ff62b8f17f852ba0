"""Inexact LM in the port vs the JAX package: Eisenstat-Walker forcing,
PCG warm starts and the LM resume hooks, float64 unless stated.

- `initial_forcing_eta` / `eisenstat_walker_eta` against JAX's on random
  device scalars, accepted and rejected steps;
- `_pcg_core` with a warm start `x0`, both bodies, against JAX's: the
  same iterate, count, final rho and r0_ratio, also when the warm start
  is worse than zero and falls back to the cold start;
- `flat_solve` with `SolverOption(tol=1e-1, forcing=True,
  warm_start=True, refuse_ratio=1e30)` (the JAX package's `INEXACT`,
  tests/test_forcing.py) on the four kinds: the trace fields `pcg_eta`
  and `pcg_r0_ratio` and the trial costs at rtol 1e-9, equal accept
  patterns and counts, and `dx_cam` edge-major;
- warm starts left bitwise equal to cold starts while every step is
  rejected (the port's copy of tests/test_forcing.py's test);
- a solve split in two through `initial_region` / `initial_v` /
  `initial_dx` against the JAX package's split;
- float32 with forcing and warm starts on the mixed rung (within 1e-4 of
  JAX's tiled solve) and the bf16 rung (within the JAX 2e-2 band).

CPU only.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import megba_tpu.common as jc
from megba_tpu.algo import lm as jlm
from megba_tpu.ops.residuals import make_residual_jacobian_fn as j_engine
from megba_tpu.solve import flat_solve as j_flat_solve
from megba_tpu.solver import pcg as jpcg

import megba_tpu_torch as mt
from megba_tpu_torch.algo import lm as tlm
from megba_tpu_torch.solver import pcg as tpcg

from test_torch_fused_implicit import _spd_operator
from test_torch_solve import _compare

INEXACT = dict(max_iter=100, tol=1e-1, refuse_ratio=1e30, forcing=True,
               warm_start=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forcing_schedule_matches_jax(seed):
    rng = np.random.default_rng(seed)
    eta_min, eta_max = 1e-6, 0.1
    j0 = jlm.initial_forcing_eta(jnp.float64(eta_min), jnp.float64(eta_max),
                                 jnp.float64)
    t0 = tlm.initial_forcing_eta(torch.tensor(eta_min, dtype=torch.float64),
                                 torch.tensor(eta_max, dtype=torch.float64))
    assert float(t0) == float(j0)
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    for _ in range(40):
        eta = 10.0 ** rng.uniform(-6, -1)
        c_prev = 10.0 ** rng.uniform(0, 3)
        c_new = c_prev * rng.uniform(0.01, 1.5)
        rho = rng.uniform(-1, 1.5)
        for accept in (True, False):
            want = jlm.eisenstat_walker_eta(
                jnp.float64(eta), jnp.float64(c_new), jnp.float64(c_prev),
                jnp.float64(rho), jnp.bool_(accept), jnp.float64(eta_min),
                jnp.float64(eta_max), jnp.float64)
            got = tlm.eisenstat_walker_eta(
                f64(eta), f64(c_new), f64(c_prev), f64(rho),
                torch.tensor(accept), f64(eta_min), f64(eta_max))
            assert float(got) == float(want)
            assert eta_min <= float(got) <= eta_max


def _ops(A, d, shape):
    """(JAX, port) (matvec, precond) on one operator, [3, n/3] rows."""
    Aj, dj = jnp.asarray(A), jnp.asarray(d.reshape(shape))
    At, dt = torch.from_numpy(A), torch.from_numpy(d.reshape(shape))
    return (((lambda v: (Aj @ v.reshape(-1)).reshape(shape)),
             (lambda r: r * dj)),
            ((lambda v: (At @ v.reshape(-1)).reshape(shape)),
             (lambda r: r * dt)))


@pytest.mark.parametrize("start", ["near", "far"])
@pytest.mark.parametrize("fused", [True, False], ids=["cg", "classic"])
def test_warm_started_pcg_core_matches_jax(fused, start):
    """`near`: x0 close to the solution (r0_ratio << 1); `far`: x0 worse
    than zero (r0_ratio > 1), so both packages fall back to the cold
    start.  The relative threshold stays anchored to <b, M^-1 b>."""
    A, d, b = _spd_operator(11)
    x_star = np.linalg.solve(A, b.reshape(-1)).reshape(b.shape)
    rng = np.random.default_rng(5)
    x0 = (x_star + 1e-3 * rng.standard_normal(b.shape) if start == "near"
          else 50.0 * rng.standard_normal(b.shape))
    (jm, jp), (tm, tp) = _ops(A, d, b.shape)
    x, k, rho, r0, *_ = jpcg._pcg_core(jm, jp, jnp.asarray(b), 40, 1e-10,
                                       1e30, True, x0=jnp.asarray(x0),
                                       fused=fused)
    tx, tk, trho, tr0, *_ = tpcg._pcg_core(
        tm, tp, torch.from_numpy(b), 40, 1e-10, 1e30, True, fused=fused,
        x0=torch.from_numpy(x0))
    assert tk == int(k)
    assert (float(tr0) < 1e-3) if start == "near" else (float(tr0) > 1.0)
    np.testing.assert_allclose(float(tr0), float(r0), rtol=1e-12)
    np.testing.assert_allclose(tx.numpy(), np.asarray(x), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(float(trho), float(rho), rtol=1e-6,
                               atol=1e-300)
    if start == "far":  # fell back: bitwise the cold solve
        cx, ck, crho, cr0, *_ = tpcg._pcg_core(
            tm, tp, torch.from_numpy(b), 40, 1e-10, 1e30, True, fused=fused)
        assert ck == tk and float(cr0) == 1.0
        assert torch.equal(cx, tx) and torch.equal(crho, trho)


def test_warm_start_counts_one_product_and_one_apply_more():
    A, d, b = _spd_operator(3)
    _, (tm, tp) = _ops(A, d, b.shape)
    counts = {"A": 0, "M": 0}

    def matvec(v):
        counts["A"] += 1
        return tm(v)

    def precond(r):
        counts["M"] += 1
        return tp(r)

    for fused, prime in ((True, 1), (False, 0)):
        for x0, extra in ((None, 0), (torch.zeros(b.shape,
                                                  dtype=torch.float64), 1)):
            counts.update(A=0, M=0)
            _, k, *_ = tpcg._pcg_core(matvec, precond, torch.from_numpy(b),
                                      5, 1e-30, 1e30, False, fused=fused,
                                      x0=x0)
            assert k == 5
            assert counts == {"A": k + prime + extra, "M": k + 1 + extra}


def _scene(dtype=np.float64):
    return mt.make_synthetic_bal(num_cameras=8, num_points=120,
                                 obs_per_point=3.5, seed=3, dtype=dtype)


def _options(kind="IMPLICIT", max_iter=8, fused=False, dtype=np.float64,
             rung=None, region=1e3, **solver):
    kw = dict(max_iter=max_iter, epsilon1=1e-12, epsilon2=1e-15,
              initial_region=region)
    skw = dict(INEXACT, **solver)
    skw["bf16"] = rung == "bf16"
    common = dict(dtype=dtype, mixed_precision_pcg=rung == "mixed")
    j = jc.ProblemOption(
        jacobian_mode=jc.JacobianMode.ANALYTICAL,
        compute_kind=jc.ComputeKind[kind], algo_option=jc.AlgoOption(**kw),
        solver_option=jc.SolverOption(**skw), **common)
    t = mt.ProblemOption(
        jacobian_mode=mt.JacobianMode.ANALYTICAL,
        compute_kind=mt.ComputeKind[kind], algo_option=mt.AlgoOption(**kw),
        solver_option=mt.SolverOption(fused_kernels=fused, **skw), **common)
    return j, t


def _args(s):
    return (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)


def _jax_solve(args, jopt, **kw):
    return j_flat_solve(j_engine(mode=jc.JacobianMode.ANALYTICAL), *args,
                        jopt, **kw)


@functools.lru_cache(maxsize=None)
def _jax_inexact(kind):
    jopt, _ = _options(kind)
    return _jax_solve(_args(_scene()), jopt)


def _compare_forcing(jres, tres):
    t = _compare(jres, tres, cost_rtol=1e-9)
    k = t["iterations"]
    for f in ("pcg_eta", "pcg_r0_ratio"):
        np.testing.assert_allclose(t["trace"][f],
                                   np.asarray(getattr(jres.trace, f))[:k],
                                   rtol=1e-9, err_msg=f)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_forcing_warm_start_flat_solve_matches_jax(kind, fused):
    s = _scene()
    _, topt = _options(kind, fused=fused)
    tres = mt.flat_solve(*_args(s), topt, device="cpu")
    jres = _jax_inexact(kind)
    _compare_forcing(jres, tres)
    k = tres.iterations
    eta = tres.trace.pcg_eta[:k].numpy()
    r0 = tres.trace.pcg_r0_ratio[:k].numpy()
    assert (eta >= 1e-6).all() and (eta <= 0.1).all() and len(set(eta)) > 1
    assert r0[0] == 1.0 and (r0[1:] != 1.0).any()  # warm starts ran
    assert tres.dx_cam.shape == (8, 9)
    np.testing.assert_allclose(tres.dx_cam.numpy(), np.asarray(jres.dx_cam),
                               rtol=1e-6, atol=1e-9)
    # Fewer PCG iterations than the fixed tight tolerance.
    _, tight = _options(kind, fused=fused, forcing=False, warm_start=False,
                        tol=1e-12, tol_relative=True)
    assert tres.pcg_iterations < mt.flat_solve(
        *_args(s), tight, device="cpu").pcg_iterations


def test_no_warm_start_returns_no_step():
    s = _scene()
    _, topt = _options(max_iter=2, warm_start=False)
    res = mt.flat_solve(*_args(s), topt, device="cpu",
                        initial_dx=np.ones((8, 9)))
    assert res.dx_cam is None
    assert (res.trace.pcg_r0_ratio[:res.iterations] == 1.0).all()
    _, warm = _options(max_iter=2)
    with pytest.raises(ValueError, match="initial_dx has shape"):
        mt.flat_solve(*_args(s), warm, device="cpu",
                      initial_dx=np.ones((9, 8)))


def test_warm_start_bitwise_disabled_on_reject():
    """While every step is rejected the warm-start carry stays zero, so
    the solve is bitwise the solve without warm starts (the zero x0 costs
    a product, not a bit)."""
    s = mt.make_synthetic_bal(num_cameras=5, num_points=30, obs_per_point=4,
                              seed=7, param_noise=8e-2, pixel_noise=2.0)

    def run(warm, max_iter):
        opt = mt.ProblemOption(
            jacobian_mode=mt.JacobianMode.ANALYTICAL,
            algo_option=mt.AlgoOption(max_iter=max_iter, initial_region=1e14,
                                      epsilon1=1e-12, epsilon2=1e-15),
            solver_option=mt.SolverOption(max_iter=40, tol=1e-10,
                                          refuse_ratio=1e30,
                                          warm_start=warm))
        return mt.flat_solve(*_args(s), opt, device="cpu")

    probe = run(False, 3)
    accept = probe.trace.accept[:probe.iterations].numpy()
    assert (~accept).sum() >= 1, "the scene no longer rejects"
    n = int(np.argmax(accept)) or 3  # the span before the first accept
    cold, warm = run(False, n), run(True, n)
    assert torch.equal(cold.cameras, warm.cameras)
    assert torch.equal(cold.points, warm.points)
    assert float(cold.cost) == float(warm.cost)
    assert cold.pcg_iterations == warm.pcg_iterations
    assert not warm.dx_cam.any()


def test_split_solve_matches_jax_split():
    """Three LM iterations, then five more from the first half's
    parameters, trust region, back-off factor and last step, in both
    packages."""
    s = _scene()
    j1, t1 = _options(max_iter=3)
    j2, t2 = _options(max_iter=5)
    args = _args(s)
    ja = _jax_solve(args, j1)
    ta = mt.flat_solve(*args, t1, device="cpu")
    _compare_forcing(ja, ta)
    jb = _jax_solve((np.asarray(ja.cameras), np.asarray(ja.points))
                    + args[2:], j2, initial_region=float(ja.region),
                    initial_v=float(ja.v), initial_dx=np.asarray(ja.dx_cam))
    tb = mt.flat_solve(ta.cameras.numpy(), ta.points.numpy(), *args[2:], t2,
                       device="cpu", initial_region=float(ta.region),
                       initial_v=float(ta.v), initial_dx=ta.dx_cam.numpy())
    _compare_forcing(jb, tb)
    # The hooks were live: the resumed first PCG started warm, from the
    # carried region.
    assert float(tb.trace.pcg_r0_ratio[0]) != 1.0
    assert float(tb.trace.trust_region[0]) == float(ta.region)


@pytest.mark.parametrize("rung", ["mixed", "bf16"])
def test_forcing_warm_start_on_precision_rungs(rung, monkeypatch):
    """float32: mixed within 1e-4 of JAX's tiled solve (first trial cost
    and final cost); bf16 within the JAX 2e-2 band of JAX's solve and of
    the port's float32 solve, its forcing tolerance (a device scalar)
    clamped at the bf16 floor."""
    s = _scene(np.float32)
    jopt, topt = _options(max_iter=6, dtype=np.float32, rung=rung)
    jres = _jax_solve(_args(s), jopt, use_tiled=rung == "mixed")
    tols = []
    core = tpcg._pcg_core
    monkeypatch.setattr(tpcg, "_pcg_core", lambda *a, **k: tols.append(
        a[4]) or core(*a, **k))
    tres = mt.flat_solve(*_args(s), topt, device="cpu")
    assert all(isinstance(t, torch.Tensor) for t in tols)
    if rung == "bf16":
        assert min(float(t) for t in tols) >= tpcg._BF16_TOL_FLOOR
    c, cj = float(tres.cost), float(jres.cost)
    assert np.isfinite(c) and c < float(tres.initial_cost)
    k = tres.iterations
    assert (tres.trace.pcg_r0_ratio[1:k] != 1.0).any()
    if rung == "mixed":
        assert k == int(jres.iterations)
        np.testing.assert_allclose(float(tres.trace.cost[0]),
                                   float(jres.trace.cost[0]), rtol=1e-4)
        np.testing.assert_allclose(c, cj, rtol=1e-4)
    else:
        _, f32 = _options(max_iter=6, dtype=np.float32)
        c32 = float(mt.flat_solve(*_args(s), f32, device="cpu").cost)
        assert abs(c - cj) / cj <= 2e-2, (c, cj)
        assert abs(c - c32) / c32 <= 2e-2, (c, c32)

"""The port's fused implicit-Schur path vs the JAX package.

- `fused_coupling_apply_implicit` (plain version on the CPU) against the
  JAX `fused_coupling_apply_implicit` Pallas kernel (`_fused_j_kernel`)
  in interpret mode, in both directions (camera table -> points, point
  table -> cameras), float32 and float64, with masked edges;
- `schur_pcg_solve` IMPLICIT with fused kernels against the JAX solve on
  the same float64 system;
- the textbook PCG body (`_pcg_core(fused=False)`) against the JAX one on
  the same operator, including its stagnation exit;
- `flat_solve` IMPLICIT with fused kernels against JAX `flat_solve` at
  float64 (its unfused lowering computes the same products) and against
  the JAX tiled fused lowering at float32.

CPU only; the CUDA kernel is held to the same plain version by
tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import megba_tpu.common as jc
from megba_tpu.ops import fused as jfused
from megba_tpu.ops.residuals import make_residual_jacobian_fn
from megba_tpu.solve import flat_solve as j_flat_solve
from megba_tpu.solver import pcg as jpcg

import megba_tpu_torch as mt
from megba_tpu_torch.convert import result_to_numpy
from megba_tpu_torch.ops import fused as tfused
from megba_tpu_torch.ops import segtiles as tseg
from megba_tpu_torch.solver import pcg as tpcg

from test_torch_fused import _graph, _port_direction
from test_torch_schur import _systems

IMPLICIT = mt.ComputeKind.IMPLICIT


def implicit_case(seed, dtype, cam_to_pt, row_dtype=None):
    """One implicit direction's inputs in both packages' layouts: the
    JAX bucket plan and permuted rows, and the port's fused plan and rows
    in the output side's slot order.  `row_dtype` (bfloat16) casts the
    stored rows; the table keeps `dtype`."""
    rng = np.random.default_rng(seed)
    ni, no = 30, 80
    in_idx, out_idx, mask = _graph(ni=ni, no=no, seed=seed)
    d_in, d_out = (9, 3) if cam_to_pt else (3, 9)
    Jin = (rng.standard_normal((2 * d_in, 500)) * mask).astype(dtype)
    Jout = (rng.standard_normal((2 * d_out, 500)) * mask).astype(dtype)
    table = rng.standard_normal((d_in, ni)).astype(dtype)
    jplan = jfused.device_fused_plan(jfused.build_fused_plan(
        in_idx, out_idx, mask, ni, no, tile=32, in_block=16, out_block=32))
    jdt = jnp.bfloat16 if row_dtype is not None else dtype
    jax_args = (jfused.permute_rows(jnp.asarray(Jin, jdt), jplan),
                jfused.permute_rows(jnp.asarray(Jout, jdt), jplan),
                jnp.asarray(table), jplan)
    fplan, order = _port_direction(in_idx, out_idx, ni, no, cam_to_pt)

    def rows(a):
        t = torch.from_numpy(np.ascontiguousarray(a[:, order]))
        return t if row_dtype is None else t.to(row_dtype)

    port_args = (rows(Jin), rows(Jout), torch.from_numpy(table), fplan)
    return jax_args, port_args, (d_out, no)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cam_to_pt", [True, False],
                         ids=["cam_to_pt", "pt_to_cam"])
def test_fused_coupling_apply_implicit_matches_jax(dtype, cam_to_pt):
    jax_args, port_args, shape = implicit_case(2, dtype, cam_to_pt)
    want = np.asarray(jfused.fused_coupling_apply_implicit(
        *jax_args, interpret=True))
    got = tfused.fused_coupling_apply_implicit(*port_args).numpy()
    assert got.dtype == dtype and got.shape == shape
    tol = 1e-5 if dtype == np.float32 else 1e-12
    err = np.max(np.abs(got - want)) / (1.0 + np.max(np.abs(want)))
    assert err < tol, err
    # The same product through the unfused plain pieces: expand, then the
    # transposed contraction, summed per output vertex.
    Jin, Jout, table, fplan = port_args
    d_in = table.shape[0]
    pe = table.index_select(1, fplan.in_idx)
    u = [sum(Jin[o * d_in + a] * pe[a] for a in range(d_in))
         for o in range(2)]
    te = torch.stack([sum(Jout[o * shape[0] + b] * u[o] for o in range(2))
                      for b in range(shape[0])])
    np.testing.assert_allclose(got, tseg.seg_reduce_plain(te, fplan.out),
                               rtol=tol, atol=tol)


def test_fused_implicit_wrapper_validates_operands():
    _, (Jin, Jout, table, fplan), _ = implicit_case(2, np.float64, True)
    f = tfused.fused_coupling_apply_implicit
    with pytest.raises(ValueError, match="disagree"):
        f(Jin[:, :-1].contiguous(), Jout, table, fplan)
    with pytest.raises(ValueError, match="disagree"):
        f(Jin, Jout[:5].contiguous(), table, fplan)
    with pytest.raises(ValueError, match="disagree"):
        f(Jin, Jout, table[:, :-1].contiguous(), fplan)
    with pytest.raises(TypeError, match="dtype"):
        f(Jin.float(), Jout, table, fplan)
    with pytest.raises(TypeError, match="bf16_operands"):
        f(Jin, Jout, table, fplan, bf16_operands=True)
    with pytest.raises(ValueError, match="contiguous"):
        f(Jin, Jout, torch.zeros(30, 9, dtype=torch.float64).T, fplan)


# ---------------------------------------------------------------------------
# PCG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,fixed,tol,refuse,rel", [
    (0, False, 1e-10, 1e30, False),   # the venice solver options
    (1, True, 1e-10, 1e30, False),
    (2, False, 1e-6, 1.0, True),      # relative tol, refuse-ratio restore
])
def test_implicit_fused_schur_pcg_matches_jax(seed, fixed, tol, refuse, rel):
    (jsys, jJc, jJp, ci, pi), (tsys, tJc, tJp, plans) = _systems(seed, fixed)
    plans = tfused.with_fused_plans(plans)
    for region in (1e3, 0.5):
        kw = dict(max_iter=30, tol=tol, refuse_ratio=refuse, tol_relative=rel)
        ref = jpcg.schur_pcg_solve(jsys, jJc, jJp, ci, pi,
                                   jnp.asarray(region), **kw)
        got = tpcg.schur_pcg_solve(tsys, tJc, tJp, plans,
                                   torch.tensor(region, dtype=torch.float64),
                                   fused_kernels=True, **kw)
        assert got.iterations == int(ref.iterations)
        for name in ("dx_cam", "dx_pt"):
            r = np.asarray(getattr(ref, name))
            np.testing.assert_allclose(getattr(got, name).numpy(), r,
                                       rtol=1e-10,
                                       atol=1e-10 * np.abs(r).max(),
                                       err_msg=f"{name} at region {region}")


def test_implicit_fused_matvecs_launch_only_the_fused_kernel(monkeypatch):
    """The fused closures read Jc in point order and Jp in camera order,
    permuted once when the closures are built, and call only the fused
    implicit kernel per product."""
    _, (tsys, tJc, tJp, plans) = _systems(0, False)
    plans = tfused.with_fused_plans(plans)
    calls = []
    real = tfused.fused_coupling_apply_implicit
    monkeypatch.setattr(tfused, "fused_coupling_apply_implicit",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    for name in ("coupling_expand", "coupling_reduce"):
        monkeypatch.setattr(tseg, name, None)
    hpl, hlp = tpcg.make_coupling_matvecs(tJc, tJp, plans, IMPLICIT,
                                          fused_kernels=True)
    x = torch.ones(9, plans.cam.num_segments, dtype=torch.float64)
    q = torch.ones(3, plans.pt.num_segments, dtype=torch.float64)
    hlp(x), hpl(q), hlp(x)
    assert len(calls) == 3
    assert torch.equal(calls[0][0], plans.to_pt(tJc)) and calls[0][1] is tJp
    assert torch.equal(calls[1][0], plans.to_cam(tJp)) and calls[1][1] is tJc
    assert calls[2][0] is calls[0][0]  # permuted once, not per product


def _spd_operator(seed, n=12, indefinite=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    if indefinite:
        A[0, 0] = -4.0 * n
    d = 1.0 / np.diag(A)
    b = rng.standard_normal((3, n // 3))
    return A, d, b


@pytest.mark.parametrize("case,tol,refuse,rel", [
    ("spd", 1e-12, 1e30, False),
    ("spd_relative", 1e-8, 1e30, True),
    ("spd_refuse", 1e-14, 1.0, False),
    ("indefinite_stall", 1e-14, 1e30, False),
])
def test_classic_pcg_core_matches_jax(case, tol, refuse, rel):
    """The textbook body on one operator in both packages: the same
    iterate, iteration count and final rho (the operator is [3, n/3]
    rows, as the Schur camera vector)."""
    A, d, b = _spd_operator(7, indefinite=case.startswith("indefinite"))
    shape = b.shape

    def j_ops():
        Aj, dj = jnp.asarray(A), jnp.asarray(d.reshape(shape))
        return ((lambda v: (Aj @ v.reshape(-1)).reshape(shape)),
                (lambda r: r * dj))

    def t_ops():
        At, dt = torch.from_numpy(A), torch.from_numpy(d.reshape(shape))
        return ((lambda v: (At @ v.reshape(-1)).reshape(shape)),
                (lambda r: r * dt))

    jm, jp = j_ops()
    x, k, rho, *_ = jpcg._pcg_core(jm, jp, jnp.asarray(b), 40, tol, refuse,
                                   rel, fused=False)
    tm, tp = t_ops()
    tx, tk, trho, *_ = tpcg._pcg_core(tm, tp, torch.from_numpy(b), 40, tol,
                                      refuse, rel, fused=False)
    assert tk == int(k) and tk < 40
    np.testing.assert_allclose(tx.numpy(), np.asarray(x), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(float(trho), float(rho), rtol=1e-8,
                               atol=1e-300)
    if case == "spd":  # converged: A x = b
        np.testing.assert_allclose((A @ tx.numpy().reshape(-1)),
                                   b.reshape(-1), rtol=1e-5, atol=1e-6)


def test_classic_body_runs_one_matvec_per_iteration():
    """No priming matvec: k iterations, k matvecs and k + 1 applies of
    M^-1 (the Chronopoulos-Gear body runs k + 1 matvecs)."""
    A, d, b = _spd_operator(3)
    At, dt = torch.from_numpy(A), torch.from_numpy(d.reshape(b.shape))
    counts = {"A": 0, "M": 0}

    def matvec(v):
        counts["A"] += 1
        return (At @ v.reshape(-1)).reshape(b.shape)

    def precond(r):
        counts["M"] += 1
        return r * dt

    for fused, extra in ((False, 0), (True, 1)):
        counts.update(A=0, M=0)
        _, k, *_ = tpcg._pcg_core(matvec, precond, torch.from_numpy(b),
                                  5, 1e-30, 1e30, False, fused=fused)
        assert k == 5 and counts == {"A": k + extra, "M": k + 1}


# ---------------------------------------------------------------------------
# The whole slice: flat_solve
# ---------------------------------------------------------------------------


def _options(dtype, max_iter, fused=True):
    kw = dict(max_iter=max_iter, epsilon1=1e-12, epsilon2=1e-15)
    skw = dict(max_iter=30, tol=1e-10, refuse_ratio=1e30)
    j = jc.ProblemOption(
        dtype=dtype, jacobian_mode=jc.JacobianMode.ANALYTICAL,
        compute_kind=jc.ComputeKind.IMPLICIT,
        algo_option=jc.AlgoOption(**kw),
        solver_option=jc.SolverOption(fused_kernels=dtype == np.float32,
                                      **skw))
    t = mt.ProblemOption(
        dtype=dtype, jacobian_mode=mt.JacobianMode.ANALYTICAL,
        compute_kind=IMPLICIT, algo_option=mt.AlgoOption(**kw),
        solver_option=mt.SolverOption(fused_kernels=fused, **skw))
    return j, t


@pytest.mark.parametrize("case", ["plain", "masked_fixed_weighted"])
def test_implicit_fused_flat_solve_matches_jax_f64(case):
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
    # The JAX package fuses only on its tiled lowering; its unfused
    # IMPLICIT solve computes the same products.
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


def test_implicit_fused_flat_solve_matches_jax_tiled_f32():
    s = mt.make_synthetic_bal(num_cameras=8, num_points=120,
                              obs_per_point=3.5, seed=1, dtype=np.float32)
    jopt, topt = _options(np.float32, max_iter=6)
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


def test_implicit_fused_solve_bal_runs_on_cpu():
    s = mt.make_synthetic_bal(num_cameras=5, num_points=40, obs_per_point=3,
                              seed=2)
    bal = mt.BALFile(cameras=s.cameras0, points=s.points0, obs=s.obs,
                     cam_idx=s.cam_idx, pt_idx=s.pt_idx)
    _, topt = _options(np.float64, max_iter=3)
    solved, res = mt.solve_bal(bal, topt, device="cpu")
    assert res.iterations >= 1 and float(res.cost) < float(res.initial_cost)
    assert solved.cameras.shape == (5, 9)

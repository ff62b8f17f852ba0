"""The port's precision ladder without fused kernels, and at float64.

The same seeded inputs go through the JAX package and the port:

- the mixed arm of `coupling_expand` / `coupling_reduce` (bfloat16 J rows
  upcast before each multiply, float32 table) against the JAX Pallas
  kernels in interpret mode fed bfloat16 rows, both sides (camera d=9,
  point d=3): |port - JAX| <= 1e-5 of the sum of the terms' magnitudes
  per output (the float32 kernel rule: only the summation order
  differs);
- the mixed64 arm (bfloat16 rows beside a float64 table) of the two
  coupling kernels against the JAX XLA lowering of `mixed_precision_pcg`
  at float64 (`up` casts each row to float32, times a float64 vector),
  and of the two fused coupling applies against the JAX Pallas kernels in
  interpret mode with bfloat16 rows and a float64 table: 1e-12;
- the unfused coupling products of both rungs (IMPLICIT: expand ->
  permute -> reduce in the kernels' bf16 or mixed arm; EXPLICIT: the
  plain per-edge W contraction with `_edge_precision`'s casts) against
  JAX `make_coupling_matvecs(plans=None)`, compiled without XLA's excess
  precision so it rounds where its source says: 1e-5 of the sum of the
  terms' magnitudes;
- `cam_block_matvec_bf16` against JAX's: 1e-6 of the sum of the terms'
  magnitudes (exact products, float32 sums of nine terms);
- the equilibrated bfloat16 rows at float64, bitwise (the two packages'
  float64 -> bfloat16 casts agree);
- `schur_pcg_solve`: mixed at float64, dx at rtol 1e-10 with equal
  iterations; mixed at float32 within 1e-4 and bf16 within 1e-2 at
  strong damping;
- `flat_solve`: mixed at float64 on all four kinds (IMPLICIT / EXPLICIT,
  fused off / on) against JAX's unfused float64 mixed solve, cost rtol
  1e-9 with equal accept pattern and counts; unfused mixed at float32
  within 1e-4 of JAX's tiled solve; unfused bf16 within 2e-2 of JAX's
  bf16 solve and of the port's float32 solve; the kernels really get
  bfloat16 rows.

CPU only; the CUDA arms are held to the same plain versions by
tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import megba_tpu.common as jc
from megba_tpu.core import fm as jfm
from megba_tpu.ops import fused as jfused
from megba_tpu.ops import segtiles as jseg
from megba_tpu.ops.residuals import make_residual_jacobian_fn
from megba_tpu.solve import flat_solve as j_flat_solve
from megba_tpu.solver import pcg as jpcg
from megba_tpu.solver import precond as jprecond

import megba_tpu_torch as mt
from megba_tpu_torch.ops import fused as tfused
from megba_tpu_torch.ops import segtiles as tseg
from megba_tpu_torch.parallel.mesh import one_shard
from megba_tpu_torch.solver import pcg as tpcg
from megba_tpu_torch.solver import precond as tprecond

from test_torch_explicit import _explicit_systems
from test_torch_fused import _graph, _port_direction
from test_torch_fused_implicit import implicit_case
from test_torch_precision import _f32_systems, _jax_strict
from test_torch_schur import _systems, one
from test_torch_segtiles import (_inputs, _jax_slots, _plans, _port_slots,
                                 _segment_ids)
from test_torch_solve import _compare

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

BF16 = torch.bfloat16
F32_REL_TO_ABS_SUM = 1e-5
F64_TOL = dict(rtol=1e-12, atol=1e-12)


def _abs(args):
    return [a.abs() if isinstance(a, torch.Tensor) and a.is_floating_point()
            else a for a in args]


def _within_abs_sum(got, want, scale, rel):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert (err <= rel * np.asarray(scale)).all(), float(err.max())


def _to_edges(slots, perm, n):
    """[F, n] rows in a plan's slot order -> the caller's edge order."""
    out = np.empty((slots.shape[0], n), slots.dtype)
    out[:, perm] = slots
    return out


# ---------------------------------------------------------------------------
# Kernels 2 and 3: the mixed and mixed64 arms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [9, 3])
@pytest.mark.parametrize("kernel", ["expand", "reduce"])
def test_coupling_mixed_arm_matches_jax_kernels(kernel, d):
    ns = 40
    idx = _segment_ids(2, ns)
    jplan, jdp, hplan, tplan = _plans(idx, ns, d)
    n = idx.shape[0]
    J, u, table = _inputs(2, n, ns, d, np.float32)
    jJ = _jax_slots(J, jplan).astype(jnp.bfloat16)
    tJ = _port_slots(J, hplan).to(BF16)
    if kernel == "expand":
        ju = np.asarray(jseg.coupling_expand(
            jnp.asarray(table), jJ, jdp, d, use_kernels=False,
            interpret=True))
        real = jplan.mask > 0
        want = np.empty((2, n), ju.dtype)
        want[:, jplan.perm[real]] = ju[:, real]
        args = [torch.from_numpy(table), tJ, tplan, d]
        got = _to_edges(tseg.coupling_expand(*args).numpy(), hplan.perm, n)
        scale = _to_edges(tseg.coupling_expand_plain(*_abs(args)).numpy(),
                          hplan.perm, n)
    else:
        want = np.asarray(jseg.coupling_reduce(
            jJ, _jax_slots(u, jplan), jdp, d, use_kernels=False,
            interpret=True))
        args = [tJ, _port_slots(u, hplan), tplan, d]
        got = tseg.coupling_reduce(*args).numpy()
        scale = tseg.coupling_reduce_plain(*_abs(args)).numpy()
    assert got.dtype == want.dtype == np.float32
    _within_abs_sum(got, want, scale, F32_REL_TO_ABS_SUM)


@pytest.mark.parametrize("d", [9, 3])
@pytest.mark.parametrize("kernel", ["expand", "reduce"])
def test_coupling_mixed64_arm_matches_jax_xla(kernel, d):
    ns = 40
    idx = _segment_ids(3, ns)
    _, _, hplan, tplan = _plans(idx, ns, d)
    n = idx.shape[0]
    J, u, table = _inputs(3, n, ns, d, np.float64)
    Jb = jnp.asarray(J).astype(jnp.bfloat16)
    tJ = _port_slots(J, hplan).to(BF16)

    def up(x):  # JAX pcg._edge_precision's mixed cast
        return x.astype(jnp.float32)

    if kernel == "expand":
        pe = jfm.gather_fm(jnp.asarray(table), jnp.asarray(idx))
        want = np.asarray(jnp.stack([
            sum(up(Jb[o * d + a]) * pe[a] for a in range(d))
            for o in range(2)]))
        got = _to_edges(tseg.coupling_expand(
            torch.from_numpy(table), tJ, tplan, d).numpy(), hplan.perm, n)
    else:
        te = jnp.stack([sum(up(Jb[o * d + b]) * jnp.asarray(u[o])
                            for o in range(2)) for b in range(d)])
        want = np.asarray(jfm.segsum_fm(te, jnp.asarray(idx), ns))
        got = tseg.coupling_reduce(tJ, _port_slots(u, hplan), tplan,
                                   d).numpy()
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, **F64_TOL)


@pytest.mark.parametrize("cam_to_pt", [True, False],
                         ids=["cam_to_pt", "pt_to_cam"])
def test_fused_implicit_mixed64_arm_matches_jax(cam_to_pt):
    jax_args, port_args, shape = implicit_case(4, np.float64, cam_to_pt,
                                               row_dtype=BF16)
    assert port_args[0].dtype == BF16 and port_args[2].dtype == torch.float64
    want = np.asarray(jfused.fused_coupling_apply_implicit(
        *jax_args, interpret=True))
    got = tfused.fused_coupling_apply_implicit(*port_args).numpy()
    assert got.dtype == want.dtype == np.float64 and got.shape == shape
    np.testing.assert_allclose(got, want, **F64_TOL)


@pytest.mark.parametrize("w_in_major", [True, False])
def test_fused_explicit_mixed64_arm_matches_jax(w_in_major):
    rng = np.random.default_rng(8)
    ni, no = 30, 80
    in_idx, out_idx, mask = _graph(ni=ni, no=no, seed=8)
    d_in = 9 if w_in_major else 3
    W = rng.standard_normal((27, 500)) * mask
    table = rng.standard_normal((d_in, ni))
    dplan = jfused.device_fused_plan(jfused.build_fused_plan(
        in_idx, out_idx, mask, ni, no, tile=32, in_block=16, out_block=32))
    want = np.asarray(jfused.fused_coupling_apply(
        jfused.permute_rows(jnp.asarray(W, jnp.bfloat16), dplan),
        jnp.asarray(table), dplan, w_in_major=w_in_major, interpret=True))
    fplan, order = _port_direction(in_idx, out_idx, ni, no, w_in_major)
    Wt = torch.from_numpy(np.ascontiguousarray(W[:, order])).to(BF16)
    got = tfused.fused_coupling_apply(Wt, torch.from_numpy(table), fplan,
                                      w_in_major).numpy()
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, **F64_TOL)


def test_arm_table_refusals():
    """bf16_operands with a float64 table stays refused, in every kernel
    that takes it; the block-diagonal apply has no mixed64 arm."""
    idx = _segment_ids(0, 40)
    _, _, hplan, tplan = _plans(idx, 40, 9)
    J, u, table = _inputs(0, idx.shape[0], 40, 9, np.float64)
    tJ = _port_slots(J, hplan).to(BF16)
    with pytest.raises(TypeError, match="bf16_operands"):
        tseg.coupling_expand(torch.from_numpy(table), tJ, tplan, 9,
                             bf16_operands=True)
    with pytest.raises(TypeError, match="bf16_operands"):
        tseg.coupling_reduce(tJ, _port_slots(u, hplan), tplan, 9,
                             bf16_operands=True)
    with pytest.raises(TypeError, match="share"):  # f32 rows, f64 table
        tseg.coupling_expand(torch.from_numpy(table), tJ.float(), tplan, 9)
    with pytest.raises(TypeError,
                       match=r"arms built: bf16, f32, f64, mixed\)"):
        tfused.fused_block_diag_apply(torch.zeros(81, 4, dtype=BF16),
                                      torch.zeros(9, 4, dtype=torch.float64))


# ---------------------------------------------------------------------------
# The unfused coupling products of both rungs, and the bf16 block apply
# ---------------------------------------------------------------------------


def _coupling_case(seed, nc=12, npt=60, n=400):
    """A random camera/point graph with scaled rows (f32, edge order)."""
    rng = np.random.default_rng(seed)
    cam_idx = rng.integers(0, nc, n).astype(np.int32)
    pt_idx = rng.integers(0, npt, n).astype(np.int32)
    rows = {k: (0.3 * rng.standard_normal((f, n))).astype(np.float32)
            for k, f in (("Jc", 18), ("Jp", 6), ("W", 27))}
    x_cam = rng.standard_normal((9, nc)).astype(np.float32)
    q_pt = rng.standard_normal((3, npt)).astype(np.float32)
    return cam_idx, pt_idx, nc, npt, rows, x_cam, q_pt


@pytest.mark.parametrize("rung", ["bf16", "mixed"])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_unfused_rung_matvecs_match_jax(kind, rung):
    cam_idx, pt_idx, nc, npt, rows, x_cam, q_pt = _coupling_case(9)
    bf16_ops = rung == "bf16"
    jrows = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in rows.items()}
    explicit = kind == "EXPLICIT"
    jhpl, jhlp = jpcg.make_coupling_matvecs(
        jrows["W"] if explicit else None, jrows["Jc"], jrows["Jp"],
        jnp.asarray(cam_idx), jnp.asarray(pt_idx), nc, npt,
        jc.ComputeKind[kind], mixed_precision=not bf16_ops,
        bf16_ops=bf16_ops)
    want_pt = _jax_strict(jhlp, jnp.asarray(x_cam))
    want_cam = _jax_strict(jhpl, jnp.asarray(q_pt))

    plan_c, plans = tseg.make_dual_plans(cam_idx, pt_idx, nc, npt, "cpu")
    perm = plan_c.perm

    def port_matvecs(f):
        t = {k: f(torch.from_numpy(np.ascontiguousarray(v[:, perm])).to(BF16))
             for k, v in rows.items()}
        return tpcg.make_coupling_matvecs(
            t["Jc"], plans.to_pt(t["Jp"]).contiguous(), plans,
            mt.ComputeKind[kind], t["W"], bf16_ops=bf16_ops)

    hpl, hlp = port_matvecs(lambda t: t)
    ahpl, ahlp = port_matvecs(torch.abs)
    xc, qp = torch.from_numpy(x_cam), torch.from_numpy(q_pt)
    got_pt, got_cam = hlp(xc), hpl(qp)
    assert got_pt.dtype == got_cam.dtype == torch.float32
    _within_abs_sum(got_pt, want_pt, ahlp(xc.abs()), F32_REL_TO_ABS_SUM)
    _within_abs_sum(got_cam, want_cam, ahpl(qp.abs()), F32_REL_TO_ABS_SUM)


def test_unfused_bf16_rounds_where_mixed_does_not():
    cam_idx, pt_idx, nc, npt, rows, x_cam, _ = _coupling_case(10)
    plan_c, plans = tseg.make_dual_plans(cam_idx, pt_idx, nc, npt, "cpu")
    Jc = torch.from_numpy(np.ascontiguousarray(rows["Jc"][:, plan_c.perm]))
    Jp = plans.to_pt(torch.from_numpy(np.ascontiguousarray(
        rows["Jp"][:, plan_c.perm])))
    x = torch.from_numpy(x_cam)
    out = {ops: tpcg.make_coupling_matvecs(Jc.to(BF16), Jp.to(BF16), plans,
                                           bf16_ops=ops)[1](x)
           for ops in (False, True)}
    assert not torch.equal(out[False], out[True])
    # u from the bf16 arm already holds bfloat16 values.
    u = tseg.coupling_expand(x, Jc.to(BF16), plans.cam, 9,
                             bf16_operands=True)
    assert torch.equal(u, u.to(BF16).float())


def test_cam_block_matvec_bf16_matches_jax():
    rng = np.random.default_rng(11)
    nc = 300
    A = rng.standard_normal((nc, 9, 9))
    H = (A @ A.transpose(0, 2, 1) / 9 + np.eye(9)).astype(np.float32)
    x = rng.standard_normal((9, nc)).astype(np.float32)
    Hb = torch.from_numpy(H).to(BF16)
    want = np.asarray(jprecond.cam_block_matvec_bf16(
        jnp.asarray(H, jnp.bfloat16), jnp.asarray(x)))
    got = tprecond.cam_block_matvec_bf16(Hb, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.is_contiguous()
    scale = tprecond.cam_block_matvec_bf16(Hb.abs(),
                                           torch.from_numpy(np.abs(x)))
    _within_abs_sum(got, want, scale, 1e-6)
    # The unfused bf16 rung's preconditioner applies exactly this.
    Hpp = torch.from_numpy(H)
    apply, _ = tprecond.make_schur_preconditioner(
        mt.PrecondKind.JACOBI, mt.PreconditionerKind.HPP, Hpp, bf16=True)
    Minv_b = tprecond.block_inv(Hpp).to(BF16)
    xt = torch.from_numpy(x)
    assert torch.equal(apply(xt), tprecond.cam_block_matvec_bf16(Minv_b, xt))


# ---------------------------------------------------------------------------
# Equilibration and PCG
# ---------------------------------------------------------------------------


def _f64_case(kind):
    """Both packages' float64 systems, the port's rows and the map from
    its slot orders to JAX's edge order."""
    if kind == "IMPLICIT":
        (jsys, jJc, jJp, ci, pi), (tsys, tJc, tJp, plans) = _systems(1, True)
        perm = np.argsort(np.asarray(ci), kind="stable")
    else:
        (jsys, jJc, jJp, ci, pi), (tsys, plans, perm) = _explicit_systems(
            1, True)
        tJc = tJp = None
    return (jsys, jJc, jJp, ci, pi), (tsys, tJc, tJp, plans), perm


def _spy_rows(monkeypatch, module, store):
    real = module.make_coupling_matvecs

    def spy(*a, **k):
        store.append((a, k))
        return real(*a, **k)

    monkeypatch.setattr(module, "make_coupling_matvecs", spy)


@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_equilibrated_f64_rows_match_jax_bitwise(kind, monkeypatch):
    (jsys, jJc, jJp, ci, pi), (tsys, tJc, tJp, plans), perm = _f64_case(kind)
    jseen, tseen = [], []
    _spy_rows(monkeypatch, jpcg, jseen)
    _spy_rows(monkeypatch, tpcg, tseen)
    kw = dict(max_iter=1, mixed_precision=True)
    jpcg.schur_pcg_solve(jsys, jJc, jJp, ci, pi, jnp.asarray(0.5),
                         compute_kind=jc.ComputeKind[kind], **kw)
    tpcg.schur_pcg_solve(tsys, one(tJc), one(tJp), one_shard(plans),
                         torch.tensor(0.5, dtype=torch.float64),
                         compute_kind=mt.ComputeKind[kind], **kw)
    jW, jJc_b, jJp_b = jseen[0][0][:3]  # (W, Jc, Jp, ...)
    ta = tseen[0][0]  # (Jc, Jp, plans, compute_kind, W, ...)
    tJc_b, tJp_b, tW = ta[0], ta[1], ta[4]

    def same(port, jax_edges, order):
        assert port.dtype == BF16
        want = np.asarray(jax_edges.astype(jnp.float32))[:, order]
        np.testing.assert_array_equal(port.float().numpy(), want)

    if kind == "IMPLICIT":
        same(tJc_b, jJc_b, perm)
        same(tJp_b, jJp_b, perm[plans.pt.inv.numpy()])
    else:
        same(tW, jW, perm)


@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_mixed_f64_schur_pcg_matches_jax(kind):
    (jsys, jJc, jJp, ci, pi), (tsys, tJc, tJp, plans), _ = _f64_case(kind)
    kw = dict(max_iter=30, tol=1e-10, refuse_ratio=1e30,
              mixed_precision=True)
    for region in (1e3, 0.5):
        ref = jpcg.schur_pcg_solve(jsys, jJc, jJp, ci, pi,
                                   jnp.asarray(region),
                                   compute_kind=jc.ComputeKind[kind], **kw)
        got = tpcg.schur_pcg_solve(tsys, one(tJc), one(tJp), one_shard(plans),
                                   torch.tensor(region, dtype=torch.float64),
                                   compute_kind=mt.ComputeKind[kind], **kw)
        assert got.iterations == int(ref.iterations)
        for name in ("dx_cam", "dx_pt"):
            r = np.asarray(getattr(ref, name))
            np.testing.assert_allclose(getattr(got, name).numpy(), r,
                                       rtol=1e-10,
                                       atol=1e-10 * np.abs(r).max(),
                                       err_msg=f"{name} at region {region}")


@pytest.mark.parametrize("rung,limit", [("bf16", 1e-2), ("mixed", 1e-4)])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_unfused_precision_schur_pcg_matches_jax(kind, rung, limit):
    (jsys, jJc, jJp, ci, pi), (tsys, tJc, tJp, plans) = _f32_systems(kind, 1)
    kw = dict(max_iter=50, tol=1e-6, refuse_ratio=1e30, tol_relative=True,
              mixed_precision=rung == "mixed", bf16=rung == "bf16")
    # Strongly damped regions, as for the fused rungs
    # (test_torch_precision.py): the solves stop on the relative
    # tolerance within a few iterations.
    for region in (0.5, 2.0):
        ref = jpcg.schur_pcg_solve(
            jsys, jJc, jJp, ci, pi, jnp.asarray(region, jnp.float32),
            compute_kind=jc.ComputeKind[kind], **kw)
        got = tpcg.schur_pcg_solve(
            tsys, one(tJc), one(tJp), one_shard(plans),
            torch.tensor(region, dtype=torch.float32),
            compute_kind=mt.ComputeKind[kind], **kw)
        assert got.dx_cam.dtype == got.dx_pt.dtype == torch.float32
        want = np.concatenate([np.asarray(ref.dx_cam).ravel(),
                               np.asarray(ref.dx_pt).ravel()])
        have = np.concatenate([got.dx_cam.numpy().ravel(),
                               got.dx_pt.numpy().ravel()])
        gap = np.linalg.norm(have - want) / np.linalg.norm(want)
        assert gap <= limit, (region, gap, got.iterations, int(ref.iterations))


# ---------------------------------------------------------------------------
# The whole slice: flat_solve
# ---------------------------------------------------------------------------


def _options(dtype, kind, rung, fused=False, max_iter=8, region=1e3):
    """(JAX, port) options of one rung; the JAX package fuses only on its
    tiled lowering, which float64 never takes, so its option is unfused.
    `region` is the LM's initial trust region."""
    kw = dict(max_iter=max_iter, epsilon1=1e-12, epsilon2=1e-15,
              initial_region=region)
    skw = dict(max_iter=30, tol=1e-10, refuse_ratio=1e30, bf16=rung == "bf16")
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


def _jax_solve(args, jopt, use_tiled):
    return j_flat_solve(make_residual_jacobian_fn(
        mode=jc.JacobianMode.ANALYTICAL), *args, jopt, use_tiled=use_tiled)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_mixed_f64_flat_solve_matches_jax(kind, fused):
    # Initial trust region 1: from the default 1e3 this rung's trajectory
    # comes, within a few accepted steps, to depend on the last bits of
    # its inputs (a 1e-15 relative change of the observations moves a
    # late trial cost by up to 1.5e-10 on this scene and 2.7e-7 on a
    # larger one; scripts/torch_mixed_f64_sensitivity.py), and no two
    # summation orders can then agree at 1e-9.  From region 1 the same
    # change moves no trial cost by more than ~1e-14.
    s = mt.make_synthetic_bal(num_cameras=8, num_points=120,
                              obs_per_point=3.5, seed=3)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    jopt, topt = _options(np.float64, kind, "mixed", fused, region=1.0)
    jres = _jax_solve(args, jopt, use_tiled=False)
    tres = mt.flat_solve(None, *args, topt, device="cpu")
    assert tres.cameras.dtype == torch.float64 and int(jres.iterations) > 1
    _compare(jres, tres, cost_rtol=1e-9)
    # The rung changed the arithmetic: the float64 solve lands elsewhere.
    _, f64 = _options(np.float64, kind, None, fused, region=1.0)
    assert float(tres.cost) != float(mt.flat_solve(None, *args, f64,
                                                   device="cpu").cost)


def _spy_kernels(monkeypatch):
    """Record (kernel, row dtype, bf16_operands) of every coupling-kernel
    call, and the W dtype of every unfused per-edge W contraction."""
    seen = []
    for module, name, row in ((tseg, "coupling_expand", 1),
                              (tseg, "coupling_reduce", 0)):
        real = getattr(module, name)

        def spy(*a, _real=real, _name=name, _row=row, **k):
            ops = a[4] if len(a) > 4 else k.get("bf16_operands", False)
            seen.append((_name, a[_row].dtype, ops))
            return _real(*a, **k)

        monkeypatch.setattr(module, name, spy)
    for name in ("_edge_cam_to_pt_explicit", "_edge_pt_to_cam_explicit"):
        real = getattr(tpcg, name)

        def spy_w(W, *a, _real=real, _name=name, **k):
            seen.append((_name, W.dtype, None))
            return _real(W, *a, **k)

        monkeypatch.setattr(tpcg, name, spy_w)
    return seen


@pytest.mark.parametrize("rung", ["mixed", "bf16"])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_unfused_precision_flat_solve_matches_jax(kind, rung, monkeypatch):
    s = mt.make_synthetic_bal(num_cameras=8, num_points=120,
                              obs_per_point=3.5, seed=1, dtype=np.float32)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    jopt, topt = _options(np.float32, kind, rung, max_iter=6)
    # mixed rides JAX's tiled lowering (kernels 2/3 or 5/4 with bf16
    # rows); bf16 its XLA lowering (flat_solve forces it).
    jres = _jax_solve(args, jopt, use_tiled=rung == "mixed")
    _, f32 = _options(np.float32, kind, None, max_iter=6)
    ref32 = mt.flat_solve(None, *args, f32, device="cpu")
    seen = _spy_kernels(monkeypatch)
    tres = mt.flat_solve(None, *args, topt, device="cpu")
    k = int(jres.iterations)
    c, cj, c32 = float(tres.cost), float(jres.cost), float(ref32.cost)
    assert np.isfinite(c) and c < float(tres.initial_cost)
    if rung == "mixed":
        # The first trial cost and the final cost, not the whole
        # trajectory: with the PCG run to its cap at float32, an accept
        # decision near the optimum goes either way on float32 rounding,
        # and the JAX package's own tiled and XLA lowerings of EXPLICIT
        # mixed part there by more than this band.
        assert tres.iterations == k
        np.testing.assert_allclose(float(tres.trace.cost[0]),
                                   float(jres.trace.cost[0]), rtol=1e-4)
        np.testing.assert_allclose(c, cj, rtol=1e-4)
    else:
        assert abs(c - cj) / cj <= 2e-2, (c, cj)
        assert abs(c - c32) / c32 <= 2e-2, (c, c32)
    assert c != c32  # the rung changed the arithmetic

    bf16 = rung == "bf16"
    L = tres.iterations
    if kind == "IMPLICIT":
        rows = [x for x in seen if x[1] == BF16]
        full = [x for x in seen if x[1] != BF16]
        assert rows and all(ops == bf16 for _, _, ops in rows)
        # Only the gain ratio's two expands per LM iteration read the
        # unscaled full-precision rows.
        assert full == [("coupling_expand", torch.float32, False)] * (2 * L)
    else:
        contractions = [x for x in seen if x[2] is None]
        kernels = [x for x in seen if x[2] is not None]
        assert contractions and all(dt == BF16 for _, dt, _ in contractions)
        assert {name for name, _, _ in contractions} == {
            "_edge_cam_to_pt_explicit", "_edge_pt_to_cam_explicit"}
        assert kernels == [("coupling_expand", torch.float32, False)] * (2 * L)

"""The port's precision ladder on the fused kernels vs the JAX package.

- The bf16-row arms of the three fused kernels (plain versions on the
  CPU): `fused_coupling_apply_implicit` and `fused_coupling_apply` in
  both directions, `fused_block_diag_apply`, each with bfloat16 rows
  beside a float32 table, upcast before the multiply (the mixed rung) or
  multiplied in bfloat16 (the bf16 rung), against the JAX Pallas kernels
  in interpret mode.  XLA's CPU compiler may by default keep a bfloat16
  product at float32 (excess precision), so the JAX reference is
  compiled without it and rounds where its kernel source says.  Held to
  the float32 kernel rule: |port - JAX| <= 1e-5 of the sum of the terms'
  magnitudes, per output; only the segment-sum order differs.
- `schur_pcg_solve` with `bf16` / `mixed_precision` and fused kernels,
  IMPLICIT and EXPLICIT, against the JAX solve of the same float32
  system (its unfused lowering, which rounds the per-edge products at
  the same points).
- `flat_solve` on both rungs and both compute kinds: the cost falls and
  lands within the JAX package's bf16 band (2e-2) of the port's own
  float32 fused solve; the fused kernels really get bfloat16 rows.
- `validate_options` on the precision combinations (the unfused rungs
  and mixed at float64 are held to the JAX package by
  tests/test_torch_unfused_precision.py).

CPU only; the CUDA arms are held to the same plain versions by
tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import megba_tpu.common as jc
from megba_tpu.ops import fused as jfused
from megba_tpu.solver import pcg as jpcg

import megba_tpu_torch as mt
from megba_tpu_torch import common as tc
from megba_tpu_torch.convert import schur_system_to_torch
from megba_tpu_torch.ops import fused as tfused
from megba_tpu_torch.ops import segtiles as tseg
from megba_tpu_torch.parallel.mesh import one_shard
from megba_tpu_torch.solver import pcg as tpcg

from test_torch_explicit import _explicit_systems
from test_torch_fused import _graph, _port_direction
from test_torch_fused_implicit import implicit_case
from test_torch_schur import _systems, one

BF16 = torch.bfloat16
F32_REL_TO_ABS_SUM = 1e-5
ARMS = {"mixed": False, "bf16": True}  # arm -> bf16_operands


def _jax_strict(fn, *args):
    """fn(*args) compiled without XLA's excess precision."""
    lowered = jax.jit(fn).lower(*args)
    return np.asarray(lowered.compile(
        compiler_options={"xla_allow_excess_precision": False})(*args))


def _abs_args(args):
    return [a.abs() if isinstance(a, torch.Tensor) and a.is_floating_point()
            else a for a in args]


def _check_arm(kernel, args, kwargs, want):
    got = kernel(*args, **kwargs)
    assert got.dtype == torch.float32  # the accumulator's, as _acc_dtype
    scale = kernel(*_abs_args(args), **kwargs).numpy()
    err = np.abs(got.numpy() - want)
    assert (err <= F32_REL_TO_ABS_SUM * scale).all(), float(err.max())
    return got


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("cam_to_pt", [True, False],
                         ids=["cam_to_pt", "pt_to_cam"])
def test_implicit_arm_matches_jax(arm, cam_to_pt):
    ops = ARMS[arm]
    jax_args, port_args, _ = implicit_case(5, np.float32, cam_to_pt,
                                           row_dtype=BF16)
    assert port_args[0].dtype == BF16 and port_args[2].dtype == torch.float32
    want = _jax_strict(lambda a, b, t, p: jfused.fused_coupling_apply_implicit(
        a, b, t, p, bf16_operands=ops, interpret=True), *jax_args)
    assert want.dtype == np.float32
    _check_arm(tfused.fused_coupling_apply_implicit, port_args,
               dict(bf16_operands=ops), want)


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("w_in_major", [True, False])
def test_explicit_arm_matches_jax(arm, w_in_major):
    ops = ARMS[arm]
    rng = np.random.default_rng(6)
    ni, no = 30, 80
    in_idx, out_idx, mask = _graph(ni=ni, no=no, seed=6)
    d_in = 9 if w_in_major else 3
    W = (rng.standard_normal((27, 500)) * mask).astype(np.float32)
    table = rng.standard_normal((d_in, ni)).astype(np.float32)
    dplan = jfused.device_fused_plan(jfused.build_fused_plan(
        in_idx, out_idx, mask, ni, no, tile=32, in_block=16, out_block=32))
    jW = jfused.permute_rows(jnp.asarray(W, jnp.bfloat16), dplan)
    want = _jax_strict(lambda w, t, p: jfused.fused_coupling_apply(
        w, t, p, w_in_major=w_in_major, bf16_operands=ops, interpret=True),
        jW, jnp.asarray(table), dplan)
    fplan, order = _port_direction(in_idx, out_idx, ni, no, w_in_major)
    Wt = torch.from_numpy(np.ascontiguousarray(W[:, order])).to(BF16)
    _check_arm(tfused.fused_coupling_apply,
               (Wt, torch.from_numpy(table), fplan, w_in_major),
               dict(bf16_operands=ops), want)


@pytest.mark.parametrize("arm", list(ARMS))
def test_block_diag_arm_matches_jax(arm):
    ops = ARMS[arm]
    rng = np.random.default_rng(7)
    nc = 600
    A = rng.standard_normal((nc, 9, 9))
    Minv = (A @ A.transpose(0, 2, 1) + 9 * np.eye(9)).astype(np.float32)
    x = rng.standard_normal((9, nc)).astype(np.float32)
    jrows = jfused.block_diag_rows(jnp.asarray(Minv, jnp.bfloat16))
    want = _jax_strict(lambda h, v: jfused.fused_block_diag_apply(
        h, v, bf16_operands=ops, interpret=True), jrows, jnp.asarray(x))
    rows = tfused.block_diag_rows(torch.from_numpy(Minv).to(BF16))
    np.testing.assert_array_equal(rows.float().numpy(),
                                  np.asarray(jrows, np.float32))
    got = _check_arm(tfused.fused_block_diag_apply,
                     (rows, torch.from_numpy(x)), dict(bf16_operands=ops),
                     want)
    # Against the float32 product of the same bf16 blocks: within bf16
    # operand rounding.
    exact = np.einsum("nij,jn->in", rows.float().numpy().reshape(
        9, 9, nc).transpose(2, 0, 1), x)
    gap = np.linalg.norm(got.numpy() - exact) / np.linalg.norm(exact)
    assert gap < (1e-2 if ops else 1e-6), gap


def test_bf16_arm_rounds_where_the_mixed_arm_does_not():
    _, port_args, _ = implicit_case(5, np.float32, True, row_dtype=BF16)
    f = tfused.fused_coupling_apply_implicit
    assert not torch.equal(f(*port_args), f(*port_args, bf16_operands=True))


def test_precision_arm_operand_checks():
    _, (Jin, Jout, table, fplan), _ = implicit_case(5, np.float64, True,
                                                    row_dtype=BF16)
    f = tfused.fused_coupling_apply_implicit
    # bf16 rows beside an f64 table are the mixed64 arm; bf16 products
    # beside it are refused.
    assert f(Jin, Jout, table, fplan).dtype == torch.float64
    with pytest.raises(TypeError, match="bfloat16"):
        f(Jin, Jout, table, fplan, bf16_operands=True)
    with pytest.raises(TypeError, match="share"):  # one bf16, one f32 row
        f(Jin, Jout.float(), table.float(), fplan)
    with pytest.raises(TypeError, match="bf16_operands"):
        f(Jin.float(), Jout.float(), table.float(), fplan,
          bf16_operands=True)
    with pytest.raises(TypeError, match="dtype"):
        tfused.fused_block_diag_apply(torch.zeros(81, 4, dtype=BF16),
                                      torch.zeros(9, 4, dtype=BF16))


# ---------------------------------------------------------------------------
# PCG on the equilibrated system
# ---------------------------------------------------------------------------


def _f32_systems(kind, seed):
    """Both packages' float32 systems of one scene (cast from float64)."""
    f32 = np.float32
    if kind == "IMPLICIT":
        (jsys, jJc, jJp, ci, pi), (tsys, tJc, tJp, plans) = _systems(seed,
                                                                     True)
        tsys = schur_system_to_torch(jsys, device="cpu", dtype=torch.float32)
        tJc, tJp = tJc.float(), tJp.float()
    else:
        (jsys, jJc, jJp, ci, pi), (_, plans, perm) = _explicit_systems(seed,
                                                                       True)
        tsys = schur_system_to_torch(jsys, device="cpu", dtype=torch.float32,
                                     edge_perm=perm)
        tJc = tJp = None
    jsys = jax.tree_util.tree_map(lambda a: jnp.asarray(a, f32), jsys)
    jJc, jJp = jnp.asarray(jJc, f32), jnp.asarray(jJp, f32)
    return (jsys, jJc, jJp, ci, pi), (tsys, tJc, tJp,
                                      tfused.with_fused_plans(plans))


@pytest.mark.parametrize("rung,limit", [("bf16", 1e-2), ("mixed", 1e-4)])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_precision_schur_pcg_matches_jax(kind, rung, limit):
    (jsys, jJc, jJp, ci, pi), (tsys, tJc, tJp, plans) = _f32_systems(kind, 1)
    kw = dict(max_iter=50, tol=1e-6, refuse_ratio=1e30, tol_relative=True,
              mixed_precision=rung == "mixed", bf16=rung == "bf16")
    # Strongly damped regions: the solves stop on the relative tolerance
    # (floored at 1e-3 under bf16) within a few iterations, where the two
    # packages' f32 sums differ by ~1e-6; at weak damping the inexact
    # bf16 iterates drift apart with the block apply's other rounding
    # (JAX's unfused bf16 einsum keeps exact products).
    for region in (0.5, 2.0):
        ref = jpcg.schur_pcg_solve(
            jsys, jJc, jJp, ci, pi, jnp.asarray(region, jnp.float32),
            compute_kind=jc.ComputeKind[kind], **kw)
        got = tpcg.schur_pcg_solve(
            tsys, one(tJc), one(tJp), one_shard(plans),
            torch.tensor(region, dtype=torch.float32),
            compute_kind=mt.ComputeKind[kind], fused_kernels=True, **kw)
        assert got.dx_cam.dtype == got.dx_pt.dtype == torch.float32
        want = np.concatenate([np.asarray(ref.dx_cam).ravel(),
                               np.asarray(ref.dx_pt).ravel()])
        have = np.concatenate([got.dx_cam.numpy().ravel(),
                               got.dx_pt.numpy().ravel()])
        gap = np.linalg.norm(have - want) / np.linalg.norm(want)
        assert gap <= limit, (region, gap, got.iterations, int(ref.iterations))


def test_precision_rungs_need_fused_kernels():
    """No longer: both rungs run without fused kernels too (held to the
    JAX package by tests/test_torch_unfused_precision.py)."""
    _, (tsys, tJc, tJp, plans) = _f32_systems("IMPLICIT", 1)
    for kw in (dict(bf16=True), dict(mixed_precision=True)):
        got = tpcg.schur_pcg_solve(tsys, (tJc,), (tJp,), one_shard(plans),
                                   torch.tensor(1e3),
                                   **kw)
        assert got.dx_cam.dtype == torch.float32 and got.iterations > 0
        assert bool(torch.isfinite(got.dx_cam).all())


# ---------------------------------------------------------------------------
# The whole slice: flat_solve
# ---------------------------------------------------------------------------

_SCENE = dict(num_cameras=8, num_points=120, obs_per_point=3.5, seed=1,
              dtype=np.float32)


def _precision_option(kind, rung=None):
    return mt.ProblemOption(
        dtype=np.float32, jacobian_mode=mt.JacobianMode.ANALYTICAL,
        compute_kind=mt.ComputeKind[kind],
        mixed_precision_pcg=rung == "mixed",
        algo_option=mt.AlgoOption(max_iter=8, epsilon1=1e-12,
                                  epsilon2=1e-15),
        solver_option=mt.SolverOption(max_iter=50, tol=1e-8,
                                      tol_relative=True, fused_kernels=True,
                                      bf16=rung == "bf16"))


@pytest.mark.parametrize("rung", ["bf16", "mixed"])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_precision_flat_solve_in_band_and_live(kind, rung, monkeypatch):
    s = mt.make_synthetic_bal(**_SCENE)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    ref = mt.flat_solve(*args, _precision_option(kind), device="cpu")

    seen = []  # (kernel, row dtypes, bf16_operands) of every fused call
    for name in ("fused_coupling_apply_implicit", "fused_coupling_apply",
                 "fused_block_diag_apply"):
        real = getattr(tfused, name)

        def spy(*a, _real=real, _name=name, **k):
            rows = [t.dtype for t in a[:2 if "implicit" in _name else 1]]
            seen.append((_name, rows, k.get("bf16_operands", False)))
            return _real(*a, **k)

        monkeypatch.setattr(tfused, name, spy)
    expands = []
    real_expand = tseg.seg_expand
    monkeypatch.setattr(tseg, "seg_expand",
                        lambda *a: expands.append(a) or real_expand(*a))

    res = mt.flat_solve(*args, _precision_option(kind, rung), device="cpu")
    c0, c, c32 = float(res.initial_cost), float(res.cost), float(ref.cost)
    assert np.isfinite(c) and c < c0
    assert abs(c - c32) / c32 <= 2e-2, (c, c32)
    assert c != c32  # the rung changed the arithmetic

    coupling = ("fused_coupling_apply_implicit" if kind == "IMPLICIT"
                else "fused_coupling_apply")
    bf16 = rung == "bf16"
    products = [x for x in seen if x[0] == coupling]
    applies = [x for x in seen if x[0] == "fused_block_diag_apply"]
    assert products and applies and len(seen) == len(products) + len(applies)
    assert all(rows == [BF16] * len(rows) and ops == bf16
               for _, rows, ops in products)
    want_m = BF16 if bf16 else torch.float32
    assert all(rows == [want_m] and ops == bf16 for _, rows, ops in applies)
    # Two scale expansions (camera, point) per PCG solve.
    assert len(expands) == 2 * res.iterations


# ---------------------------------------------------------------------------
# Options
# ---------------------------------------------------------------------------


def _opt(**kw):
    so = kw.pop("solver_option", {})
    return tc.ProblemOption(jacobian_mode=tc.JacobianMode.ANALYTICAL,
                            solver_option=tc.SolverOption(**so), **kw)


F32 = np.float32
FUSED = dict(fused_kernels=True)


@pytest.mark.parametrize("kw", [
    dict(solver_option=FUSED),
    dict(dtype=F32, solver_option=FUSED),
    dict(dtype=F32, solver_option=dict(bf16=True, **FUSED)),
    dict(dtype=F32, compute_kind=tc.ComputeKind.EXPLICIT,
         solver_option=dict(bf16=True, **FUSED)),
    dict(dtype=F32, mixed_precision_pcg=True, solver_option=FUSED),
    dict(dtype=F32, mixed_precision_pcg=True,
         compute_kind=tc.ComputeKind.EXPLICIT, solver_option=FUSED),
], ids=["implicit_fused_f64", "implicit_fused_f32", "implicit_bf16",
        "explicit_bf16", "implicit_mixed", "explicit_mixed"])
def test_validate_options_accepts_fused_precision(kw):
    tc.validate_options(_opt(**kw))


@pytest.mark.parametrize("kw,err,match", [
    # Accepted since the unfused rungs and mixed at f64 were ported (err
    # None).
    (dict(dtype=F32, solver_option=dict(bf16=True)), None, None),
    (dict(dtype=F32, mixed_precision_pcg=True), None, None),
    (dict(solver_option=dict(bf16=True, **FUSED)), ValueError, "float64"),
    (dict(dtype=F32, mixed_precision_pcg=True,
          solver_option=dict(bf16=True, **FUSED)), ValueError, "pick one"),
    (dict(dtype=F32, solver_option=dict(bf16_collectives=True)), ValueError,
     "requires SolverOption.bf16"),
    # Accepted since the multi-device solve was ported (err None).
    (dict(dtype=F32, solver_option=dict(bf16=True, bf16_collectives=True,
                                        **FUSED)), None, None),
    (dict(dtype=F32, use_schur=False, solver_option=dict(bf16=True)),
     ValueError, "Schur solver"),
    (dict(use_schur=False, mixed_precision_pcg=True), ValueError,
     "Schur solver"),
    (dict(mixed_precision_pcg=True, solver_option=FUSED), None, None),
], ids=["bf16_unfused", "mixed_unfused", "bf16_f64", "bf16_and_mixed",
        "collectives_without_bf16", "bf16_collectives", "bf16_plain_solver",
        "mixed_plain_solver", "mixed_f64"])
def test_validate_options_refuses_precision(kw, err, match):
    if err is None:
        tc.validate_options(_opt(**kw))
        return
    with pytest.raises(err, match=match):
        tc.validate_options(_opt(**kw))


def test_precision_refusal_fires_before_planning():
    """flat_solve refuses the option before it reads the arrays.  The
    bf16 rung with bf16 collectives and metrics are ported; the refusal
    held here is the precision ladder's ValueError for bf16 at f64."""
    opt = _opt(metrics=True, solver_option=dict(
        bf16=True, bf16_collectives=True))
    with pytest.raises(ValueError, match="float64"):
        mt.flat_solve(None, None, None, None, None, opt, device="cpu")

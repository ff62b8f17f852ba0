"""The SCHUR_DIAG block diagonal and the NEUMANN family in the port vs the
JAX package, float64.

- `_schur_diag_precond` (the true Schur block diagonal, inverted, with
  its counted fallback) against JAX's at rtol 1e-12: IMPLICIT, EXPLICIT
  and bfloat16 coupling rows (a mixed rung's operands) at float64;
- the two-camera fallback case of tests/test_robustness.py: an
  indefinite Schur block falls back to the Hpp inverse and is counted;
- the NEUMANN apply against JAX's on both block diagonals;
- `flat_solve` with SCHUR_DIAG and with NEUMANN (order 2) against JAX's
  unfused solve at rtol 1e-9 on the four kinds (IMPLICIT / EXPLICIT,
  fused kernels off / on), with equal accept patterns and counts, and
  the `precond_fallback` trace under an Hll crush equal to JAX's;
- the fallback code's encode / decode round trip.

CPU only.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import megba_tpu.common as jc
from megba_tpu.robustness import faults as jfaults
from megba_tpu.solver import precond as jprecond

import megba_tpu_torch as mt
from megba_tpu_torch.convert import fault_plan_to_torch
from megba_tpu_torch.core.fm import block_inv_fm, damp_rows_fm
from megba_tpu_torch.linear_system.builder import damp_blocks
from megba_tpu_torch.ops import segtiles as tseg
from megba_tpu_torch.parallel.mesh import one_shard
from megba_tpu_torch.solver import precond as tprecond

from test_torch_guards import _args, _jax_solve, _options, _scene
from test_torch_guards import compare_robust
from test_torch_plain_pcg import _carried

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

IMPLICIT, EXPLICIT = mt.ComputeKind.IMPLICIT, mt.ComputeKind.EXPLICIT


def _damped(kind, seed, region=2.0):
    """The carried system damped at `region`: JAX's (Hpp_d, Hll^-1) and
    the port's, with both packages' coupling operands (the port's on the
    mesh of one shard)."""
    (jsys, jJc, jJp, ci, pi), (tsys, tJc, tJp, plans) = _carried(kind, seed)
    t_region = torch.tensor(region, dtype=torch.float64)
    Hpp_d = damp_blocks(tsys.Hpp, t_region)
    Hll_inv = block_inv_fm(damp_rows_fm(tsys.Hll, t_region))
    jside = (jnp.asarray(Hpp_d.numpy()), jnp.asarray(Hll_inv.numpy()),
             jsys.W, jJc, jJp, ci, pi)
    return jside, (Hpp_d, Hll_inv, tsys.W, (tJc,), (tJp,), one_shard(plans))


@pytest.mark.parametrize("rows", ["f64", "bf16"])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_schur_diag_precond_matches_jax(kind, rows):
    (jH, jHi, jW, jJc, jJp, ci, pi), (H, Hi, W, Jc, Jp, plans) = _damped(
        kind, 0)
    if rows == "bf16":  # a rung's rows: both packages upcast them
        bf = torch.bfloat16
        W = None if W is None else (W[0].to(bf),)
        Jc, Jp = (Jc[0].to(bf),), (Jp[0].to(bf),)
        jW = None if jW is None else jnp.asarray(jW).astype(jnp.bfloat16)
        jJc = jnp.asarray(jJc).astype(jnp.bfloat16)
        jJp = jnp.asarray(jJp).astype(jnp.bfloat16)
    want, want_bad = jprecond._schur_diag_precond(
        jH, jHi, jW, jJc, jJp, ci, pi, H.shape[0], jc.ComputeKind[kind],
        None, False)
    got, bad = tprecond._schur_diag_precond(H, Hi, W, Jc, Jp, plans,
                                            mt.ComputeKind[kind])
    want = np.asarray(want)
    assert int(bad) == int(want_bad) == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    # It differs from the Hpp inverse: the correction is live.
    assert not np.allclose(got.numpy(), tprecond.block_inv(H).numpy())


def test_schur_diag_precond_fallback_is_counted():
    """Two cameras, one point, one edge each; camera 0's correction
    overwhelms its Hpp block (huge Hll^-1): indefinite Schur diagonal,
    Cholesky NaN, counted fallback to the Hpp inverse."""
    cd, pd = 2, 2
    Hpp_d = torch.from_numpy(np.stack([np.eye(cd), 4 * np.eye(cd)]))
    Hll_inv = torch.from_numpy(np.eye(pd).reshape(pd * pd, 1) * 1e6)
    W = torch.tensor([[1.0, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]],
                     dtype=torch.float64)  # only camera 0's edge couples
    _, plans = tseg.make_dual_plans(np.array([0, 1]), np.zeros(2, int), 2, 1,
                                    "cpu")
    minv, n_bad = tprecond._schur_diag_precond(Hpp_d, Hll_inv, (W,), None,
                                               None, one_shard(plans),
                                               EXPLICIT)
    want, want_bad = jprecond._schur_diag_precond(
        jnp.asarray(Hpp_d.numpy()), jnp.asarray(Hll_inv.numpy()),
        jnp.asarray(W.numpy()), None, None, jnp.asarray([0, 1]),
        jnp.asarray([0, 0]), 2, jc.ComputeKind.EXPLICIT, None, False)
    assert int(n_bad) == int(want_bad) == 1
    assert torch.equal(minv[0], tprecond.block_inv(Hpp_d)[0])
    assert torch.isfinite(minv).all()
    np.testing.assert_allclose(minv.numpy(), np.asarray(want), rtol=1e-14)


@pytest.mark.parametrize("block", ["HPP", "SCHUR_DIAG"])
def test_neumann_apply_matches_jax(block):
    (jH, jHi, jW, jJc, jJp, ci, pi), (H, Hi, W, Jc, Jp, plans) = _damped(
        "IMPLICIT", 1)
    nc = H.shape[0]
    rng = np.random.default_rng(3)
    A = rng.standard_normal((9 * nc, 9 * nc))
    S = A @ A.T / (9 * nc) + np.kron(np.eye(nc), np.ones((9, 9))) + np.eye(
        9 * nc)  # an SPD stand-in for the Schur complement

    r = rng.standard_normal((9, nc))
    apply, code = tprecond.make_schur_preconditioner(
        mt.PrecondKind.NEUMANN, mt.PreconditionerKind[block], H, Hi, W, Jc,
        Jp, plans, IMPLICIT, neumann_order=2,
        s_matvec=lambda z: (torch.from_numpy(S) @ z.T.reshape(-1)).reshape(
            nc, 9).T.contiguous())
    japply, jcode = jprecond.make_schur_preconditioner(
        jc.PrecondKind.NEUMANN, jc.PreconditionerKind[block], jH, jHi, jW,
        jJc, jJp, ci, pi, nc, jc.ComputeKind.IMPLICIT, None, False,
        neumann_order=2,
        s_matvec=lambda z: (jnp.asarray(S) @ z.T.reshape(-1)).reshape(
            nc, 9).T)
    got = apply(torch.from_numpy(r))
    want = np.asarray(japply(jnp.asarray(r)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    assert int(code) == int(jcode) == 0
    # Order 2 is not the base apply.
    base, _ = tprecond.make_schur_preconditioner(
        mt.PrecondKind.JACOBI, mt.PreconditionerKind[block], H, Hi, W, Jc,
        Jp, plans, IMPLICIT)
    assert not torch.allclose(base(torch.from_numpy(r)), got)


_KINDS = [("IMPLICIT", False), ("EXPLICIT", False), ("IMPLICIT", True),
          ("EXPLICIT", True)]
_PRECONDS = {
    "schur_diag": dict(preconditioner=mt.PreconditionerKind.SCHUR_DIAG),
    "neumann": dict(precond=mt.PrecondKind.NEUMANN, neumann_order=2)}


@pytest.mark.parametrize("kind,fused", _KINDS)
@pytest.mark.parametrize("name", list(_PRECONDS))
def test_flat_solve_with_preconditioner_matches_jax(name, kind, fused):
    s = _scene()
    jopt, topt = _options(False, kind, fused, **_PRECONDS[name])
    jres = _jax_solve(_args(s), jopt)
    tres = mt.flat_solve(None, *_args(s), topt, device="cpu")
    t = compare_robust(jres, tres)
    assert float(tres.cost) < float(tres.initial_cost)
    assert not t["trace"]["precond_fallback"].any()


def test_precond_fallback_trace_under_crush_matches_jax():
    s = _scene()
    plan = jfaults.make_point_indefinite_burst(
        120, list(range(8)), start=2, stop=3, n_edges=s.obs.shape[0])
    jopt, topt = _options(True, **_PRECONDS["schur_diag"])
    jres = _jax_solve(_args(s), jopt, fault_plan=plan)
    tres = mt.flat_solve(None, *_args(s), topt, device="cpu",
                         fault_plan=fault_plan_to_torch(plan))
    t = compare_robust(jres, tres)
    assert t["trace"]["precond_fallback"].sum() >= 1


@pytest.mark.parametrize("block,coarse", [(0, 0), (5, 0), (70_000, 1),
                                          (3, 0b101)])
def test_fallback_code_round_trip_matches_jax(block, coarse):
    code = tprecond.encode_precond_fallback(block, coarse)
    jcode = int(jprecond.encode_precond_fallback(block, coarse))
    assert code == jcode
    assert int(tprecond.encode_precond_fallback(
        torch.tensor(block), coarse)) == jcode
    assert tprecond.decode_precond_fallback(code) == \
        jprecond.decode_precond_fallback(jcode)
    assert tprecond.decode_precond_fallback_levels(code) == \
        jprecond.decode_precond_fallback_levels(jcode)
    assert tprecond.decode_precond_fallback(code)["block"] == min(
        block, tprecond.FALLBACK_BLOCK_RADIX - 1)

"""The port's fused explicit-Schur kernels vs the JAX package.

- `fused_coupling_apply` (plain version on the CPU) against the JAX
  `fused_coupling_apply` Pallas kernel in interpret mode and against its
  XLA oracle `reference_coupling_apply`, in both directions
  (`w_in_major` True: camera table -> points; False: point table ->
  cameras), float32 and float64, with masked edges;
- `block_diag_rows` + `fused_block_diag_apply` against the JAX kernel in
  interpret mode;
- the per-direction plans (`with_fused_plans`) and the wrappers' operand
  checks.

The JAX kernels walk a bucket plan of padded tiles; the port's walk the
output side's CSR segments of the dual plans, so each test maps both to
the caller's edge order.  CPU only; the CUDA kernels are held to the
same plain versions by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megba_tpu.ops import fused as jfused

from megba_tpu_torch.ops import fused as tfused
from megba_tpu_torch.ops import segtiles as tseg


def _graph(ne=500, ni=30, no=80, seed=1):
    """The JAX fused-kernel tests' graph: random in/out ids, ~10 % of
    the edges masked off."""
    rng = np.random.default_rng(seed)
    in_idx = rng.integers(0, ni, ne).astype(np.int32)
    out_idx = rng.integers(0, no, ne).astype(np.int32)
    mask = (rng.random(ne) > 0.1).astype(np.float32)
    return in_idx, out_idx, mask


def _port_direction(in_idx, out_idx, ni, no, w_in_major):
    """The port's plan of one direction, and the edge order its W must
    be in.  w_in_major: the input is the camera side (cam -> pt);
    otherwise the input is the point side (pt -> cam)."""
    if w_in_major:
        plan_c, plans = tseg.make_dual_plans(in_idx, out_idx, ni, no, "cpu")
        plans = tfused.with_fused_plans(plans)
        # W in point-slot order: cam slots, then the cross permute.
        order = plan_c.perm[plans.pt.inv.numpy()]
        return plans.fused_to_pt, order
    plan_c, plans = tseg.make_dual_plans(out_idx, in_idx, no, ni, "cpu")
    plans = tfused.with_fused_plans(plans)
    return plans.fused_to_cam, plan_c.perm


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("w_in_major", [True, False])
def test_fused_coupling_apply_matches_jax(dtype, w_in_major):
    rng = np.random.default_rng(1)
    ni, no = 30, 80
    in_idx, out_idx, mask = _graph(ni=ni, no=no)
    d_in, d_out = (9, 3) if w_in_major else (3, 9)
    W = (rng.standard_normal((27, 500)) * mask).astype(dtype)
    table = rng.standard_normal((d_in, ni)).astype(dtype)

    jplan = jfused.build_fused_plan(in_idx, out_idx, mask, ni, no, tile=32,
                                    in_block=16, out_block=32)
    dplan = jfused.device_fused_plan(jplan)
    jW, jt = jnp.asarray(W), jnp.asarray(table)
    kern = np.asarray(jfused.fused_coupling_apply(
        jfused.permute_rows(jW, dplan), jt, dplan, w_in_major=w_in_major,
        interpret=True))
    oracle = np.asarray(jfused.reference_coupling_apply(
        jW, jt, in_idx, out_idx, no, w_in_major, d_in))

    fplan, order = _port_direction(in_idx, out_idx, ni, no, w_in_major)
    got = tfused.fused_coupling_apply(
        torch.from_numpy(np.ascontiguousarray(W[:, order])),
        torch.from_numpy(table), fplan, w_in_major).numpy()
    assert got.dtype == dtype and got.shape == (d_out, no)
    tol = 1e-6 if dtype == np.float32 else 1e-12
    for want in (kern, oracle):
        err = np.max(np.abs(got - want)) / (1.0 + np.max(np.abs(want)))
        assert err < tol, err


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-13)])
@pytest.mark.parametrize("nc", [7, 600])
def test_fused_block_diag_apply_matches_jax(dtype, tol, nc):
    rng = np.random.default_rng(nc)
    A = rng.standard_normal((nc, 9, 9))
    Minv = (A @ A.transpose(0, 2, 1) + 9 * np.eye(9)).astype(dtype)
    x = rng.standard_normal((9, nc)).astype(dtype)
    jrows = jfused.block_diag_rows(jnp.asarray(Minv))
    want = np.asarray(jfused.fused_block_diag_apply(jrows, jnp.asarray(x),
                                                    interpret=True))
    rows = tfused.block_diag_rows(torch.from_numpy(Minv))
    assert rows.is_contiguous() and rows.shape == (81, nc)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    got = tfused.fused_block_diag_apply(rows, torch.from_numpy(x)).numpy()
    assert got.dtype == dtype
    err = np.max(np.abs(got - want)) / (1.0 + np.max(np.abs(want)))
    assert err < tol, err
    np.testing.assert_allclose(got, np.einsum("nij,jn->in", Minv, x),
                               rtol=10 * tol, atol=10 * tol)


@pytest.mark.parametrize("seed", [0, 1])
def test_with_fused_plans_index_the_other_side(seed):
    """Each direction's input id per output-order slot is the edge's
    vertex on the other side, and the output plan is the other side's."""
    rng = np.random.default_rng(seed)
    nc, npt, n = 7, 60, 300
    cam_idx = rng.integers(0, nc, n).astype(np.int32)
    pt_idx = rng.integers(0, npt, n).astype(np.int32)
    plan_c, plans = tseg.make_dual_plans(cam_idx, pt_idx, nc, npt, "cpu")
    assert plans.fused_to_pt is None and plans.fused_to_cam is None
    plans = tfused.with_fused_plans(plans)
    tp, tc = plans.fused_to_pt, plans.fused_to_cam
    cam_slots = plan_c.perm  # cam slot -> caller edge
    pt_slots = cam_slots[plans.pt.inv.numpy()]  # pt slot -> caller edge
    np.testing.assert_array_equal(tp.in_idx.numpy(), cam_idx[pt_slots])
    np.testing.assert_array_equal(tc.in_idx.numpy(), pt_idx[cam_slots])
    assert tp.out is plans.pt and tc.out is plans.cam
    assert (tp.num_in, tc.num_in) == (nc, npt)
    assert tp.in_idx.dtype == tc.in_idx.dtype == torch.int32
    assert tp.in_idx.is_contiguous() and tc.in_idx.is_contiguous()


def test_fused_wrappers_validate_operands():
    in_idx, out_idx, _ = _graph()
    fplan, _ = _port_direction(in_idx, out_idx, 30, 80, True)
    W = torch.zeros(27, 500, dtype=torch.float64)
    table = torch.zeros(9, 30, dtype=torch.float64)
    with pytest.raises(ValueError, match="disagree"):
        tfused.fused_coupling_apply(W[:, :-1].contiguous(), table, fplan,
                                    True)
    with pytest.raises(ValueError, match="disagree"):
        tfused.fused_coupling_apply(W, table[:, :-1].contiguous(), fplan,
                                    True)
    with pytest.raises(TypeError, match="dtype"):
        tfused.fused_coupling_apply(W, table.float(), fplan, True)
    with pytest.raises(ValueError, match="contiguous"):
        tfused.fused_coupling_apply(W, torch.zeros(30, 9).double().T, fplan,
                                    True)
    rows = torch.zeros(81, 5, dtype=torch.float64)
    with pytest.raises(ValueError, match="disagree"):
        tfused.fused_block_diag_apply(rows, torch.zeros(9, 4).double())
    with pytest.raises(TypeError, match="dtype"):
        tfused.fused_block_diag_apply(rows, torch.zeros(9, 5))


def test_fused_matvecs_need_fused_plans():
    from megba_tpu_torch.common import ComputeKind
    from megba_tpu_torch.solver.pcg import make_coupling_matvecs

    in_idx, out_idx, _ = _graph()
    _, plans = tseg.make_dual_plans(in_idx, out_idx, 30, 80, "cpu")
    W = torch.zeros(27, 500, dtype=torch.float64)
    with pytest.raises(ValueError, match="with_fused_plans"):
        make_coupling_matvecs(None, None, plans, ComputeKind.EXPLICIT, W,
                              fused_kernels=True)
    with pytest.raises(ValueError, match="with_fused_plans"):
        make_coupling_matvecs(W, W, plans, ComputeKind.IMPLICIT,
                              fused_kernels=True)

"""The registered factor families' non-default Schur paths vs the JAX
package, and kernels 4-8's plain versions at the families' shapes.

float64 (the conftest enables x64 for JAX), CPU only:

- for planar, rig, pinhole_radial and pose_prior, `flat_solve(...,
  factor=...)` on EXPLICIT, IMPLICIT with fused kernels, EXPLICIT with
  fused kernels, the SCHUR_DIAG block diagonal, the TWO_LEVEL coarse
  space and `mixed_precision_pcg`, each against the JAX package's
  `flat_solve(None, ..., factor=...)` with the same options: trial costs
  at rtol 1e-9, equal accept pattern, LM / PCG counts and status, an LM
  cap of 3 (the tiny scenes reach their cost floor at the fourth).  JAX
  refuses `fused_kernels=True` at float64, so the port's fused paths are
  held to JAX's unfused solves of the same options; mixed at float64
  starts from trust region 1 (chip_smoke.solve_option says why; the
  pose prior from 1e3, `_option`);
- the plain versions of kernels 8 and 7 (both directions) at each
  family's (cd, pd, od) against the JAX package's XLA oracle
  `reference_coupling_apply` at float64 and its Pallas kernels in
  interpret mode at float32; kernel 4 at F = 1, 2, 4, 7, 12 against the
  JAX `_reduce_kernel` in interpret mode; kernel 6 at d = 4, 6, 7, 12
  against the JAX `_block_diag_kernel` in interpret mode.

tests/test_torch_cuda.py runs the same paths and shapes through the
kernels on the card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megba_tpu.common as jc
from megba_tpu.ops import fused as jfused
from megba_tpu.ops import segtiles as jseg
from megba_tpu.solve import flat_solve as j_flat_solve

import megba_tpu_torch as mt
from megba_tpu_torch.factors import get_factor
from megba_tpu_torch.ops import fused as tfused
from megba_tpu_torch.ops import segtiles as tseg

from test_torch_explicit import _jax_slots, _plans, _port_slots, _segment_ids
from test_torch_factors import LM_CAP, _scene
from test_torch_solve import _compare

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

FAMILIES = ["planar", "rig", "pinhole_radial", "pose_prior"]
# path -> (ProblemOption fields, SolverOption fields, the port's
# fused_kernels); both packages take the same fields otherwise.
PATHS = {
    "explicit": (dict(compute_kind="EXPLICIT"), {}, False),
    "implicit_fused": ({}, {}, True),
    "explicit_fused": (dict(compute_kind="EXPLICIT"), {}, True),
    "schur_diag": ({}, dict(preconditioner="SCHUR_DIAG"), False),
    "two_level": ({}, dict(precond="TWO_LEVEL"), False),
    "mixed": (dict(mixed_precision_pcg=True), {}, False),
}


def _option(pkg, name, path, fused=False):
    """ProblemOption() with the path's fields, in package `pkg` (jc or
    mt), under the LM cap.  Mixed starts from trust region 1 (but the
    8-pose prior scene, which from there stops after one LM iteration;
    its mixed trajectory from 1e3 is not chaotic)."""
    problem, solver, _ = PATHS[path]
    mixed = problem.get("mixed_precision_pcg", False)
    region = 1.0 if mixed and name != "pose_prior" else 1e3
    kind = pkg.ComputeKind[problem.get("compute_kind", "IMPLICIT")]
    so = dict(fused_kernels=fused)
    if "preconditioner" in solver:
        so["preconditioner"] = pkg.PreconditionerKind[solver["preconditioner"]]
    if "precond" in solver:
        so["precond"] = pkg.PrecondKind[solver["precond"]]
    return pkg.ProblemOption(
        compute_kind=kind, mixed_precision_pcg=mixed,
        algo_option=pkg.AlgoOption(max_iter=LM_CAP, epsilon1=1e-12,
                                   epsilon2=1e-15,
                                   initial_region=region),
        solver_option=pkg.SolverOption(**so))


# JAX solves the fused paths unfused: EXPLICIT fused shares the EXPLICIT
# path's solve (one XLA compile each).
_JAX_PATH = {"explicit_fused": "explicit"}


@functools.lru_cache(maxsize=None)
def _jax_solve(name, path):
    s = _scene(name)
    return j_flat_solve(None, s.cameras0, s.points0, s.obs, s.cam_idx,
                        s.pt_idx, _option(jc, name, path), factor=name)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("name", FAMILIES)
def test_family_path_matches_jax(name, path):
    s = _scene(name)
    opt = _option(mt, name, path, fused=PATHS[path][2])
    tres = mt.flat_solve(None,
                         s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
                         opt, device="cpu", factor=name)
    jres = _jax_solve(name, _JAX_PATH.get(path, path))
    assert int(jres.iterations) >= 2
    t = _compare(jres, tres, cost_rtol=1e-9)
    spec = get_factor(name)
    assert t["cameras"].shape == (s.cameras0.shape[0], spec.cam_dim)
    assert float(tres.cost) < float(tres.initial_cost)


# ---------------------------------------------------------------------------
# Kernels 4-8's plain versions at the families' shapes
# ---------------------------------------------------------------------------

# (cd, pd, od) of each family beside BAL, as csrc/fused_shapes.cuh lists
# them.
COUPLINGS = [(4, 2, 1), (7, 3, 2), (12, 3, 2), (6, 3, 6), (6, 3, 2)]


def _graph(nc, npt, n=400, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, nc, n).astype(np.int32),
            rng.integers(0, npt, n).astype(np.int32))


def _direction(cam_idx, pt_idx, nc, npt, cam_to_pt):
    """The port's plan of one direction, the caller-order edge of each of
    its slots, and the (in, out) ids with their vertex counts."""
    plan_c, plans = tseg.make_dual_plans(cam_idx, pt_idx, nc, npt, "cpu")
    plans = tfused.with_fused_plans(plans)
    if cam_to_pt:
        return (plans.fused_to_pt, plan_c.perm[plans.pt.inv.numpy()],
                (cam_idx, pt_idx, nc, npt))
    return plans.fused_to_cam, plan_c.perm, (pt_idx, cam_idx, npt, nc)


def _err(got, want):
    return np.max(np.abs(got - want)) / (1.0 + np.max(np.abs(want)))


@pytest.mark.parametrize("cd,pd,od", COUPLINGS,
                         ids=[f"{c}x{p}x{o}" for c, p, o in COUPLINGS])
def test_coupling_plain_versions_match_jax_at_family_shapes(cd, pd, od):
    """Kernels 8 and 7 in both directions: the port's plain versions
    against JAX's XLA oracle at float64 (1e-12) and its Pallas kernels
    in interpret mode at float32 (1e-5, test_torch_slot_tiles.py's f32
    rule)."""
    nc, npt = 12, 40
    cam_idx, pt_idx = _graph(nc, npt)
    rng = np.random.default_rng(cd * 100 + od)
    n = cam_idx.shape[0]
    W = 0.1 * rng.standard_normal((cd * pd, n))
    Jc = 0.3 * rng.standard_normal((od * cd, n))
    Jp = 0.3 * rng.standard_normal((od * pd, n))
    for cam_to_pt in (True, False):
        fplan, order, (in_idx, out_idx, ni, no) = _direction(
            cam_idx, pt_idx, nc, npt, cam_to_pt)
        d_in, d_out = (cd, pd) if cam_to_pt else (pd, cd)
        Jin, Jout = (Jc, Jp) if cam_to_pt else (Jp, Jc)
        # W_e = Jin_e^T Jout_e, input-major: the oracle of kernel 7.
        Wj = np.stack([sum(Jin[o * d_in + a] * Jout[o * d_out + b]
                           for o in range(od))
                       for a in range(d_in) for b in range(d_out)])
        table = rng.standard_normal((d_in, ni))
        jplan = jfused.device_fused_plan(jfused.build_fused_plan(
            in_idx, out_idx, np.ones(n, np.float32), ni, no, tile=32,
            in_block=16, out_block=32))
        for dtype, tol in ((np.float64, 1e-12), (np.float32, 1e-5)):
            def rows(a):
                return torch.from_numpy(
                    np.ascontiguousarray(a[:, order].astype(dtype)))

            tt = torch.from_numpy(table.astype(dtype))
            got8 = tfused.fused_coupling_apply(rows(W), tt, fplan,
                                               cam_to_pt).numpy()
            got7 = tfused.fused_coupling_apply_implicit(
                rows(Jin), rows(Jout), tt, fplan).numpy()
            assert got8.shape == got7.shape == (d_out, no)
            assert got8.dtype == got7.dtype == dtype
            jt = jnp.asarray(table.astype(dtype))
            if dtype == np.float64:
                want8 = jfused.reference_coupling_apply(
                    jnp.asarray(W), jt, in_idx, out_idx, no, cam_to_pt, d_in)
                want7 = jfused.reference_coupling_apply(
                    jnp.asarray(Wj), jt, in_idx, out_idx, no, True, d_in)
            else:
                want8 = jfused.fused_coupling_apply(
                    jfused.permute_rows(jnp.asarray(W, jnp.float32), jplan),
                    jt, jplan, w_in_major=cam_to_pt, interpret=True)
                want7 = jfused.fused_coupling_apply_implicit(
                    jfused.permute_rows(jnp.asarray(Jin, jnp.float32), jplan),
                    jfused.permute_rows(jnp.asarray(Jout, jnp.float32),
                                        jplan), jt, jplan, interpret=True)
            assert _err(got8, np.asarray(want8)) < tol
            assert _err(got7, np.asarray(want7)) < tol


@pytest.mark.parametrize("F", [1, 2, 4, 7, 12])
def test_seg_reduce_plain_matches_jax_at_family_widths(F):
    """Kernel 4 at the families' widths (and a remainder of the coarse
    builds' nine-row groups) against the JAX `_reduce_kernel` in
    interpret mode, at float32."""
    ns = 40
    idx = _segment_ids(F, ns)
    jplan, jdp, hplan, tplan = _plans(idx, ns, F)
    data = np.random.default_rng(F).standard_normal(
        (F, idx.shape[0])).astype(np.float32)
    want = jseg.tile_reduce(_jax_slots(data, jplan), jdp, interpret=True)
    got = tseg.seg_reduce(_port_slots(data, hplan), tplan)
    assert got.shape == (F, ns) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert F in tseg.SUPPORTED_WIDTHS


@pytest.mark.parametrize("d", [4, 6, 7, 12])
def test_block_diag_plain_matches_jax_at_family_widths(d):
    """Kernel 6 at the families' camera widths against the JAX
    `_block_diag_kernel` in interpret mode (float32 and float64: the
    Pallas kernel computes in the rows' dtype on the CPU)."""
    nc = 50
    rng = np.random.default_rng(d)
    A = rng.standard_normal((nc, d, d))
    Minv = A @ A.transpose(0, 2, 1) + d * np.eye(d)
    x = rng.standard_normal((d, nc))
    assert d in tfused.SUPPORTED_BLOCK_DIAG
    for dtype, tol in ((np.float32, 1e-6), (np.float64, 1e-13)):
        jrows = jfused.block_diag_rows(jnp.asarray(Minv.astype(dtype)))
        want = np.asarray(jfused.fused_block_diag_apply(
            jrows, jnp.asarray(x.astype(dtype)), interpret=True))
        rows = tfused.block_diag_rows(torch.from_numpy(Minv.astype(dtype)))
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
        got = tfused.fused_block_diag_apply(
            rows, torch.from_numpy(x.astype(dtype))).numpy()
        assert got.dtype == dtype and got.shape == (d, nc)
        assert _err(got, want) < tol


def test_shape_lists_cover_every_family():
    """The lists read from csrc/fused_shapes.cuh hold every registered
    camera/point family's directions, and kernels 4-5 every width up to
    the widest block a Problem edge may have."""
    for name in ["bal"] + FAMILIES:
        spec = get_factor(name)
        cd, pd, od = spec.cam_dim, spec.pt_dim, spec.residual_dim
        assert {(cd, pd, True), (pd, cd, False)} <= set(
            tfused.SUPPORTED_DIRECTIONS)
        assert {(cd, pd, od), (pd, cd, od)} <= set(tfused.SUPPORTED_IMPLICIT)
        assert cd in tfused.SUPPORTED_BLOCK_DIAG
    assert tseg.SUPPORTED_WIDTHS == tuple(
        range(1, tseg.MAX_BUILT_BLOCK[1] + 1))

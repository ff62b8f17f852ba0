"""Port segment kernels vs the JAX package's Pallas kernels.

The three kernels of the implicit-Schur path (`jtj_grad_reduce`,
`coupling_expand`, `coupling_reduce`) in their plain PyTorch versions,
against the JAX kernels run in Pallas interpret mode at float32, on
both sides (camera d=9, point d=3) with empty, one-edge and long
segments.  At float64 `jtj_grad_reduce` is held to the JAX fallback;
the JAX coupling kernels compute in float32 only (the JAX package takes
its unplanned `core.fm` gather/segment-sum path at float64), so the two
coupling kernels are held to that composition there.  Also the dual-plan
lowering: the port's CSR plans order the real edges exactly as the JAX
tile plans do.  CPU only; the CUDA kernels are held to the same plain
versions by chip_smoke.py on the card (and by tests/test_torch_cuda.py).

The factor families' block shapes, (od, d) = (1, 4), (1, 2), (2, 7),
(2, 12), (6, 6), (6, 3) and the (2, 6) of a Problem edge on a pose
camera, go through the same comparisons: at float32 against the Pallas
kernels in interpret mode, at float64 at 1e-12 against the JAX
package's float64 lowering (the Pallas kernels compute in float32
whatever their inputs' dtype, so they agree with an f64 sum to ~1e-7
only).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megba_tpu.core import fm as jfm
from megba_tpu.ops import segtiles as jseg

from megba_tpu_torch.ops import segtiles as tseg

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

# f32: the interpret-mode kernels sum each segment in another order than
# index_add_, so outputs agree to a few ulps of the segment's magnitude.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# f64: the same terms, reordered; far below any solver tolerance.
F64_TOL = dict(rtol=1e-12, atol=1e-12)


def _segment_ids(seed, num_segments):
    """Ids with an empty segment, a one-edge segment and a long one,
    the rest 0..7 edges each, shuffled into edge order."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 8, num_segments)
    counts[0], counts[1], counts[2] = 0, 1, 300
    idx = np.repeat(np.arange(num_segments), counts)
    return idx[rng.permutation(idx.shape[0])].astype(np.int32)


def _plans(idx, num_segments, d):
    """The JAX tile plan and the port's CSR plan of the same ids."""
    tile, block = (128, 8) if d == 9 else (64, 16)
    jplan = jseg.build_tile_plan(idx, num_segments, tile, block)
    hplan = tseg.build_seg_plan(idx, num_segments)
    tplan = tseg.device_plan(hplan, np.zeros_like(hplan.perm), "cpu")
    return jplan, jseg.device_plan(jplan), hplan, tplan


def _inputs(seed, n, num_segments, d, dtype, od=2):
    """Jacobian rows scaled so a 300-edge segment sums to O(1)."""
    rng = np.random.default_rng(seed + 100)
    J = (0.1 * rng.standard_normal((od * d, n))).astype(dtype)
    r = rng.standard_normal((od, n)).astype(dtype)
    table = rng.standard_normal((d, num_segments)).astype(dtype)
    return J, r, table


def _jax_slots(a, jplan):
    return jnp.asarray((a[:, jplan.perm] * jplan.mask).astype(a.dtype))


def _port_slots(a, hplan):
    return torch.from_numpy(np.ascontiguousarray(a[:, hplan.perm]))


CASES = [(dtype, d, seed) for dtype in (np.float32, np.float64)
         for d in (9, 3) for seed in (0, 1)]


def _jax_mode(dtype):
    # f32: the Pallas kernel in interpret mode; f64: the XLA fallback.
    if dtype == np.float32:
        return dict(use_kernels=False, interpret=True), F32_TOL
    return dict(use_kernels=False, interpret=False), F64_TOL


@pytest.mark.parametrize("dtype,d,seed", CASES)
def test_jtj_grad_reduce_matches_jax(dtype, d, seed):
    ns = 40
    idx = _segment_ids(seed, ns)
    jplan, jdp, hplan, tplan = _plans(idx, ns, d)
    J, r, _ = _inputs(seed, idx.shape[0], ns, d, dtype)
    mode, tol = _jax_mode(dtype)
    jh, jg = jseg.jtj_grad_reduce(_jax_slots(J, jplan), _jax_slots(r, jplan),
                                  jdp, **mode)
    th, tg = tseg.jtj_grad_reduce(_port_slots(J, hplan),
                                  _port_slots(r, hplan), tplan)
    assert th.dtype == torch.from_numpy(J).dtype
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **tol)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **tol)
    # The empty segment sums to exactly zero.
    assert not th[:, 0].any() and not tg[:, 0].any()


@pytest.mark.parametrize("dtype,d,seed", CASES)
def test_coupling_expand_matches_jax(dtype, d, seed):
    ns = 40
    idx = _segment_ids(seed, ns)
    jplan, jdp, hplan, tplan = _plans(idx, ns, d)
    n = idx.shape[0]
    J, _, table = _inputs(seed, n, ns, d, dtype)
    tu = tseg.coupling_expand(torch.from_numpy(table),
                              _port_slots(J, hplan), tplan, d).numpy()
    if dtype == np.float32:
        ju = np.asarray(jseg.coupling_expand(
            jnp.asarray(table), _jax_slots(J, jplan), jdp, d,
            use_kernels=False, interpret=True))
        # Back to edge order: the two plans order slots differently.
        real = jplan.mask > 0
        j_edges = np.empty((2, n), ju.dtype)
        j_edges[:, jplan.perm[real]] = ju[:, real]
        tol = F32_TOL
    else:
        pe = jfm.gather_fm(jnp.asarray(table), jnp.asarray(idx))
        j_edges = np.asarray(jnp.stack([
            sum(jnp.asarray(J[o * d + a]) * pe[a] for a in range(d))
            for o in range(2)]))
        tol = F64_TOL
    t_edges = np.empty_like(tu)
    t_edges[:, hplan.perm] = tu
    np.testing.assert_allclose(t_edges, j_edges.astype(tu.dtype), **tol)


@pytest.mark.parametrize("dtype,d,seed", CASES)
def test_coupling_reduce_matches_jax(dtype, d, seed):
    ns = 40
    idx = _segment_ids(seed, ns)
    jplan, jdp, hplan, tplan = _plans(idx, ns, d)
    J, u, _ = _inputs(seed, idx.shape[0], ns, d, dtype)
    if dtype == np.float32:
        jout = np.asarray(jseg.coupling_reduce(
            _jax_slots(J, jplan), _jax_slots(u, jplan), jdp, d,
            use_kernels=False, interpret=True))
        tol = F32_TOL
    else:
        te = jnp.stack([sum(jnp.asarray(J[o * d + b] * u[o])
                            for o in range(2)) for b in range(d)])
        jout = np.asarray(jfm.segsum_fm(te, jnp.asarray(idx), ns))
        tol = F64_TOL
    tout = tseg.coupling_reduce(_port_slots(J, hplan), _port_slots(u, hplan),
                                tplan, d).numpy()
    np.testing.assert_allclose(tout, jout.astype(tout.dtype), **tol)
    assert not tout[:, 0].any()


def test_plans_csr_contract():
    idx = _segment_ids(3, 40)
    hp = tseg.build_seg_plan(idx, 40)
    assert np.array_equal(np.sort(hp.perm), np.arange(idx.shape[0]))
    assert np.array_equal(hp.seg, idx[hp.perm])
    assert np.all(np.diff(hp.seg) >= 0)
    counts = np.bincount(idx, minlength=40)
    assert np.array_equal(np.diff(hp.seg_ptr), counts)
    assert hp.seg_ptr[0] == 0 and hp.seg_ptr[-1] == idx.shape[0]
    with pytest.raises(ValueError, match="out of range"):
        tseg.build_seg_plan(np.array([0, 40]), 40)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dual_plans_match_jax_edge_orders(seed):
    """Both sides' real slots hold the same edges in the same order as
    the JAX dual plans, and the cross permutes move rows alike."""
    rng = np.random.default_rng(seed)
    nc, npt, n = 9, 150, 700
    cam_idx = rng.integers(0, nc, n).astype(np.int32)
    pt_idx = rng.integers(0, npt, n).astype(np.int32)
    jc, jplans = jseg.make_dual_plans(cam_idx, pt_idx, nc, npt,
                                      use_kernels=False)
    tc, tplans = tseg.make_dual_plans(cam_idx, pt_idx, nc, npt, "cpu")
    real_c = jc.mask > 0
    assert np.array_equal(tc.perm, jc.perm[real_c])

    x = rng.standard_normal((2, n))
    j_cam = jnp.asarray(x[:, jc.perm] * jc.mask)
    t_cam = torch.from_numpy(np.ascontiguousarray(x[:, tc.perm]))
    j_pt = np.asarray(jplans.to_pt(j_cam))
    t_pt = tplans.to_pt(t_cam)
    real_p = np.asarray(jplans.pt.mask) > 0
    np.testing.assert_array_equal(t_pt.numpy(), j_pt[:, real_p])
    np.testing.assert_array_equal(tplans.to_cam(t_pt).numpy(), t_cam.numpy())
    np.testing.assert_array_equal(tplans.pt.seg.numpy(),
                                  np.sort(pt_idx, kind="stable"))


def test_wrappers_validate_operands():
    idx = _segment_ids(0, 40)
    _, _, hplan, tplan = _plans(idx, 40, 9)
    J, r, table = _inputs(0, idx.shape[0], 40, 9, np.float64)
    Jt, rt = _port_slots(J, hplan), _port_slots(r, hplan)
    with pytest.raises(ValueError, match="contiguous"):
        tseg.coupling_expand(torch.from_numpy(table.T.copy()).T, Jt, tplan, 9)
    with pytest.raises(TypeError, match="dtype"):
        tseg.jtj_grad_reduce(Jt, rt.float(), tplan)
    with pytest.raises(ValueError, match="disagree"):
        tseg.coupling_reduce(Jt[:, :-1].contiguous(), rt[:, :-1].contiguous(),
                             tplan, 9)


FAMILY_BLOCKS = [(1, 4), (1, 2), (2, 7), (2, 12), (6, 6), (6, 3), (2, 6),
                 (7, 7)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("od,d", FAMILY_BLOCKS,
                         ids=[f"{od}x{d}" for od, d in FAMILY_BLOCKS])
def test_kernels_at_family_block_shapes_match_jax(od, d, dtype):
    """Kernels 1-3's plain versions at each family's block shape."""
    ns = 40
    idx = _segment_ids(2, ns)
    jplan, jdp, hplan, tplan = _plans(idx, ns, 9 if d > 3 else 3)
    n = idx.shape[0]
    J, u, table = _inputs(2, n, ns, d, dtype, od=od)
    Jt, ut = _port_slots(J, hplan), _port_slots(u, hplan)
    th, tg = tseg.jtj_grad_reduce(Jt, ut, tplan)
    tred = tseg.coupling_reduce(Jt, ut, tplan, d).numpy()
    texp = np.empty((od, n), dtype)
    texp[:, hplan.perm] = tseg.coupling_expand(
        torch.from_numpy(table), Jt, tplan, d).numpy()
    if dtype == np.float32:
        kw = dict(use_kernels=False, interpret=True)
        jh, jg = jseg.jtj_grad_reduce(_jax_slots(J, jplan),
                                      _jax_slots(u, jplan), jdp, **kw)
        jred = jseg.coupling_reduce(_jax_slots(J, jplan),
                                    _jax_slots(u, jplan), jdp, d, **kw)
        ju = np.asarray(jseg.coupling_expand(
            jnp.asarray(table), _jax_slots(J, jplan), jdp, d, **kw))
        real = jplan.mask > 0
        jexp = np.empty((od, n), ju.dtype)
        jexp[:, jplan.perm[real]] = ju[:, real]
        tol = F32_TOL
    else:
        jh, jg = jseg.jtj_grad_reduce(_jax_slots(J, jplan),
                                      _jax_slots(u, jplan), jdp,
                                      use_kernels=False)
        te = jnp.stack([sum(jnp.asarray(J[o * d + b] * u[o])
                            for o in range(od)) for b in range(d)])
        jred = jfm.segsum_fm(te, jnp.asarray(idx), ns)
        pe = jfm.gather_fm(jnp.asarray(table), jnp.asarray(idx))
        jexp = np.asarray(jnp.stack([
            sum(jnp.asarray(J[o * d + a]) * pe[a] for a in range(d))
            for o in range(od)]))
        tol = F64_TOL
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **tol)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **tol)
    np.testing.assert_allclose(tred, np.asarray(jred), **tol)
    np.testing.assert_allclose(texp, np.asarray(jexp), **tol)
    assert th.dtype == torch.from_numpy(J).dtype
    assert not th[:, 0].any() and not tred[:, 0].any()

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports neither jax nor the JAX package, so it also runs on a GPU machine
without them: `python -m pytest -m cuda tests/test_torch_cuda.py`.  It
skips without a CUDA device (the kernels have no CPU mode); on the CPU
the plain versions are held to the JAX package by test_torch_segtiles.py,
test_torch_explicit.py and test_torch_fused.py.
"""

import numpy as np
import pytest
import torch

from megba_tpu_torch.ops import fused as tfused
from megba_tpu_torch.ops import segtiles as tseg


def _segment_ids(seed, num_segments):
    """Ids with an empty segment, a one-edge segment and a long one,
    the rest 0..7 edges each, shuffled into edge order."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 8, num_segments)
    counts[0], counts[1], counts[2] = 0, 1, 300
    idx = np.repeat(np.arange(num_segments), counts)
    return idx[rng.permutation(idx.shape[0])].astype(np.int32)


def _inputs(seed, n, num_segments, d, dtype, od=2):
    """Jacobian rows scaled so a 300-edge segment sums to O(1)."""
    rng = np.random.default_rng(seed + 100)
    J = (0.1 * rng.standard_normal((od * d, n))).astype(dtype)
    r = rng.standard_normal((od, n)).astype(dtype)
    table = rng.standard_normal((d, num_segments)).astype(dtype)
    return J, r, table


def _port_slots(a, hplan):
    return torch.from_numpy(np.ascontiguousarray(a[:, hplan.perm]))


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On the card: each kernel against its plain version, bitwise
    repeatable, and counted once per launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    idx = _segment_ids(4, 2000)
    for d in (9, 3):
        hplan = tseg.build_seg_plan(idx, 2000)
        plan = tseg.device_plan(hplan, np.zeros_like(hplan.perm), dev)
        J, r, table = _inputs(4, idx.shape[0], 2000, d, np.float64)
        Jt = _port_slots(J, hplan).to(dev)
        rt = _port_slots(r, hplan).to(dev)
        tt = torch.from_numpy(table).to(dev)
        for name, args in (("jtj_grad_reduce", (Jt, rt, plan)),
                           ("coupling_expand", (tt, Jt, plan, d)),
                           ("coupling_reduce", (Jt, rt, plan, d))):
            kernel = getattr(tseg, name)
            before = kernel.launches
            got = kernel(*args)
            again = kernel(*args)
            ref = getattr(tseg, name + "_plain")(*args)
            torch.cuda.synchronize()
            assert kernel.launches == before + 2
            got, again, ref = (torch.cat(x) if isinstance(x, tuple) else x
                               for x in (got, again, ref))
            assert torch.equal(got, again)
            torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
def test_f64_solve_kernels_match_plain_on_small_scene(monkeypatch):
    """On the card: an 8-camera f64 solve through the kernels and through
    their plain versions gives the same cost trajectory (rtol 1e-9) with
    the same accept pattern and iteration counts, and two solves through
    the kernels are bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from megba_tpu_torch import (AlgoOption, ComputeKind, JacobianMode,
                                 ProblemOption, SolverOption, flat_solve)
    from megba_tpu_torch.io.synthetic import make_synthetic_bal

    s = make_synthetic_bal(num_cameras=8, num_points=1303,
                           obs_per_point=225_911 / 65_132, seed=0,
                           param_noise=1e-2, pixel_noise=0.5,
                           dtype=np.float64)
    opt = ProblemOption(
        dtype=np.float64, compute_kind=ComputeKind.IMPLICIT,
        jacobian_mode=JacobianMode.ANALYTICAL,
        algo_option=AlgoOption(max_iter=8, epsilon1=1e-12, epsilon2=1e-15),
        solver_option=SolverOption(max_iter=30, tol=1e-10, refuse_ratio=1e30))
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx, opt)
    names = ("jtj_grad_reduce", "coupling_expand", "coupling_reduce")
    before = {n: getattr(tseg, n).launches for n in names}
    kern = flat_solve(*args, device="cuda")
    again = flat_solve(*args, device="cuda")
    assert all(getattr(tseg, n).launches > before[n] for n in names)
    for n in names:
        monkeypatch.setattr(tseg, n, getattr(tseg, n + "_plain"))
    plain = flat_solve(*args, device="cuda")
    k = kern.iterations
    assert k > 0
    assert (k, kern.accepted, kern.pcg_iterations) == (
        plain.iterations, plain.accepted, plain.pcg_iterations)
    assert torch.equal(kern.trace.accept[:k], plain.trace.accept[:k])
    assert torch.equal(kern.trace.pcg_iters[:k], plain.trace.pcg_iters[:k])
    assert torch.equal(kern.trace.cost[:k], again.trace.cost[:k])
    np.testing.assert_allclose(kern.trace.cost[:k].numpy(),
                               plain.trace.cost[:k].numpy(), rtol=1e-9)
    assert float(kern.cost) < float(kern.initial_cost)


def _graph(seed, nc, npt, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, nc, n).astype(np.int32),
            rng.integers(0, npt, n).astype(np.int32))


def _check_kernel(kernel, plain, args):
    """Two launches bitwise equal, counted, and equal to the plain
    version at f64 reordering tolerance."""
    before = kernel.launches
    got = kernel(*args)
    again = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("nc,npt,n", [
    (12, 2000, 9000),    # cameras block/segment, points thread/segment
    (4000, 3000, 12000),  # both sides thread/segment
])
def test_cuda_explicit_kernels_match_plain_versions(nc, npt, n):
    """On the card: seg_reduce / seg_expand on both sides, the fused
    coupling apply in both directions and the block-diagonal apply, each
    against its plain version, bitwise repeatable and counted once per
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    cam_idx, pt_idx = _graph(7, nc, npt, n)
    _, plans = tseg.make_dual_plans(cam_idx, pt_idx, nc, npt, dev)
    plans = tfused.with_fused_plans(plans)
    rng = np.random.default_rng(8)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev)

    for side, d in ((plans.cam, 9), (plans.pt, 3)):
        _check_kernel(tseg.seg_reduce, tseg.seg_reduce_plain,
                      (rand(d, n), side))
        _check_kernel(tseg.seg_expand, tseg.seg_expand_plain,
                      (rand(d, side.num_segments), side))
    W = 0.1 * rand(27, n)
    _check_kernel(tfused.fused_coupling_apply,
                  tfused.fused_coupling_apply_plain,
                  (plans.to_pt(W), rand(9, nc), plans.fused_to_pt, True))
    _check_kernel(tfused.fused_coupling_apply,
                  tfused.fused_coupling_apply_plain,
                  (W, rand(3, npt), plans.fused_to_cam, False))
    A = rand(nc, 9, 9)
    Hrows = tfused.block_diag_rows(A @ A.transpose(1, 2))
    _check_kernel(tfused.fused_block_diag_apply,
                  tfused.fused_block_diag_apply_plain, (Hrows, rand(9, nc)))


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_f64_explicit_solve_kernels_match_plain_on_small_scene(
        monkeypatch, fused):
    """On the card: the 8-camera f64 scene solved EXPLICIT (unfused and
    fused) through the kernels and through their plain versions: the same
    cost trajectory (rtol 1e-9), accept pattern and iteration counts, and
    two kernel solves bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from megba_tpu_torch import (AlgoOption, ComputeKind, JacobianMode,
                                 ProblemOption, SolverOption, flat_solve)
    from megba_tpu_torch.io.synthetic import make_synthetic_bal

    s = make_synthetic_bal(num_cameras=8, num_points=1303,
                           obs_per_point=225_911 / 65_132, seed=0,
                           param_noise=1e-2, pixel_noise=0.5,
                           dtype=np.float64)
    opt = ProblemOption(
        dtype=np.float64, compute_kind=ComputeKind.EXPLICIT,
        jacobian_mode=JacobianMode.ANALYTICAL,
        algo_option=AlgoOption(max_iter=8, epsilon1=1e-12, epsilon2=1e-15),
        solver_option=SolverOption(max_iter=30, tol=1e-10, refuse_ratio=1e30,
                                   fused_kernels=fused))
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx, opt)
    kernels = [(tseg, "jtj_grad_reduce"), (tseg, "coupling_expand")]
    kernels += ([(tfused, "fused_coupling_apply"),
                 (tfused, "fused_block_diag_apply")] if fused else
                [(tseg, "seg_expand"), (tseg, "seg_reduce")])
    before = [getattr(m, n).launches for m, n in kernels]
    kern = flat_solve(*args, device="cuda")
    again = flat_solve(*args, device="cuda")
    after = [getattr(m, n).launches for m, n in kernels]
    assert all(a > b for a, b in zip(after, before)), (kernels, after)
    for m, n in kernels:
        monkeypatch.setattr(m, n, getattr(m, n + "_plain"))
    plain = flat_solve(*args, device="cuda")
    k = kern.iterations
    assert k > 0
    assert (k, kern.accepted, kern.pcg_iterations) == (
        plain.iterations, plain.accepted, plain.pcg_iterations)
    assert torch.equal(kern.trace.accept[:k], plain.trace.accept[:k])
    assert torch.equal(kern.trace.pcg_iters[:k], plain.trace.pcg_iters[:k])
    assert torch.equal(kern.trace.cost[:k], again.trace.cost[:k])
    np.testing.assert_allclose(kern.trace.cost[:k].numpy(),
                               plain.trace.cost[:k].numpy(), rtol=1e-9)
    assert float(kern.cost) < float(kern.initial_cost)

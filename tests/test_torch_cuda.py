"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports neither jax nor the JAX package, so it also runs on a GPU machine
without them: `python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py` (the repository's conftest imports jax).  It
skips without a CUDA device (the kernels have no CPU mode); on the CPU
the plain versions are held to the JAX package by test_torch_segtiles.py,
test_torch_explicit.py, test_torch_fused.py, test_torch_fused_implicit.py,
test_torch_precision.py and test_torch_unfused_precision.py.
"""

import dataclasses

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


def _check_arm(kernel, plain, args, arm=None, dtype=torch.float32, **kw):
    """A bf16-row arm: two launches bitwise equal, counted (in all and,
    when `arm` is named, in that arm), out in `dtype`, and within 1e-5
    (float32) or 1e-12 (float64) of the sum of the terms' magnitudes of
    the plain version (the same per-slot terms, summed per segment in
    another order)."""
    before = kernel.launches
    before_arm = kernel.arm_launches.get(arm, 0)
    got = kernel(*args, **kw)
    again = kernel(*args, **kw)
    ref = plain(*args, **kw)
    scale = plain(*[a.abs() if isinstance(a, torch.Tensor)
                    and a.is_floating_point() else a for a in args], **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    if arm is not None:
        assert kernel.arm_launches[arm] == before_arm + 2
    assert got.dtype == dtype and torch.equal(got, again)
    rel = 1e-5 if dtype == torch.float32 else 1e-12
    assert bool(((got - ref).abs() <= rel * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("nc,npt,n", [
    (12, 2000, 9000),    # cameras block/segment, points thread/segment
    (4000, 3000, 12000),  # both sides thread/segment
])
def test_cuda_fused_implicit_and_precision_arms_match_plain(nc, npt, n):
    """On the card: the fused implicit coupling apply in both directions
    at float64, and the bf16-row arms (mixed: upcast before the multiply;
    bf16: bf16 products) of the implicit and explicit coupling applies
    and of the block-diagonal apply, each against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    cam_idx, pt_idx = _graph(9, nc, npt, n)
    _, plans = tseg.make_dual_plans(cam_idx, pt_idx, nc, npt, dev)
    plans = tfused.with_fused_plans(plans)
    rng = np.random.default_rng(10)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev)

    Jc, Jp = 0.1 * rand(18, n), 0.1 * rand(6, n)  # cam slot order
    x_cam, x_pt = rand(9, nc), rand(3, npt)
    to_pt = (plans.to_pt(Jc), plans.to_pt(Jp), x_cam, plans.fused_to_pt)
    to_cam = (Jp, Jc, x_pt, plans.fused_to_cam)
    k7 = (tfused.fused_coupling_apply_implicit,
          tfused.fused_coupling_apply_implicit_plain)
    for args in (to_pt, to_cam):
        _check_kernel(*k7, args)

    def bf16(args):
        return tuple(a.to(torch.bfloat16) if i < len(args) - 2 else
                     a.float() if isinstance(a, torch.Tensor) else a
                     for i, a in enumerate(args))

    W = 0.1 * rand(27, n)
    A = rand(nc, 9, 9)
    Hrows = tfused.block_diag_rows(A @ A.transpose(1, 2))
    for ops in (False, True):
        for args in (to_pt, to_cam):
            _check_arm(*k7, bf16(args), bf16_operands=ops)
        _check_arm(tfused.fused_coupling_apply,
                   tfused.fused_coupling_apply_plain,
                   (plans.to_pt(W).to(torch.bfloat16), x_cam.float(),
                    plans.fused_to_pt, True), bf16_operands=ops)
        _check_arm(tfused.fused_coupling_apply,
                   tfused.fused_coupling_apply_plain,
                   (W.to(torch.bfloat16), x_pt.float(), plans.fused_to_cam,
                    False), bf16_operands=ops)
        _check_arm(tfused.fused_block_diag_apply,
                   tfused.fused_block_diag_apply_plain,
                   (Hrows.to(torch.bfloat16), x_cam.float()),
                   bf16_operands=ops)


def _small_scene(dtype):
    from megba_tpu_torch.io.synthetic import make_synthetic_bal

    return make_synthetic_bal(num_cameras=8, num_points=1303,
                              obs_per_point=225_911 / 65_132, seed=0,
                              param_noise=1e-2, pixel_noise=0.5, dtype=dtype)


def _small_option(dtype, kind, rung=None, fused=True):
    """The chip_smoke.py options; a precision rung at float32 stops its
    PCG at 1e-6 of the RHS energy (chip_smoke.precision_phase says why),
    mixed at float64 starts from trust region 1
    (chip_smoke.solve_option says why)."""
    from megba_tpu_torch import (AlgoOption, ComputeKind, JacobianMode,
                                 ProblemOption, SolverOption)

    relative = rung is not None and dtype == np.float32
    return ProblemOption(
        dtype=dtype, compute_kind=ComputeKind[kind],
        jacobian_mode=JacobianMode.ANALYTICAL,
        mixed_precision_pcg=rung == "mixed",
        algo_option=AlgoOption(
            max_iter=8, epsilon1=1e-12, epsilon2=1e-15,
            initial_region=1.0 if rung == "mixed" and dtype == np.float64
            else 1e3),
        solver_option=SolverOption(
            max_iter=30, tol=1e-6 if relative else 1e-10,
            tol_relative=relative, refuse_ratio=1e30,
            fused_kernels=fused, bf16=rung == "bf16"))


@pytest.mark.cuda
def test_f64_implicit_fused_solve_kernels_match_plain_on_small_scene(
        monkeypatch):
    """On the card: the 8-camera f64 scene solved IMPLICIT with fused
    kernels through the kernels and through their plain versions: the
    same cost trajectory (rtol 1e-9), accept pattern and iteration
    counts, and two kernel solves bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from megba_tpu_torch import flat_solve

    s = _small_scene(np.float64)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
            _small_option(np.float64, "IMPLICIT"))
    kernels = [(tseg, "jtj_grad_reduce"), (tseg, "coupling_expand"),
               (tfused, "fused_coupling_apply_implicit"),
               (tfused, "fused_block_diag_apply")]
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


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["mixed", "bf16"])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_f32_precision_solve_kernels_match_plain_on_small_scene(
        monkeypatch, kind, rung):
    """On the card: the 8-camera f32 scene on a precision rung through
    the kernels and through their plain versions: the first trial cost
    at rtol 1e-4 (mixed) or 2e-2 (bf16: its recurrence is not linear, so
    another f32 summation order moves it by ~1e-3; chip_smoke.py
    FIRST_COST_RTOL), the final cost at rtol 1e-3, both below the
    initial."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from megba_tpu_torch import flat_solve

    s = _small_scene(np.float32)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
            _small_option(np.float32, kind, rung))
    kern = flat_solve(*args, device="cuda")
    for m in (tseg, tfused):
        for k in m.KERNELS:
            monkeypatch.setattr(m, k.__name__,
                                getattr(m, k.__name__ + "_plain"))
    plain = flat_solve(*args, device="cuda")
    for res in (kern, plain):
        assert np.isfinite(float(res.cost))
        assert float(res.cost) < float(res.initial_cost)
    np.testing.assert_allclose(float(kern.trace.cost[0]),
                               float(plain.trace.cost[0]),
                               rtol=1e-4 if rung == "mixed" else 2e-2)
    np.testing.assert_allclose(float(kern.cost), float(plain.cost),
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# The precision ladder without fused kernels, and at float64
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("nc,npt,n", [
    (12, 2000, 9000),    # cameras block/segment, points thread/segment
    (4000, 3000, 12000),  # both sides thread/segment
])
def test_cuda_coupling_and_mixed64_arms_match_plain(nc, npt, n):
    """On the card: the mixed, mixed64 and bf16 arms of coupling_expand
    and coupling_reduce on both sides, and the mixed64 arms of the fused
    coupling applies in both directions, each against its plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    cam_idx, pt_idx = _graph(12, nc, npt, n)
    _, plans = tseg.make_dual_plans(cam_idx, pt_idx, nc, npt, dev)
    plans = tfused.with_fused_plans(plans)
    rng = np.random.default_rng(13)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev)

    bf, f32, f64 = torch.bfloat16, torch.float32, torch.float64
    Jc, Jp = (0.1 * rand(18, n)).to(bf), (0.1 * rand(6, n)).to(bf)
    Jp_pt = plans.to_pt(Jp)
    for J, side, d in ((Jc, plans.cam, 9), (Jp_pt, plans.pt, 3)):
        x, u = rand(d, side.num_segments), rand(2, n)
        for arm, dt, ops in (("mixed", f32, False), ("bf16", f32, True),
                             ("mixed64", f64, False)):
            _check_arm(tseg.coupling_expand, tseg.coupling_expand_plain,
                       (x.to(dt), J, side, d), arm, dt, bf16_operands=ops)
            _check_arm(tseg.coupling_reduce, tseg.coupling_reduce_plain,
                       (J, u.to(dt), side, d), arm, dt, bf16_operands=ops)
    x_cam, x_pt = rand(9, nc), rand(3, npt)
    _check_arm(tfused.fused_coupling_apply_implicit,
               tfused.fused_coupling_apply_implicit_plain,
               (plans.to_pt(Jc), Jp_pt, x_cam, plans.fused_to_pt),
               "mixed64", f64)
    _check_arm(tfused.fused_coupling_apply_implicit,
               tfused.fused_coupling_apply_implicit_plain,
               (Jp, Jc, x_pt, plans.fused_to_cam), "mixed64", f64)
    W = (0.1 * rand(27, n)).to(bf)
    _check_arm(tfused.fused_coupling_apply,
               tfused.fused_coupling_apply_plain,
               (plans.to_pt(W), x_cam, plans.fused_to_pt, True), "mixed64",
               f64)
    _check_arm(tfused.fused_coupling_apply,
               tfused.fused_coupling_apply_plain,
               (W, x_pt, plans.fused_to_cam, False), "mixed64", f64)


# The kernel arms each mixed f64 path must launch.
_MIXED64_ARMS = {
    ("IMPLICIT", False): ("coupling_expand[mixed64]",
                          "coupling_reduce[mixed64]"),
    ("EXPLICIT", False): ("seg_expand[f64]", "seg_reduce[f64]"),
    ("IMPLICIT", True): ("fused_coupling_apply_implicit[mixed64]",
                         "fused_block_diag_apply[f64]"),
    ("EXPLICIT", True): ("fused_coupling_apply[mixed64]",
                         "fused_block_diag_apply[f64]"),
}


def _arm_counts():
    return {**tseg.arm_launch_counts(), **tfused.arm_launch_counts()}


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_f64_mixed_solve_kernels_match_plain_on_small_scene(
        monkeypatch, kind, fused):
    """On the card: the 8-camera f64 scene solved with
    mixed_precision_pcg (bf16 rows beside f64 vectors) through the
    kernels and through their plain versions: the same cost trajectory
    (rtol 1e-9), accept pattern and iteration counts, two kernel solves
    bitwise equal, and the mixed64 arms launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from megba_tpu_torch import flat_solve

    s = _small_scene(np.float64)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
            _small_option(np.float64, kind, "mixed", fused))
    before = _arm_counts()
    kern = flat_solve(*args, device="cuda")
    again = flat_solve(*args, device="cuda")
    after = _arm_counts()
    for arm in _MIXED64_ARMS[kind, fused]:
        assert after.get(arm, 0) > before.get(arm, 0), (arm, after)
    for m in (tseg, tfused):
        for k in m.KERNELS:
            monkeypatch.setattr(m, k.__name__,
                                getattr(m, k.__name__ + "_plain"))
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


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["mixed", "bf16"])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_f32_unfused_precision_solve_kernels_match_plain_on_small_scene(
        monkeypatch, kind, rung):
    """On the card: the 8-camera f32 scene on a precision rung without
    fused kernels, through the kernels and through their plain versions,
    held as the fused rungs are (first trial cost at rtol 1e-4 or 2e-2,
    final cost at rtol 1e-3, both below the initial)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from megba_tpu_torch import flat_solve

    s = _small_scene(np.float32)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
            _small_option(np.float32, kind, rung, fused=False))
    before = _arm_counts()
    kern = flat_solve(*args, device="cuda")
    if kind == "IMPLICIT":
        for name in ("coupling_expand", "coupling_reduce"):
            arm = f"{name}[{rung}]"
            assert _arm_counts().get(arm, 0) > before.get(arm, 0), arm
    for m in (tseg, tfused):
        for k in m.KERNELS:
            monkeypatch.setattr(m, k.__name__,
                                getattr(m, k.__name__ + "_plain"))
    plain = flat_solve(*args, device="cuda")
    for res in (kern, plain):
        assert np.isfinite(float(res.cost))
        assert float(res.cost) < float(res.initial_cost)
    np.testing.assert_allclose(float(kern.trace.cost[0]),
                               float(plain.trace.cost[0]),
                               rtol=1e-4 if rung == "mixed" else 2e-2)
    np.testing.assert_allclose(float(kern.cost), float(plain.cost),
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# The fused kernels' slot tiles on heavy-tailed graphs
# ---------------------------------------------------------------------------


# (row dtype, table dtype, bf16_operands) of each arm of kernels 7 and 8.
_FUSED_ARMS = {
    "f32": (torch.float32, torch.float32, False),
    "f64": (torch.float64, torch.float64, False),
    "mixed": (torch.bfloat16, torch.float32, False),
    "mixed64": (torch.bfloat16, torch.float64, False),
    "bf16": (torch.bfloat16, torch.float32, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("nc,npt", [(12, 3000), (2000, 3000)],
                         ids=["few_cameras", "many_cameras"])
def test_cuda_fused_kernels_on_heavy_tailed_graphs(nc, npt):
    """On the card: kernels 7 and 8 in both directions and every arm on a
    graph with Zipf track lengths, empty points at the start, middle and
    end, a point of exactly one tile and one spanning four
    (io.synthetic.heavy_tailed_graph), each against its plain version
    (1e-5 / 1e-12 of the sum of the terms' magnitudes), bitwise
    repeatable and counted per arm; with few cameras pt->cam runs a block
    per camera, with many it runs slot tiles too.  On every slot-tile
    side, plans of 1 and 37 slots a tile give bitwise the 256-slot
    plan's output: a segment's summation order (slot order under 256
    slots, the block-per-segment order from 256) does not depend on the
    tile that owns it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from megba_tpu_torch.io.synthetic import heavy_tailed_graph

    dev = torch.device("cuda")
    cam_idx, pt_idx = heavy_tailed_graph(nc, npt, seed=5)
    n = cam_idx.shape[0]
    _, base = tseg.make_dual_plans(cam_idx, pt_idx, nc, npt, dev)
    plans = tfused.with_fused_plans(base)
    assert plans.pt.per_thread and plans.cam.per_thread == (nc > 12)
    rng = np.random.default_rng(14)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev)

    Jc, Jp, W = 0.1 * rand(18, n), 0.1 * rand(6, n), 0.1 * rand(27, n)
    x_cam, x_pt = rand(9, nc), rand(3, npt)
    # (kernel, rows of cam->pt, rows of pt->cam, w_in_major of each)
    kernels = (
        (tfused.fused_coupling_apply, tfused.fused_coupling_apply_plain,
         (plans.to_pt(W),), (W,), ((True,), (False,))),
        (tfused.fused_coupling_apply_implicit,
         tfused.fused_coupling_apply_implicit_plain,
         (plans.to_pt(Jc), plans.to_pt(Jp)), (Jp, Jc), ((), ())),
    )
    def retiled(fplan, tile):
        return dataclasses.replace(
            fplan, tile_ptr=tfused.slot_tiles(fplan.out.seg_ptr, tile))

    for kernel, plain, rows_tp, rows_tc, extra in kernels:
        for arm, (rt, tt, ops) in _FUSED_ARMS.items():
            directions = (
                (rows_tp, x_cam, "fused_to_pt", extra[0]),
                (rows_tc, x_pt, "fused_to_cam", extra[1]))
            for rows, x, side, tail in directions:
                fplan = getattr(plans, side)
                args = (*(r.to(rt) for r in rows), x.to(tt), fplan, *tail)
                _check_arm(kernel, plain, args, arm, tt, bf16_operands=ops)
                if not fplan.out.per_thread:
                    continue
                want = kernel(*args, bf16_operands=ops)
                for tile in (1, 37):
                    got = kernel(*args[:-1 - len(tail)],
                                 retiled(fplan, tile), *tail,
                                 bf16_operands=ops)
                    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Jacobian modes, robust losses, forcing and warm starts
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["AUTODIFF", "AUTODIFF_FORWARD"])
def test_cuda_autodiff_engines_match_analytical(mode):
    """On the card, f64: the autodiff engine against the closed form per
    edge (1e-12 of the row's largest magnitude) and against itself on the
    CPU, with a zero-angle and six small-angle cameras among the edges,
    every row finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.func runs there eagerly)")
    from megba_tpu_torch import JacobianMode, make_residual_jacobian_fn

    s = _small_scene(np.float64)
    cams = s.cameras0.copy()
    cams[0, 0:3] = 0.0
    cams[1:7, 0:3] *= 1e-7
    rows = [np.ascontiguousarray(a.T) for a in (
        cams[s.cam_idx], s.points0[s.pt_idx], s.obs)]
    dev = torch.device("cuda")
    engine = make_residual_jacobian_fn(mode=JacobianMode[mode])
    got = engine(*(torch.from_numpy(a).to(dev) for a in rows))
    ref = make_residual_jacobian_fn(mode=JacobianMode.ANALYTICAL)(
        *(torch.from_numpy(a).to(dev) for a in rows))
    cpu = engine(*(torch.from_numpy(a) for a in rows))
    for g, w, c in zip(got, ref, cpu):
        assert g.is_cuda and bool(torch.isfinite(g).all())
        scale = w.abs().amax(1, keepdim=True)
        assert bool(((g - w).abs() <= 1e-12 * scale).all())
        assert bool(((g.cpu() - c).abs() <= 1e-12 * scale.cpu()).all())


def _variant_option(path):
    """The 8-camera f64 options of chip_smoke.py's variant paths."""
    from megba_tpu_torch import (AlgoOption, ComputeKind, JacobianMode,
                                 ProblemOption, RobustKind, SolverOption)

    kind, fused, extra = {
        "implicit_autodiff": ("IMPLICIT", False, {}),
        "explicit_fused_autodiff_forward": ("EXPLICIT", True, dict(
            jacobian_mode=JacobianMode.AUTODIFF_FORWARD)),
        "implicit_fused_huber": ("IMPLICIT", True, dict(
            robust_kind=RobustKind.HUBER)),
        "explicit_cauchy": ("EXPLICIT", False, dict(
            robust_kind=RobustKind.CAUCHY)),
        "implicit_forcing_warm": ("IMPLICIT", False, dict(
            jacobian_mode=JacobianMode.ANALYTICAL)),
        "implicit_fused_forcing_warm": ("IMPLICIT", True, dict(
            jacobian_mode=JacobianMode.ANALYTICAL)),
    }[path]
    if path == "implicit_autodiff":
        # ProblemOption()'s own tolerances, stopped before the scene's
        # cost floor: its 6th step moves the cost by ~1e-15 relative, where
        # an accept decision is rounding (chip_smoke.DEFAULT_LM_CAP).
        return ProblemOption(algo_option=AlgoOption(max_iter=5),
                             solver_option=SolverOption(max_iter=30))
    solver = (dict(tol=1e-1, forcing=True, warm_start=True)
              if "forcing" in path else dict(tol=1e-10))
    return ProblemOption(
        compute_kind=ComputeKind[kind], robust_delta=1.0,
        algo_option=AlgoOption(max_iter=8, epsilon1=1e-12, epsilon2=1e-15),
        solver_option=SolverOption(max_iter=30, refuse_ratio=1e30,
                                   fused_kernels=fused, **solver),
        **extra)


@pytest.mark.cuda
@pytest.mark.parametrize("path", [
    "implicit_autodiff", "explicit_fused_autodiff_forward",
    "implicit_fused_huber", "explicit_cauchy", "implicit_forcing_warm",
    "implicit_fused_forcing_warm"])
def test_f64_variant_solve_kernels_match_plain_on_small_scene(
        monkeypatch, path):
    """On the card: the 8-camera f64 scene with AUTODIFF (the reference's
    default options), AUTODIFF_FORWARD, a Huber or Cauchy loss, or
    forcing with warm starts, through the kernels and through their
    plain versions: the same cost trajectory (rtol 1e-9), accept pattern,
    iteration counts and forcing trace, and two kernel solves bitwise
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from megba_tpu_torch import flat_solve

    s = _small_scene(np.float64)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
            _variant_option(path))
    before = {**tseg.launch_counts(), **tfused.launch_counts()}
    kern = flat_solve(*args, device="cuda")
    again = flat_solve(*args, device="cuda")
    after = {**tseg.launch_counts(), **tfused.launch_counts()}
    assert after["jtj_grad_reduce"] > before["jtj_grad_reduce"]
    for m in (tseg, tfused):
        for k in m.KERNELS:
            monkeypatch.setattr(m, k.__name__,
                                getattr(m, k.__name__ + "_plain"))
    plain = flat_solve(*args, device="cuda")
    k = kern.iterations
    assert k > 0
    assert (k, kern.accepted, kern.pcg_iterations) == (
        plain.iterations, plain.accepted, plain.pcg_iterations)
    for f in ("accept", "pcg_iters"):
        assert torch.equal(getattr(kern.trace, f)[:k],
                           getattr(plain.trace, f)[:k])
    assert torch.equal(kern.trace.cost[:k], again.trace.cost[:k])
    for f in ("cost", "pcg_eta", "pcg_r0_ratio"):
        np.testing.assert_allclose(getattr(kern.trace, f)[:k].numpy(),
                                   getattr(plain.trace, f)[:k].numpy(),
                                   rtol=1e-9)
    assert float(kern.cost) < float(kern.initial_cost)
    if "forcing" in path:
        assert kern.dx_cam.shape == s.cameras0.shape and kern.dx_cam.is_cuda


# The fault-containment, plain-solver, edge-order and preconditioner
# paths of chip_smoke.py: (compute kind, fused kernels, option fields,
# fault).  The crush takes the 64 busiest points in the systems built at
# carry 2, an accepted step on the 8-camera scene.
_FAULT_PATHS = {
    "implicit_guarded": ("IMPLICIT", False, dict(guards=True), None),
    "implicit_nan_burst": ("IMPLICIT", False, dict(guards=True), "nan"),
    "implicit_fatal": ("IMPLICIT", False, dict(guards=True), "persistent"),
    "explicit_fused_indefinite": ("EXPLICIT", True, dict(guards=True),
                                  "crush"),
    "implicit_fused_schur_diag_indefinite": (
        "IMPLICIT", True, dict(guards=True, preconditioner="SCHUR_DIAG"),
        "crush"),
    "explicit_schur_diag": ("EXPLICIT", False,
                            dict(preconditioner="SCHUR_DIAG"), None),
    "implicit_plain": ("IMPLICIT", False, dict(use_schur=False), None),
    "explicit_plain_forcing_warm": ("EXPLICIT", False, dict(
        use_schur=False, forcing=True), None),
    "implicit_coobs": ("IMPLICIT", False, dict(edge_order="COOBS"), None),
    "implicit_fused_neumann": ("IMPLICIT", True, dict(precond="NEUMANN"),
                               None),
    "explicit_neumann": ("EXPLICIT", False, dict(precond="NEUMANN"), None),
}


def _fault_inputs(path, s):
    """The options, arrays and keyword arguments of a `_FAULT_PATHS`
    solve on the 8-camera f64 scene; COOBS solves the edges in a seeded
    random order (the scene comes camera-sorted)."""
    from megba_tpu_torch import (AlgoOption, ComputeKind, EdgeOrder,
                                 PrecondKind, PreconditionerKind,
                                 ProblemOption, RobustOption, SolverOption,
                                 make_nan_burst, make_point_indefinite_burst)

    kind, fused, extra, fault = _FAULT_PATHS[path]
    solver = (dict(tol=1e-1, forcing=True, warm_start=True)
              if extra.get("forcing") else dict(tol=1e-10))
    opt = ProblemOption(
        compute_kind=ComputeKind[kind], use_schur=extra.get("use_schur",
                                                            True),
        robust_option=RobustOption(guards=extra.get("guards", False)),
        algo_option=AlgoOption(max_iter=8, epsilon1=1e-12, epsilon2=1e-15),
        solver_option=SolverOption(
            max_iter=30, refuse_ratio=1e30, fused_kernels=fused,
            precond=PrecondKind[extra.get("precond", "JACOBI")],
            preconditioner=PreconditionerKind[
                extra.get("preconditioner", "HPP")],
            edge_order=EdgeOrder[extra.get("edge_order", "NATURAL")],
            **solver))
    arrays = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    if "edge_order" in extra:
        perm = np.random.default_rng(7).permutation(s.obs.shape[0])
        arrays = arrays[:2] + tuple(a[perm] for a in arrays[2:])
    n, npt = s.obs.shape[0], s.points0.shape[0]
    kw = {}
    if fault == "crush":
        busiest = np.argsort(-np.bincount(s.pt_idx, minlength=npt),
                             kind="stable")[:64]
        kw["fault_plan"] = make_point_indefinite_burst(npt, busiest, 2, 3,
                                                       n_edges=n)
    elif fault is not None:
        kw["fault_plan"] = make_nan_burst(
            n, [2, 9], 0, 1 if fault == "nan" else 10_000)
    return arrays + (opt,), kw


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(_FAULT_PATHS))
def test_f64_fault_and_solver_paths_kernels_match_plain_on_small_scene(
        monkeypatch, path):
    """On the card: guards, seeded faults, the plain full-system solver,
    the COOBS edge order and the SCHUR_DIAG / NEUMANN preconditioners on
    the 8-camera f64 scene, through the kernels and through their plain
    versions: finite trial costs at rtol 1e-9 and NaN at the same
    iterations, equal accept / recovery / breakdown / fallback traces,
    counts, status and recoveries, and two kernel solves bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from megba_tpu_torch import SolveStatus, flat_solve

    s = _small_scene(np.float64)
    args, kw = _fault_inputs(path, s)
    kern = flat_solve(*args, device="cuda", **kw)
    again = flat_solve(*args, device="cuda", **kw)
    for m in (tseg, tfused):
        for k in m.KERNELS:
            monkeypatch.setattr(m, k.__name__,
                                getattr(m, k.__name__ + "_plain"))
    plain = flat_solve(*args, device="cuda", **kw)
    k = kern.iterations
    assert k > 0
    assert (k, kern.accepted, kern.pcg_iterations, kern.status,
            kern.recoveries) == (plain.iterations, plain.accepted,
                                 plain.pcg_iterations, plain.status,
                                 plain.recoveries)
    for f in ("accept", "pcg_iters", "recovery", "pcg_breakdown",
              "precond_fallback"):
        assert torch.equal(getattr(kern.trace, f)[:k],
                           getattr(plain.trace, f)[:k]), f
    ck, cp = kern.trace.cost[:k].numpy(), plain.trace.cost[:k].numpy()
    np.testing.assert_array_equal(np.isnan(ck), np.isnan(cp))
    # A step rolled back under the Hll crush comes from a broken PCG on an
    # operator that scales rounding by ~1e8 (chip_smoke.cost_gap): its
    # finite trial cost is not held to the kept steps' tolerance.
    kept = ~kern.trace.recovery[:k].numpy()
    np.testing.assert_allclose(ck[kept], cp[kept], rtol=1e-9)
    assert np.array_equal(ck, again.trace.cost[:k].numpy(), equal_nan=True)
    fault = _FAULT_PATHS[path][3]
    want = {None: None, "nan": SolveStatus.RECOVERED,
            "crush": SolveStatus.RECOVERED,
            "persistent": SolveStatus.FATAL_NONFINITE}[fault]
    if want is not None:
        assert kern.status == want
    if fault != "persistent":
        assert np.isfinite(float(kern.cost))
        assert float(kern.cost) < float(np.nanmax(ck))
    if fault == "crush":
        assert (kern.trace.pcg_breakdown[:k].any()
                or kern.trace.precond_fallback[:k].any())


# The coarse-space paths of chip_smoke.py's f64 phase on a 16-camera grid
# scene (where the camera graph has clusters): (compute kind, fused
# kernels, option fields, fault); "fixed" fixes the first four cameras,
# "nan_camera" puts a NaN in one camera parameter.
_COARSE_PATHS = {
    "implicit_two_level": ("IMPLICIT", False, dict(precond="TWO_LEVEL"),
                           None),
    "explicit_fused_two_level": ("EXPLICIT", True, dict(
        precond="TWO_LEVEL"), None),
    "implicit_fused_multilevel": ("IMPLICIT", True, dict(
        precond="MULTILEVEL", coarsen_factor=2.0, max_levels=4), None),
    "explicit_multilevel_smoothed": ("EXPLICIT", False, dict(
        precond="MULTILEVEL", smooth_omega=2 / 3), None),
    "implicit_fused_two_level_smoothed_schur_diag": ("IMPLICIT", True, dict(
        precond="TWO_LEVEL", smooth_omega=2 / 3,
        preconditioner="SCHUR_DIAG"), None),
    "implicit_two_level_fixed": ("IMPLICIT", False, dict(
        precond="TWO_LEVEL"), "fixed"),
    "implicit_two_level_nan_burst": ("IMPLICIT", False, dict(
        precond="TWO_LEVEL", guards=True), "nan"),
    "implicit_two_level_nan_camera": ("IMPLICIT", False, dict(
        precond="TWO_LEVEL", guards=True), "nan_camera"),
}


def _bitwise_equal(a, b):
    """Equal bits, NaN payloads included (torch.equal fails on NaN)."""
    if a.is_floating_point():
        it = {8: torch.int64, 4: torch.int32}[a.element_size()]
        return torch.equal(a.view(it), b.view(it))
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(_COARSE_PATHS))
def test_f64_coarse_paths_kernels_match_plain_and_are_deterministic(
        monkeypatch, path):
    """On the card: TWO_LEVEL and MULTILEVEL (plain and smoothed, on both
    block diagonals, with fixed cameras, a NaN burst and a NaN camera) on
    a 16-camera f64 grid scene, through the kernels and through their
    plain versions: finite trial costs at rtol 1e-9, NaN at the same
    iterations, equal traces (the coarse bits included), counts and
    status; two kernel solves bitwise equal in every trace field and in
    the solved parameters (the coarse build's sums are deterministic)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from megba_tpu_torch import (AlgoOption, ComputeKind, PrecondKind,
                                 PreconditionerKind, ProblemOption,
                                 RobustOption, SolverOption, SolveStatus,
                                 flat_solve, make_nan_burst)
    from megba_tpu_torch.io.synthetic import make_synthetic_bal
    from megba_tpu_torch.solver.precond import decode_precond_fallback_levels

    kind, fused, extra, fault = _COARSE_PATHS[path]
    s = make_synthetic_bal(num_cameras=16, num_points=1303,
                           obs_per_point=225_911 / 65_132, seed=0,
                           param_noise=1e-2, pixel_noise=0.5,
                           locality="grid")
    opt = ProblemOption(
        compute_kind=ComputeKind[kind],
        robust_option=RobustOption(guards=extra.get("guards", False)),
        algo_option=AlgoOption(max_iter=8, epsilon1=1e-12, epsilon2=1e-15),
        solver_option=SolverOption(
            max_iter=30, tol=1e-10, refuse_ratio=1e30, fused_kernels=fused,
            precond=PrecondKind[extra["precond"]],
            preconditioner=PreconditionerKind[
                extra.get("preconditioner", "HPP")],
            smooth_omega=extra.get("smooth_omega", 0.0),
            coarsen_factor=extra.get("coarsen_factor", 4.0),
            max_levels=extra.get("max_levels", 3)))
    cams = s.cameras0.copy()
    kw = {}
    if fault == "fixed":
        kw["cam_fixed"] = np.arange(16) < 4
    elif fault == "nan":
        kw["fault_plan"] = make_nan_burst(s.obs.shape[0], [2, 9], 0, 1)
    elif fault == "nan_camera":
        cams[2, 4] = np.nan
    args = (cams, s.points0, s.obs, s.cam_idx, s.pt_idx, opt)
    before = tseg.seg_reduce.launches
    kern = flat_solve(*args, device="cuda", **kw)
    again = flat_solve(*args, device="cuda", **kw)
    assert tseg.seg_reduce.launches > before
    for m in (tseg, tfused):
        for k in m.KERNELS:
            monkeypatch.setattr(m, k.__name__,
                                getattr(m, k.__name__ + "_plain"))
    plain = flat_solve(*args, device="cuda", **kw)
    k = kern.iterations
    assert (k, kern.accepted, kern.pcg_iterations, kern.status,
            kern.recoveries) == (plain.iterations, plain.accepted,
                                 plain.pcg_iterations, plain.status,
                                 plain.recoveries)
    for f in ("accept", "pcg_iters", "recovery", "precond_fallback"):
        assert torch.equal(getattr(kern.trace, f)[:k],
                           getattr(plain.trace, f)[:k]), f
    ck, cp = kern.trace.cost[:k].numpy(), plain.trace.cost[:k].numpy()
    np.testing.assert_array_equal(np.isnan(ck), np.isnan(cp))
    fin = ~np.isnan(ck)
    np.testing.assert_allclose(ck[fin], cp[fin], rtol=1e-9)
    for f in dataclasses.fields(kern.trace):
        assert _bitwise_equal(getattr(kern.trace, f.name),
                              getattr(again.trace, f.name)), f.name
    assert _bitwise_equal(kern.cameras, again.cameras)
    assert _bitwise_equal(kern.points, again.points)
    levels = [decode_precond_fallback_levels(c)
              for c in kern.trace.precond_fallback[:k].tolist()]
    if fault == "nan_camera":
        assert kern.status == SolveStatus.FATAL_NONFINITE
        assert all(lv and all(lv) for lv in levels)
    else:
        assert not any(any(lv) for lv in levels)
        assert float(kern.cost) < float(np.nanmax(ck))
        if fault == "nan":
            assert kern.status == SolveStatus.RECOVERED


def _to_plain(monkeypatch):
    """Route every kernel wrapper to its plain version."""
    for m in (tseg, tfused):
        for k in m.KERNELS:
            monkeypatch.setattr(m, k.__name__,
                                getattr(m, k.__name__ + "_plain"))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["implicit_fused_neumann", "explicit"])
def test_f64_plain_reference_is_deterministic_on_the_card(monkeypatch,
                                                          path):
    """On the card: two solves through the plain versions are bitwise
    equal in every trace field and in the solved parameters (their
    segment sums run in a fixed order, not through CUDA atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from megba_tpu_torch import PrecondKind, flat_solve

    kind = "IMPLICIT" if path.startswith("implicit") else "EXPLICIT"
    opt = _small_option(np.float64, kind, fused="fused" in path)
    if path.endswith("neumann"):
        opt = dataclasses.replace(opt, solver_option=dataclasses.replace(
            opt.solver_option, precond=PrecondKind.NEUMANN))
    s = _small_scene(np.float64)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx, opt)
    _to_plain(monkeypatch)
    one = flat_solve(*args, device="cuda")
    two = flat_solve(*args, device="cuda")
    for f in dataclasses.fields(one.trace):
        assert _bitwise_equal(getattr(one.trace, f.name),
                              getattr(two.trace, f.name)), f.name
    assert _bitwise_equal(one.cameras, two.cameras)
    assert _bitwise_equal(one.points, two.points)


@pytest.mark.cuda
@pytest.mark.parametrize("n,Tc", [(700, 200), (20000, 13)],
                         ids=["slot_tiles", "block_per_camera"])
def test_cuda_ring_step_kernels_match_plain(n, Tc):
    """On the card: kernels 7 and 8 in their ring-step call form
    (`fused_single_block_apply`) against their plain versions, f64 and
    f32, bitwise repeatable, counted under their own names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(n)
    Sp = 500
    in_local = rng.integers(0, Sp, n)
    out_local = np.sort(rng.integers(0, Tc, n))
    plan = tfused.ring_step_plan(in_local, out_local, np.arange(n), Sp, Tc,
                                 dev)
    assert plan.out.per_thread == (n == 700)
    for dtype, tol in ((np.float64, 1e-12), (np.float32, 1e-5)):
        W, Jin, Jout = (torch.from_numpy(
            (0.1 * rng.standard_normal((rows, n))).astype(dtype)).to(dev)
            for rows in (27, 6, 18))
        table = torch.from_numpy(rng.standard_normal((3, Sp)).astype(
            dtype)).to(dev)
        for kernel, args, kw in (
                (tfused.fused_ring_step_apply, (W, table, plan), {}),
                (tfused.fused_ring_step_apply_implicit,
                 (Jin, Jout, table, plan), {})):
            before = kernel.launches
            if kernel is tfused.fused_ring_step_apply:
                got = tfused.fused_single_block_apply(W, table, plan)
            else:
                got = tfused.fused_single_block_apply(Jin, table, plan,
                                                      rows_out=Jout)
            again = kernel(*args, **kw)
            plain = getattr(tfused, kernel.__name__ + "_plain")
            ref = plain(*args, **kw)
            scale = plain(*(a.abs() if isinstance(a, torch.Tensor) else a
                            for a in args), **kw)
            torch.cuda.synchronize()
            assert kernel.launches == before + 2
            assert torch.equal(got, again)
            assert bool(((got - ref).abs() <= tol * scale).all())


_MESH_PATHS = {
    # name: (kind, fused, world, mesh_2d, extra)
    "w2_implicit": ("IMPLICIT", False, 2, False, {}),
    "w2_explicit": ("EXPLICIT", False, 2, False, {}),
    "w2_nan_burst": ("IMPLICIT", False, 2, False, dict(guards=True)),
    "w2_two_level": ("IMPLICIT", False, 2, False, dict(
        precond="TWO_LEVEL")),
    "2x2_implicit": ("IMPLICIT", False, 4, True, {}),
    "2x2_implicit_fused": ("IMPLICIT", True, 4, True, {}),
    "2x2_explicit_fused": ("EXPLICIT", True, 4, True, {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(_MESH_PATHS))
def test_f64_multi_device_paths_kernels_match_plain(monkeypatch, path):
    """On the card, every shard on cuda:0: the 1-D and 2-D meshes through
    the kernels and through their plain versions (trial costs at rtol
    1e-9, NaN at the same iterations, equal traces, counts and status),
    two kernel solves bitwise equal, and the kernel solve against the
    world-1 kernel solve at rtol 1e-9 with equal counts; the fused 2-D
    paths launch the ring-step kernels, every shard its share."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from megba_tpu_torch import (PrecondKind, RobustOption, SolveStatus,
                                 flat_solve, make_nan_burst)
    from megba_tpu_torch.parallel.collectives import ShardLaunches

    kind, fused, world, mesh2d, extra = _MESH_PATHS[path]
    base = _small_option(np.float64, kind, fused=fused)
    so = dataclasses.replace(
        base.solver_option,
        precond=PrecondKind[extra.get("precond", "JACOBI")])
    one_opt = dataclasses.replace(
        base, solver_option=so,
        robust_option=RobustOption(guards=extra.get("guards", False)))
    opt = dataclasses.replace(
        one_opt, world_size=world, solver_option=dataclasses.replace(
            so, mesh_2d=mesh2d, cam_blocks=2 if mesh2d else 0))
    s = _small_scene(np.float64)
    kw = {}
    if extra.get("guards"):
        kw["fault_plan"] = make_nan_burst(s.obs.shape[0], [2, 9], 0, 1)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    devs = ["cuda:0"] * world
    for m in (tseg, tfused):
        m.reset_launch_counts()
    ring = (tfused.fused_ring_step_apply_implicit if kind == "IMPLICIT"
            else tfused.fused_ring_step_apply)
    with ShardLaunches([ring]) as tally:
        kern = flat_solve(*args, opt, device=devs, **kw)
    if fused:
        assert ring.launches > 0
        assert sorted(tally.counts[ring.__name__]) == list(range(world))
    again = flat_solve(*args, opt, device=devs, **kw)
    one = flat_solve(*args, one_opt, device="cuda", **kw)
    _to_plain(monkeypatch)
    plain = flat_solve(*args, opt, device=devs, **kw)
    k = kern.iterations
    tally = (k, kern.accepted, kern.pcg_iterations, kern.status,
             kern.recoveries)
    assert tally == (plain.iterations, plain.accepted, plain.pcg_iterations,
                     plain.status, plain.recoveries)
    assert tally == (one.iterations, one.accepted, one.pcg_iterations,
                     one.status, one.recoveries)
    for f in ("accept", "pcg_iters", "recovery", "precond_fallback"):
        assert torch.equal(getattr(kern.trace, f)[:k],
                           getattr(plain.trace, f)[:k]), f
    ck = kern.trace.cost[:k].numpy()
    for other in (plain, one):
        co = other.trace.cost[:k].numpy()
        np.testing.assert_array_equal(np.isnan(ck), np.isnan(co))
        fin = ~np.isnan(ck)
        np.testing.assert_allclose(ck[fin], co[fin], rtol=1e-9)
    for f in dataclasses.fields(kern.trace):
        assert _bitwise_equal(getattr(kern.trace, f.name),
                              getattr(again.trace, f.name)), f.name
    if extra.get("guards"):
        assert kern.status == SolveStatus.RECOVERED
    else:
        assert float(kern.cost) < float(kern.initial_cost)


# The block shapes of the registered factor families beside BAL's (the
# (2, 6) of a Problem edge on a pose camera, and the sim(3) pose graph's
# (7, 7)): kernels 1-3 are instantiated for each (csrc/block_shapes.cuh).
_FAMILY_BLOCKS = [(1, 4), (1, 2), (2, 7), (2, 12), (6, 6), (6, 3), (2, 6),
                  (7, 7)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _within_abs_sum(name, got, ref, scale, dtype):
    """|kernel - plain| within 1e-5 (f32) / 1e-12 (f64) of the plain
    version's sums of the terms' magnitudes (chip_smoke.py's rule)."""
    rel = 1e-12 if dtype == np.float64 else 1e-5
    err = (got - ref).abs()
    assert bool((err <= rel * scale).all()), (name, float(err.max()))


# Precision arms: (row dtype, vector dtype, bf16_operands), as
# ops/kernels.ARMS names them.
_ARMS = {"f32": (torch.float32, torch.float32, False),
         "f64": (torch.float64, torch.float64, False),
         "mixed": (torch.bfloat16, torch.float32, False),
         "mixed64": (torch.bfloat16, torch.float64, False),
         "bf16": (torch.bfloat16, torch.float32, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("arm", list(_ARMS))
@pytest.mark.parametrize("od,d", _FAMILY_BLOCKS,
                         ids=[f"{od}x{d}" for od, d in _FAMILY_BLOCKS])
def test_cuda_kernels_at_family_block_shapes(od, d, arm):
    """On the card: kernels 1-3 at each family's block shape, against the
    plain versions, on both launch shapes (a thread per segment on the
    short segments, a block per segment on one 6000-edge segment); two
    launches bitwise equal, the J^T J rows exactly symmetric (the
    triangle form writes each sum to both halves), one launch counted
    per call, per arm and per shape.  The bf16-row arms (mixed, mixed64,
    bf16) are kernels 2 and 3's alone."""
    dev = _need_card()
    rows_dt, vec_dt, ops = _ARMS[arm]
    for ns, idx in ((2000, _segment_ids(5, 2000)),
                    (1, np.zeros(6000, np.int32))):
        hplan = tseg.build_seg_plan(idx, ns)
        plan = tseg.device_plan(hplan, np.zeros_like(hplan.perm), dev)
        J, r, table = _inputs(5, idx.shape[0], ns, d, np.float64, od=od)
        Jt, rt = (_port_slots(a, hplan).to(dev) for a in (J, r))
        tt = torch.from_numpy(table).to(dev)
        Jt, rt, tt = Jt.to(rows_dt), rt.to(vec_dt), tt.to(vec_dt)
        cases = [("coupling_expand", (tt, Jt, plan, d)),
                 ("coupling_reduce", (Jt, rt, plan, d))]
        if rows_dt == vec_dt:
            cases.insert(0, ("jtj_grad_reduce", (Jt, rt, plan)))
        for name, args in cases:
            kernel = getattr(tseg, name)
            plain = getattr(tseg, name + "_plain")
            kw = {} if name == "jtj_grad_reduce" else dict(bf16_operands=ops)
            before = kernel.shape_launches.get((od, d), 0)
            before_arm = kernel.arm_launches.get(arm, 0)
            got, again = kernel(*args, **kw), kernel(*args, **kw)
            torch.cuda.synchronize()
            assert kernel.shape_launches[(od, d)] == before + 2
            assert kernel.arm_launches[arm] == before_arm + 2
            if name == "jtj_grad_reduce":
                h = got[0].reshape(d, d, ns)
                assert torch.equal(h, h.transpose(0, 1))
            got, again, ref, scale = (
                torch.cat(x) if isinstance(x, tuple) else x
                for x in (got, again, plain(*args, **kw),
                          plain(*(a.abs() if isinstance(a, torch.Tensor)
                                  and a.is_floating_point() else a
                                  for a in args), **kw)))
            assert got.dtype == vec_dt and torch.equal(got, again), name
            _within_abs_sum(name, got, ref, scale.abs(),
                            np.float64 if vec_dt == torch.float64
                            else np.float32)


# The (cd, pd, od) of each registered family (csrc/fused_shapes.cuh):
# kernels 6-8 are instantiated for each, in every arm.
_FAMILY_COUPLINGS = [(4, 2, 1), (7, 3, 2), (12, 3, 2), (6, 3, 6), (6, 3, 2),
                     (9, 3, 2)]


def _coupling_graphs(dev):
    """Two graphs for both launch shapes of kernels 7 and 8: short
    segments on both sides (slot tiles both ways; point 0 holds a
    400-slot track, summed by its whole tile's block), and 12 long
    cameras (pt -> cam a block per camera)."""
    out = []
    for nc, npt, n in ((4000, 3000, 12000), (12, 2000, 9000)):
        cam_idx, pt_idx = _graph(11, nc, npt, n)
        pt_idx[:400] = 0
        _, plans = tseg.make_dual_plans(cam_idx, pt_idx, nc, npt, dev)
        out.append((nc, npt, n, tfused.with_fused_plans(plans)))
    return out


def _check_shape(kernel, plain, args, arm, shape, dtype, **kw):
    """`_check_arm` and one launch counted per call at `shape`."""
    before = kernel.shape_launches.get(shape, 0)
    _check_arm(kernel, plain, args, arm, dtype, **kw)
    assert kernel.shape_launches[shape] == before + 2, (shape,
                                                       kernel.shape_launches)


def _check_couplings(dev, cd, pd, od, arm):
    """Kernels 8, 7 (both directions, both launch shapes) and 6 at one
    (cd, pd, od) in one arm against their plain versions."""
    rows_dt, vec_dt, ops = _ARMS[arm]
    rng = np.random.default_rng(12)

    def rand(*shape, scale=1.0):
        return (scale * torch.from_numpy(rng.standard_normal(shape))).to(dev)

    for nc, npt, n, plans in _coupling_graphs(dev):
        W = rand(cd * pd, n, scale=0.1)
        Jc, Jp = rand(od * cd, n, scale=0.1), rand(od * pd, n, scale=0.1)
        x_cam, x_pt = rand(cd, nc).to(vec_dt), rand(pd, npt).to(vec_dt)
        k8 = (tfused.fused_coupling_apply, tfused.fused_coupling_apply_plain)
        k7 = (tfused.fused_coupling_apply_implicit,
              tfused.fused_coupling_apply_implicit_plain)
        for rows, x, fplan, major, shape in (
                (plans.to_pt(W), x_cam, plans.fused_to_pt, True, (cd, pd)),
                (W, x_pt, plans.fused_to_cam, False, (pd, cd))):
            _check_shape(*k8, (rows.to(rows_dt), x, fplan, major), arm,
                         shape, vec_dt, bf16_operands=ops)
        for jin, jout, x, fplan, shape in (
                (plans.to_pt(Jc), plans.to_pt(Jp), x_cam, plans.fused_to_pt,
                 (cd, pd, od)),
                (plans.to_cam(Jp), Jc, x_pt, plans.fused_to_cam,
                 (pd, cd, od))):
            _check_shape(*k7, (jin.contiguous().to(rows_dt),
                               jout.contiguous().to(rows_dt), x, fplan),
                         arm, shape, vec_dt, bf16_operands=ops)
        if arm != "mixed64":  # kernel 6 has no mixed64 arm
            A = rand(nc, cd, cd)
            Hrows = tfused.block_diag_rows(A @ A.transpose(1, 2))
            _check_shape(tfused.fused_block_diag_apply,
                         tfused.fused_block_diag_apply_plain,
                         (Hrows.to(rows_dt), x_cam), arm, (cd,), vec_dt,
                         bf16_operands=ops)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", list(_ARMS))
@pytest.mark.parametrize("cd,pd,od", _FAMILY_COUPLINGS,
                         ids=[f"{c}x{p}x{o}" for c, p, o in _FAMILY_COUPLINGS])
def test_cuda_fused_kernels_at_family_shapes(cd, pd, od, arm):
    """On the card: kernels 8 and 7 in both directions on both launch
    shapes (slot tiles, a long track among them; a block per camera) and
    kernel 6, at each family's (cd, pd, od) in each arm, against their
    plain versions within 1e-5 (f32 sums) / 1e-12 (f64 sums) of the
    terms' magnitude sums; two launches bitwise equal; one launch counted
    per call, per arm and per shape."""
    _check_couplings(_need_card(), cd, pd, od, arm)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_cuda_seg_kernels_at_every_width(dtype):
    """On the card: kernels 4 and 5 at every width F = 1..16 of
    csrc/fused_shapes.cuh, on a block-per-segment side (12 cameras) and a
    thread-per-segment side (points), against their plain versions, two
    launches bitwise equal, one launch counted per call and width."""
    dev = _need_card()
    assert tseg.SUPPORTED_WIDTHS == tuple(range(1, 17))
    cam_idx, pt_idx = _graph(13, 12, 2000, 9000)
    _, plans = tseg.make_dual_plans(cam_idx, pt_idx, 12, 2000, dev)
    rng = np.random.default_rng(14)
    arm = "f64" if dtype == np.float64 else "f32"
    vec_dt = torch.float64 if dtype == np.float64 else torch.float32

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev, vec_dt)

    for F in tseg.SUPPORTED_WIDTHS:
        for side in (plans.cam, plans.pt):
            _check_shape(tseg.seg_reduce, tseg.seg_reduce_plain,
                         (rand(F, 9000), side), arm, (F,), vec_dt)
            _check_shape(tseg.seg_expand, tseg.seg_expand_plain,
                         (rand(F, side.num_segments), side), arm, (F,),
                         vec_dt)


@pytest.mark.cuda
def test_cuda_fused_shape_outside_the_list_builds_at_first_use():
    """Kernels 6-8 at a shape outside csrc/fused_shapes.cuh (a Problem
    edge of 3 residual rows on a 5-parameter camera and a 2-parameter
    point) build libraries of their own at first use and agree with the
    plain versions; beyond the cap each wrapper raises a typed
    NotImplementedError naming the kernel and the shape."""
    dev = _need_card()
    assert (5, 2, 3) not in tfused.SUPPORTED_IMPLICIT
    for arm in ("f64", "mixed"):
        _check_couplings(dev, 5, 2, 3, arm)
    nc, npt, n, plans = _coupling_graphs(dev)[1]
    x17 = torch.zeros(17, nc, device=dev, dtype=torch.float64)
    with pytest.raises(NotImplementedError,
                       match=r"fused_block_diag_apply: .*17"):
        tfused.fused_block_diag_apply(torch.zeros(289, nc, device=dev,
                                                  dtype=torch.float64), x17)
    with pytest.raises(NotImplementedError,
                       match=r"fused_coupling_apply: .*\(17, 3, True\)"):
        tfused.fused_coupling_apply(
            torch.zeros(51, n, device=dev, dtype=torch.float64),
            x17, plans.fused_to_pt, True)
    with pytest.raises(NotImplementedError,
                       match=r"fused_coupling_apply_implicit: .*\(9, 3, 9\)"):
        tfused.fused_coupling_apply_implicit(
            torch.zeros(81, n, device=dev, dtype=torch.float64),
            torch.zeros(27, n, device=dev, dtype=torch.float64),
            torch.zeros(9, nc, device=dev, dtype=torch.float64),
            plans.fused_to_pt)


@pytest.mark.cuda
def test_cuda_block_shape_outside_the_list_builds_at_first_use():
    """A shape outside csrc/block_shapes.cuh (a 5-parameter camera) gets
    a library of its own at first use and agrees with the plain
    versions; beyond the cap the wrappers raise a typed
    NotImplementedError naming the kernel and the shape."""
    dev = _need_card()
    idx = _segment_ids(6, 500)
    hplan = tseg.build_seg_plan(idx, 500)
    plan = tseg.device_plan(hplan, np.zeros_like(hplan.perm), dev)
    for d in (5, 17):
        J, r, table = _inputs(6, idx.shape[0], 500, d, np.float64)
        Jt, rt = (_port_slots(a, hplan).to(dev) for a in (J, r))
        tt = torch.from_numpy(table).to(dev)
        for name, args in (("jtj_grad_reduce", (Jt, rt, plan)),
                           ("coupling_expand", (tt, Jt, plan, d)),
                           ("coupling_reduce", (Jt, rt, plan, d))):
            kernel = getattr(tseg, name)
            if d == 17:
                with pytest.raises(NotImplementedError,
                                   match=rf"{name}: .*\(2, 17\)"):
                    kernel(*args)
                continue
            got = kernel(*args)
            ref = getattr(tseg, name + "_plain")(*args)
            got, ref = (torch.cat(x) if isinstance(x, tuple) else x
                        for x in (got, ref))
            torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def _family_scene(factor):
    from megba_tpu_torch.factors import priors, radial, rig
    from megba_tpu_torch.models.planar import make_synthetic_planar

    if factor == "planar":
        return make_synthetic_planar(8, 600, 4, seed=1)
    if factor == "rig":
        return rig.make_synthetic_rig(8, 600, 2, 3, seed=1)
    if factor == "pinhole_radial":
        return radial.make_synthetic_radial(8, 600, 4, seed=1)
    return priors.make_synthetic_priors(64, 2, prior_noise=0.01, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("factor", ["planar", "rig", "pinhole_radial",
                                    "pose_prior"])
def test_f64_family_solve_kernels_match_plain(monkeypatch, factor):
    """On the card: `flat_solve(factor=...)` at f64 with ProblemOption()
    (AUTODIFF) through the kernels and through their plain versions:
    trial costs within 1e-9, equal accepts, counts and status; two
    kernel solves bitwise equal; the family's shapes launched."""
    from megba_tpu_torch import AlgoOption, ProblemOption, flat_solve
    from megba_tpu_torch.factors import get_factor

    _need_card()
    s = _family_scene(factor)
    spec = get_factor(factor)
    opt = ProblemOption(algo_option=AlgoOption(max_iter=5, epsilon1=1e-12,
                                               epsilon2=1e-15))
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx, opt)
    od = spec.residual_dim
    tseg.reset_launch_counts()
    kern = flat_solve(*args, device="cuda", factor=factor)
    for name in ("jtj_grad_reduce", "coupling_expand", "coupling_reduce"):
        shapes = getattr(tseg, name).shape_launches
        assert shapes.get((od, spec.cam_dim)) and shapes.get(
            (od, spec.pt_dim)), (name, shapes)
    again = flat_solve(*args, device="cuda", factor=factor)
    _to_plain(monkeypatch)
    plain = flat_solve(*args, device="cuda", factor=factor)
    k = kern.iterations
    assert k > 1
    assert (k, kern.accepted, kern.pcg_iterations, kern.status) == (
        plain.iterations, plain.accepted, plain.pcg_iterations, plain.status)
    assert torch.equal(kern.trace.accept[:k], plain.trace.accept[:k])
    assert torch.equal(kern.trace.cost[:k], again.trace.cost[:k])
    assert torch.equal(kern.cameras, again.cameras)
    np.testing.assert_allclose(kern.trace.cost[:k].numpy(),
                               plain.trace.cost[:k].numpy(), rtol=1e-9)
    assert float(kern.cost) < float(kern.initial_cost)


# The non-default Schur paths of a family (kernels 4-8 at its shapes):
# (compute kind, fused_kernels, option fields).
_FAMILY_PATHS = {
    "explicit": ("EXPLICIT", False, {}),
    "implicit_fused": ("IMPLICIT", True, {}),
    "explicit_fused": ("EXPLICIT", True, {}),
    "schur_diag": ("IMPLICIT", False, dict(preconditioner="SCHUR_DIAG")),
    "two_level": ("IMPLICIT", False, dict(precond="TWO_LEVEL")),
    "mixed_fused": ("IMPLICIT", True, dict(mixed=True)),
}


def _family_option(path, dtype=np.float64, bf16=False):
    """ProblemOption()'s PCG with the path's fields under an LM cap of 5
    (test_f64_family_solve_kernels_match_plain's options): driven to an
    absolute tolerance of 1e-10 instead, the 8-camera planar SCHUR_DIAG
    solve moves its trial costs by up to 2.7e-10 under a 1e-15 relative
    change of the observations through the plain versions alone, where
    these options move them by 9e-14.  At float32 a rung's PCG stops at
    1e-6 of the RHS energy (chip_smoke.precision_phase says why), from
    trust region 1 (chip_smoke.FAMILY_F32_REGION says why)."""
    from megba_tpu_torch import (AlgoOption, ComputeKind, PrecondKind,
                                 PreconditionerKind, ProblemOption,
                                 SolverOption)

    kind, fused, extra = _FAMILY_PATHS[path]
    so = dict(fused_kernels=fused, bf16=bf16,
              precond=PrecondKind[extra.get("precond", "JACOBI")],
              preconditioner=PreconditionerKind[
                  extra.get("preconditioner", "HPP")])
    if dtype == np.float32:
        so.update(max_iter=30, tol=1e-6, tol_relative=True,
                  refuse_ratio=1e30)
    return ProblemOption(
        dtype=dtype, compute_kind=ComputeKind[kind],
        mixed_precision_pcg=extra.get("mixed", False),
        algo_option=AlgoOption(
            max_iter=5, epsilon1=1e-12, epsilon2=1e-15,
            initial_region=1.0 if extra.get("mixed") or dtype == np.float32
            else 1e3),
        solver_option=SolverOption(**so))


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(_FAMILY_PATHS))
@pytest.mark.parametrize("factor", ["planar", "rig", "pinhole_radial",
                                    "pose_prior"])
def test_f64_family_paths_kernels_match_plain(monkeypatch, factor, path):
    """On the card: a family's EXPLICIT, fused IMPLICIT and EXPLICIT,
    SCHUR_DIAG, TWO_LEVEL and fused mixed paths at f64 (kernels 4-8 at
    its shapes) through the kernels and through their plain versions:
    trial costs within 1e-9, equal accepts, counts and status; two
    kernel solves bitwise equal; every fused or segment kernel the path
    runs launched at the family's shapes alone."""
    from megba_tpu_torch import flat_solve
    from megba_tpu_torch.factors import get_factor

    _need_card()
    s = _family_scene(factor)
    spec = get_factor(factor)
    cd, pd, od = spec.cam_dim, spec.pt_dim, spec.residual_dim
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
            _family_option(path))
    for m in (tseg, tfused):
        m.reset_launch_counts()
    kern = flat_solve(*args, device="cuda", factor=factor)
    shapes = {**tfused.shape_launch_counts(), **tseg.shape_launch_counts()}
    kind, fused, _ = _FAMILY_PATHS[path]
    want = ({f"fused_coupling_apply_implicit({cd},{pd},{od})",
             f"fused_coupling_apply_implicit({pd},{cd},{od})",
             f"fused_block_diag_apply({cd})"} if fused and kind == "IMPLICIT"
            else {f"fused_coupling_apply({cd},{pd})",
                  f"fused_coupling_apply({pd},{cd})",
                  f"fused_block_diag_apply({cd})"} if fused
            else {f"seg_reduce({cd})", f"seg_reduce({pd})",
                  f"seg_expand({cd})", f"seg_expand({pd})"}
            if kind == "EXPLICIT" else {f"seg_reduce({cd})"})
    assert want <= set(shapes), (want, shapes)
    fused_rows = {k for k in shapes if k.startswith("fused_")}
    assert fused_rows <= want, (fused_rows, want)
    again = flat_solve(*args, device="cuda", factor=factor)
    _to_plain(monkeypatch)
    plain = flat_solve(*args, device="cuda", factor=factor)
    k = kern.iterations
    assert k > 1
    assert (k, kern.accepted, kern.pcg_iterations, kern.status) == (
        plain.iterations, plain.accepted, plain.pcg_iterations, plain.status)
    assert torch.equal(kern.trace.accept[:k], plain.trace.accept[:k])
    assert torch.equal(kern.trace.cost[:k], again.trace.cost[:k])
    np.testing.assert_allclose(kern.trace.cost[:k].numpy(),
                               plain.trace.cost[:k].numpy(), rtol=1e-9)
    assert float(kern.cost) < float(kern.initial_cost)


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["mixed", "bf16"])
@pytest.mark.parametrize("factor", ["planar", "rig", "pinhole_radial",
                                    "pose_prior"])
def test_f32_family_rungs_kernels_match_plain(monkeypatch, factor, rung):
    """On the card: a family's fused IMPLICIT solve on the mixed or bf16
    rung at f32 (relative PCG tolerance), kernels against plain versions:
    the first trial cost within 1e-4 (mixed) / 2e-2 (bf16), the final
    cost within 1e-3, both below the initial (chip_smoke.py's phase 6
    rules; the bf16 rung is held to the port's own plain solve, not to
    JAX's, whose bf16 CG parts from it on pinhole_radial)."""
    from megba_tpu_torch import flat_solve

    _need_card()
    s = _family_scene(factor)
    opt = _family_option("mixed_fused" if rung == "mixed" else
                         "implicit_fused", np.float32, bf16=rung == "bf16")
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx, opt)
    kern = flat_solve(*args, device="cuda", factor=factor)
    _to_plain(monkeypatch)
    plain = flat_solve(*args, device="cuda", factor=factor)
    first = abs(float(kern.trace.cost[0]) - float(plain.trace.cost[0]))
    assert first <= {"mixed": 1e-4, "bf16": 2e-2}[rung] * abs(
        float(plain.trace.cost[0]))
    c0 = float(kern.initial_cost)
    for res in (kern, plain):
        assert np.isfinite(float(res.cost)) and float(res.cost) < c0
    np.testing.assert_allclose(float(kern.cost), float(plain.cost),
                               rtol=1e-3)


@pytest.mark.cuda
def test_f64_problem_custom_edge_kernels_match_plain(monkeypatch):
    """On the card: a Problem whose custom forward() has a 5-parameter
    camera ([angle-axis, tx, ty]; tz and the focal as edge constants),
    so its camera side runs kernels 1-3 at (2, 5), a shape built at first
    use; kernels vs plain at f64."""
    from megba_tpu_torch import (AlgoOption, BaseEdge, BaseProblem,
                                 CameraVertex, PointVertex, ProblemOption)
    from megba_tpu_torch.io.synthetic import make_synthetic_bal
    from megba_tpu_torch.ops import geo

    _need_card()

    class PanTiltEdge(BaseEdge):
        def forward(self):
            cam, X, m = (self.vertex_estimation(0),
                         self.vertex_estimation(1), self.get_measurement())
            t = torch.stack([cam[3], cam[4], m[2]])
            P = geo.angle_axis_rotate_point(cam[0:3], X) + t
            return m[3] * (-P[0:2] / P[2]) - m[0:2]

    s = make_synthetic_bal(num_cameras=8, num_points=400, obs_per_point=3,
                           seed=2, param_noise=1e-2, pixel_noise=0.5)

    def solve():
        pb = BaseProblem(ProblemOption(algo_option=AlgoOption(
            max_iter=5, epsilon1=1e-12, epsilon2=1e-15)), device="cuda")
        cams = [CameraVertex(c[:5]) for c in s.cameras0]
        pts = [PointVertex(p) for p in s.points0]
        for i, v in enumerate(cams + pts):
            pb.append_vertex(i, v)
        for c, p, uv in zip(s.cam_idx, s.pt_idx, s.obs):
            m = np.concatenate([uv, s.cameras0[c, 5:7]])
            pb.append_edge(PanTiltEdge([cams[c], pts[p]], measurement=m))
        return pb.solve()

    tseg.reset_launch_counts()
    kern = solve()
    assert tseg.jtj_grad_reduce.shape_launches.get((2, 5))
    _to_plain(monkeypatch)
    plain = solve()
    k = kern.iterations
    assert k > 1 and (k, kern.accepted, kern.pcg_iterations) == (
        plain.iterations, plain.accepted, plain.pcg_iterations)
    np.testing.assert_allclose(kern.trace.cost[:k].numpy(),
                               plain.trace.cost[:k].numpy(), rtol=1e-9)


# The split-segment launch of kernels 1 and 3 (csrc/segreduce.cuh,
# reduce_split_segments): plans whose segments are long, as lengths.
_SPLIT_C, _SPLIT_A = tseg.SPLIT_CHUNK, tseg.SPLIT_ABOVE
_SPLIT_PLANS = {
    "one_segment_200000": [200_000],
    "edge_lengths": [0, 1, _SPLIT_C - 1, _SPLIT_C, _SPLIT_C + 1, _SPLIT_A,
                     _SPLIT_A + 1, 7 * _SPLIT_C + 3],
    "zipf_tracks_x16": None,
}


def _split_plan(lengths, dev):
    """A device plan of consecutive segments of `lengths` slots (the zipf
    case: the track lengths of a heavy-tailed graph's 2000 points, each
    times 16, so that the mean length reaches the block launch's)."""
    if lengths is None:
        from megba_tpu_torch.io.synthetic import heavy_tailed_graph

        _, pt_idx = heavy_tailed_graph(12, 2000, seed=3)
        lengths = 16 * np.bincount(pt_idx, minlength=2000)
    lengths = np.asarray(lengths, np.int64)
    idx = np.repeat(np.arange(lengths.shape[0]), lengths).astype(np.int32)
    hplan = tseg.build_seg_plan(idx, lengths.shape[0])
    return tseg.device_plan(hplan, np.zeros_like(hplan.perm), dev)


def _split_inputs(seed, n, od, d, arm, dev):
    rows_dt, vec_dt, _ = _ARMS[arm]
    rng = np.random.default_rng(seed)
    J = torch.from_numpy(0.1 * rng.standard_normal((od * d, n))).to(dev)
    u = torch.from_numpy(rng.standard_normal((od, n))).to(dev)
    return J.to(rows_dt), u.to(vec_dt)


def _split_calls(J, u, plan, d, arm):
    """(name, kernel, plain, args, kwargs) of kernels 1 (f32 / f64 arms
    only) and 3 on one plan."""
    ops = _ARMS[arm][2]
    calls = [("coupling_reduce", tseg.coupling_reduce,
              tseg.coupling_reduce_plain, (J, u, plan, d),
              dict(bf16_operands=ops))]
    if J.dtype == u.dtype:
        calls.insert(0, ("jtj_grad_reduce", tseg.jtj_grad_reduce,
                         tseg.jtj_grad_reduce_plain, (J, u, plan), {}))
    return calls


def _cat(x):
    return torch.cat(x) if isinstance(x, tuple) else x


@pytest.mark.cuda
@pytest.mark.parametrize("arm", list(_ARMS))
@pytest.mark.parametrize("od,d", tseg.SUPPORTED_BLOCKS,
                         ids=[f"{od}x{d}" for od, d in tseg.SUPPORTED_BLOCKS])
def test_cuda_split_segments_match_plain(od, d, arm):
    """On the card: kernels 1 and 3 on plans of long segments (one
    segment of 200,000 slots; lengths 0, 1, C - 1, C, C + 1 and 7C + 3;
    Zipf track lengths, times 16) at every listed block shape and
    arm (lengths A = SPLIT_ABOVE and A + 1 too: one chunk, and the
    first length split), against the plain versions within 1e-5 (float
    sums) / 1e-12
    (double sums) of the terms' magnitude sums, the float sums against
    the plain version in float64 (over 1e5 slots two float32 orders part
    by more); empty segments exactly zero; two launches bitwise equal;
    kernel 1 then kernel 3 on one plan, twice, bitwise the same both
    times (each launch leaves the plan's counters at zero)."""
    dev = _need_card()
    vec_dt = _ARMS[arm][1]
    for case, lengths in _SPLIT_PLANS.items():
        plan = _split_plan(lengths, dev)
        assert not plan.per_thread and plan.split is not None, case
        J, u = _split_inputs(7, plan.n_slots, od, d, arm, dev)
        calls = _split_calls(J, u, plan, d, arm)
        first = [_cat(k(*a, **kw)) for _, k, _, a, kw in calls]
        second = [_cat(k(*a, **kw)) for _, k, _, a, kw in calls]
        torch.cuda.synchronize()
        assert not plan.split.counters.any(), case
        lens = plan.seg_ptr[1:] - plan.seg_ptr[:-1]
        for (name, _, plain, args, kw), got, again in zip(calls, first,
                                                          second):
            assert got.dtype == vec_dt and torch.equal(got, again), (
                case, name)
            assert not got[:, lens == 0].any(), (case, name)
            f64 = tuple(a.to(torch.float64) if isinstance(a, torch.Tensor)
                        and a.dtype == torch.float32 else a for a in args)
            ref = _cat(plain(*f64, **kw))
            scale = _cat(plain(*(a.abs() if isinstance(a, torch.Tensor)
                                 and a.is_floating_point() else a
                                 for a in f64), **kw)).abs()
            _within_abs_sum(f"{case} {name}", got.to(torch.float64), ref,
                            scale, np.float64 if vec_dt == torch.float64
                            else np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", list(_ARMS))
@pytest.mark.parametrize("od,d", [(2, 9), (6, 3), (2, 12)],
                         ids=["2x9", "6x3", "2x12"])
def test_cuda_split_segment_sums_do_not_depend_on_the_offset(od, d, arm):
    """On the card: a segment of 7C + 3 slots summed alone, and inside a
    longer stream at an odd offset (after a 5-slot and an empty segment,
    before a long one), gives bitwise the same sums in kernels 1 and 3:
    its chunks, and so its summation order, depend on its length alone
    (the bf16 rows' pair loads are misaligned at the odd offset and go
    through single loads of the same values)."""
    dev = _need_card()
    L = 7 * _SPLIT_C + 3
    alone = _split_plan([L], dev)
    inside = _split_plan([5, 0, L, 2 * _SPLIT_C + 1], dev)
    J, u = _split_inputs(8, L, od, d, arm, dev)
    Jb, ub = _split_inputs(9, inside.n_slots, od, d, arm, dev)
    Jb[:, 5:5 + L], ub[:, 5:5 + L] = J, u
    for (name, kernel, _, a, kw), (_, _, _, b, _) in zip(
            _split_calls(J, u, alone, d, arm),
            _split_calls(Jb, ub, inside, d, arm)):
        got_alone, got_inside = _cat(kernel(*a, **kw)), _cat(kernel(*b, **kw))
        torch.cuda.synchronize()
        assert torch.equal(got_alone[:, 0], got_inside[:, 2]), name


# The pose-graph driver's paths on the card (models/pgo.py): (factor,
# robust kind, priors, world size).
_PGO_PATHS = {
    "se3": ("se3_between", None, False, 1),
    "sim3": ("sim3_between", None, False, 1),
    "se3_huber": ("se3_between", "HUBER", False, 1),
    "se3_priors": ("se3_between", None, True, 1),
    "se3_w2": ("se3_between", None, False, 2),
}


def _pgo_inputs(path):
    from megba_tpu_torch import AlgoOption, ProblemOption, RobustKind
    from megba_tpu_torch.factors.sim3 import make_synthetic_sim3_graph
    from megba_tpu_torch.models import pgo

    factor, robust, priors, world = _PGO_PATHS[path]
    make = (make_synthetic_sim3_graph if factor == "sim3_between"
            else pgo.make_synthetic_pose_graph)
    g = make(200, 40, meas_noise=0.01, seed=3)
    args, kw = [g.poses0, g.edge_i, g.edge_j, g.meas], {}
    if priors:
        idx = np.array([5, 90])
        out = pgo.with_priors(*args, prior_idx=idx,
                              prior_poses=g.poses_gt[idx],
                              prior_sqrt_info=np.broadcast_to(
                                  np.eye(6) * 10.0, (2, 6, 6)))
        args, kw = list(out[:4]), dict(fixed=out[4], sqrt_info=out[5])
    opt = ProblemOption(world_size=world,
                        algo_option=AlgoOption(max_iter=4, epsilon1=1e-12,
                                               epsilon2=1e-15))
    if robust is not None:
        opt = dataclasses.replace(opt, robust_kind=RobustKind[robust],
                                  robust_delta=0.1)
    return args, dict(kw, factor=factor), opt, world


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(_PGO_PATHS))
def test_f64_pose_graph_solves_kernels_match_plain(monkeypatch, path):
    """On the card: solve_pgo through kernels 1-3 at (rd, pd) and kernel
    6 at pd against the same solve through the plain versions (final
    cost at rtol 1e-9, equal counts, poses within 1e-9 of their
    magnitude), a world-2 solve on one card held to both, and the launch
    counts the code implies: per shard, kernel 1 twice per
    linearisation, kernels 2 and 3 twice per matvec, kernel 2 twice more
    per gain ratio; kernel 6 once per matvec."""
    dev = _need_card()
    from megba_tpu_torch.models import pgo

    args, kw, opt, world = _pgo_inputs(path)
    device = [dev] * world if world > 1 else dev
    tseg.reset_launch_counts()
    tfused.reset_launch_counts()
    kern = pgo.solve_pgo(*args, opt, device=device, **kw)
    torch.cuda.synchronize()
    counts = {**tseg.launch_counts(), **tfused.launch_counts()}
    d = 7 if kw["factor"] == "sim3_between" else 6
    mv = kern.pcg_iterations + kern.iterations
    want = {"jtj_grad_reduce": 2 * world * (1 + kern.accepted),
            "coupling_expand": 2 * world * (mv + kern.iterations),
            "coupling_reduce": 2 * world * mv,
            "fused_block_diag_apply": mv}
    assert {k: v for k, v in counts.items() if v} == want
    shapes = tseg.shape_launch_counts()
    assert {k for k, v in shapes.items() if v} == {
        f"{k}({d},{d})" for k in ("jtj_grad_reduce", "coupling_expand",
                                  "coupling_reduce")}
    assert tfused.shape_launch_counts()[f"fused_block_diag_apply({d})"] == mv
    _to_plain(monkeypatch)
    plain = pgo.solve_pgo(*args, opt, device=device, **kw)
    for other in (plain,) + ((pgo.solve_pgo(*args, dataclasses.replace(
            opt, world_size=1), device=dev, **kw),) if world > 1 else ()):
        np.testing.assert_allclose(float(kern.cost), float(other.cost),
                                   rtol=1e-9)
        assert (kern.iterations, kern.accepted, kern.pcg_iterations,
                kern.status) == (other.iterations, other.accepted,
                                 other.pcg_iterations, other.status)
        err = (kern.poses - other.poses).abs().max()
        assert float(err) <= 1e-9 * float(other.poses.abs().max())
    assert kern.accepted >= 1 and float(kern.cost) < float(kern.initial_cost)


# Kernel 4's launch (csrc/segsum.cu, seg_reduce_tiles): segment lengths
# at the edges of its shapes (a tile thread under 256 slots, the whole
# block from 256 to SPLIT_ABOVE, split chunks above; a thread per segment
# where every segment of a short side is under 256 slots).
_SEG4_LENGTHS = [0, 1, 255, 256, 257, 4096, 4097, 200_000]


def _seg4_plan(side, dev, lengths=_SEG4_LENGTHS, seed=0, short=100_000):
    """`lengths` on a side of long segments as they are, or on a side of
    short ones spliced among `short` segments of 0-7 slots."""
    lengths = np.asarray(lengths, np.int64)
    if side == "short":
        rng = np.random.default_rng(seed)
        fill = rng.integers(0, 8, short)
        at = np.sort(rng.choice(fill.shape[0], lengths.shape[0],
                                replace=False))
        fill[at] = lengths
        lengths = fill
    plan = _split_plan(lengths, dev)
    assert plan.per_thread == (side == "short"), side
    return plan


def _check_seg4_bounds(plan, side):
    shape = tseg.seg_reduce_shape(plan)
    assert shape["shape"] == ("slot tiles" if side == "short"
                              else "split chunks")
    for key, most in tseg.SEG_REDUCE_BOUNDS[shape["shape"]].items():
        assert shape[key] <= most, (side, key, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["short", "long"])
@pytest.mark.parametrize("F", [1, 3, 9, 16])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_cuda_seg_reduce_on_edge_lengths(dtype, F, side):
    """On the card: kernel 4 on segments of 0, 1, 255, 256, 257, 4096,
    4097 and 200,000 slots, on a side of short segments (slot tiles with
    the split chunks of the two longest) and of long ones (split chunks),
    against the plain version in float64 within 1e-5 (f32) / 1e-12 (f64)
    of the terms' magnitude sums; empty segments exactly zero; two
    launches bitwise equal, the plan's counters zero after them, one
    launch counted a call; the launch's bounded slots a block and a
    thread read off the plan's tables."""
    dev = _need_card()
    plan = _seg4_plan(side, dev)
    _check_seg4_bounds(plan, side)
    vec_dt = torch.float64 if dtype == np.float64 else torch.float32
    g = torch.Generator(device=dev).manual_seed(F)
    data = torch.randn((F, plan.n_slots), generator=g, device=dev,
                       dtype=vec_dt)
    before = tseg.seg_reduce.shape_launches.get((F,), 0)
    got = tseg.seg_reduce(data, plan)
    again = tseg.seg_reduce(data, plan)
    torch.cuda.synchronize()
    assert tseg.seg_reduce.shape_launches[(F,)] == before + 2
    assert got.dtype == vec_dt and torch.equal(got, again)
    assert not plan.split.counters.any()
    lens = plan.seg_ptr[1:] - plan.seg_ptr[:-1]
    assert not got[:, lens == 0].any()
    d64 = data.to(torch.float64)
    ref = tseg.seg_reduce_plain(d64, plan)
    scale = tseg.seg_reduce_plain(d64.abs(), plan)
    _within_abs_sum(f"{side} F={F}", got.to(torch.float64), ref, scale,
                    dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("L", [1, 200, 255, 256, 257, 4096, 4097, 10_000])
def test_cuda_seg_reduce_sums_do_not_depend_on_the_offset(L, dtype):
    """On the card: a segment of L slots summed by kernel 4 at the start
    of a stream and inside another at an odd offset, on a short side
    (among 0-7-slot segments) and on a long side (beside a 9,000-slot
    segment), gives bitwise the same sums: its order depends on its
    length (and the side's shape) alone."""
    dev = _need_card()
    vec_dt = torch.float64 if dtype == np.float64 else torch.float32
    rng = np.random.default_rng(L)
    fill = rng.integers(0, 8, 20_000).tolist()
    k = 7001
    prefix = [3] + fill[:k]
    if sum(prefix) % 2 == 0:
        prefix[0] = 4
    cases = {"short": ([L] + fill, 0, prefix + [L] + fill[k:], len(prefix)),
             "long": ([L, 9000], 0, [5, 0, L, 9000], 2)}
    g = torch.Generator(device=dev).manual_seed(L)
    seg = torch.randn((9, L), generator=g, device=dev, dtype=vec_dt)
    for side, (first, s_first, inside, s_inside) in cases.items():
        sums = []
        for lengths, s in ((first, s_first), (inside, s_inside)):
            plan = _seg4_plan("long", dev, lengths) if side == "long" else (
                _split_plan(lengths, dev))
            assert plan.per_thread == (side == "short")
            lo = int(plan.seg_ptr[s])
            data = torch.randn((9, plan.n_slots), generator=g, device=dev,
                               dtype=vec_dt)
            data[:, lo:lo + L] = seg
            sums.append(tseg.seg_reduce(data, plan)[:, s])
        torch.cuda.synchronize()
        assert torch.equal(sums[0], sums[1]), (side, L)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("side", ["short", "long"])
def test_cuda_seg_reduce_is_bitwise_its_order_model(side, dtype):
    """On the card: kernel 4's sums bitwise those of the order model of
    tests/test_torch_seg_reduce.py evaluated on the host in the same
    dtype: a short side's segments under 256 slots summed from 0 in
    ascending order (what the thread per segment gave), the block's
    strided sums, warp-shuffle tree and warps in order from 256 slots,
    the split chunks in chunk order above SPLIT_ABOVE."""
    from test_torch_seg_reduce import model_sums

    dev = _need_card()
    plan = _seg4_plan(side, dev, [0, 1, 200, 255, 256, 257, 300, 4096,
                                  4097, 10_000], seed=3, short=20_000)
    rng = np.random.default_rng(4)
    for F in (3, 9, 16):
        data = rng.standard_normal((F, plan.n_slots)).astype(dtype)
        got = tseg.seg_reduce(torch.from_numpy(data).to(dev), plan)
        want = model_sums(data, plan)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("F", [1, 3, 9, 16])
def test_cuda_seg_reduce_thread_shape_is_bitwise_the_tiles(F, dtype):
    """On the card: a short side whose segments are all under 256 slots
    runs a thread per segment, and the same side with one 256-slot
    segment appended runs slot tiles; every shorter segment's sums are
    bitwise the same in both (from 0, in ascending order), and the
    thread shape is bitwise the order model and reads no tile table."""
    from test_torch_seg_reduce import model_sums

    dev = _need_card()
    rng = np.random.default_rng(F)
    short = rng.integers(0, 8, 30_000)
    short[rng.choice(short.shape[0], 20, replace=False)] = 255
    thread = _split_plan(short, dev)
    tiles = _split_plan(np.append(short, 256), dev)
    assert tseg.seg_reduce_shape_of(thread) == "thread per segment"
    assert tseg.seg_reduce_shape_of(tiles) == "slot tiles"
    assert tseg._tile_args("seg_reduce", thread, dev) == (None, 0)
    data = rng.standard_normal((F, tiles.n_slots)).astype(dtype)
    whole = torch.from_numpy(data).to(dev)
    before = tseg.seg_reduce.shape_launches.get((F,), 0)
    got = tseg.seg_reduce(whole[:, :thread.n_slots].contiguous(), thread)
    ref = tseg.seg_reduce(whole, tiles)[:, :thread.num_segments]
    torch.cuda.synchronize()
    assert tseg.seg_reduce.shape_launches[(F,)] == before + 2
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(
        got.cpu().numpy(), model_sums(data[:, :thread.n_slots], thread))

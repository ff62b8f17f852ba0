"""The port's 1-D edge-sharded solve vs the JAX package, on the CPU.

The port runs N shards on `["cpu"] * N`, the JAX package its world-N
program on N of the 8 virtual CPU devices (tests/conftest.py).  The
port's shards take the JAX package's tiled partition (camera-sorted
edges cut at (k n) // N); its float64 reference, the untiled lowering,
pads to N * EDGE_QUANTUM and splits the padded stream, so the shards sum
other groups of edges: trial costs agree at rtol 1e-9, not bitwise.

- the collectives: shard-order sums, bf16 payloads, scatter and gather,
  a NaN reaching every sum;
- the mesh: `make_mesh` and `flat_solve` raise past the visible devices
  (no card here) and never fall back to the CPU; `factor_mesh_2d`;
  `validate_options` and `flat_solve` accept and refuse the multi-device
  options as the JAX package's do, with its messages;
- `make_sharded_dual_plans`: contiguous pieces of the camera-sorted
  stream, every shard planned over all vertices;
- `flat_solve` at world 2 and 4 on IMPLICIT and EXPLICIT (and with
  sqrt_info, an edge mask and fixed vertices) against JAX's world-N
  solve: trial costs at rtol 1e-9, equal accept pattern, LM / PCG counts
  and status; against the port's world-1 solve at rtol 1e-9;
- guards with a NaN burst at world 2: RECOVERED with JAX's recoveries;
- bf16 with bf16 collectives at world 2 at float32: within 2e-2 of JAX's
  and of the float32 solve, and not the uncompressed run's numbers;
- the plain full-system solver and forcing with warm starts at world 2
  against the port's world 1.

CPU only.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import megba_tpu.common as jc
from megba_tpu.parallel import mesh as jmesh
from megba_tpu.solve import flat_solve as j_flat_solve
from megba_tpu.ops.residuals import make_residual_jacobian_fn as j_engine

import megba_tpu_torch as mt
from megba_tpu_torch import common as tc
from megba_tpu_torch.convert import fault_plan_to_torch
from megba_tpu_torch.ops import segtiles as tseg
from megba_tpu_torch.parallel import collectives as col
from megba_tpu_torch.parallel import mesh as tmesh

from test_torch_guards import (_args, _jax_solve, _nan_plan, _options,
                               _scene, compare_robust)


# ---------------------------------------------------------------- collectives


def test_psum_sums_in_shard_order_and_keeps_nan():
    a = torch.tensor([1e16, 1.0, np.nan], dtype=torch.float64)
    b = torch.tensor([1.0, 2.0, 0.0], dtype=torch.float64)
    c = torch.tensor([-1e16, 3.0, 1.0], dtype=torch.float64)
    got = col.psum([a, b, c])
    want = (a + b) + c
    assert torch.equal(got[:2], want[:2]) and torch.isnan(got[2])
    assert got[0] == 0.0  # (1e16 + 1) - 1e16 in that order
    one = torch.arange(3.0)
    assert col.psum([one]) is one


def test_bf16_payload_sums_in_f32_and_rounds_once():
    down, up = col.payload_cast(True, torch.float32)
    xs = [torch.tensor([1.0 + 2 ** -7, 3.0]), torch.tensor([2 ** -8, 1.0])]
    got = up(col.psum([down(x) for x in xs]))
    want = (xs[0].to(torch.bfloat16).float() + xs[1].to(torch.bfloat16)
            .float()).to(torch.bfloat16).float()
    assert torch.equal(got, want) and got.dtype == torch.float32
    ident_down, ident_up = col.payload_cast(False)
    assert ident_down(xs[0]) is xs[0] and ident_up(xs[0]) is xs[0]


def test_scatter_gather_and_groups():
    parts = [torch.arange(8.0) * (k + 1) for k in range(3)]
    sc = col.psum_scatter(parts, 2, 0, ["cpu", "cpu"])
    full = parts[0] + parts[1] + parts[2]
    assert torch.equal(torch.cat(sc), full)
    assert torch.equal(col.all_gather(sc, 0, "cpu"), full)
    g = col.psum_groups(parts, [[0, 2], [1]], ["cpu", "cpu"])
    assert torch.equal(g[0], parts[0] + parts[2]) and torch.equal(
        g[1], parts[1])
    # A wrapper's launches, credited to the shard whose call made them;
    # those outside for_shards (replicated work) are shard 0's.
    def kernel():
        kernel.launches += 1

    kernel.launches = 0

    def launch(n):
        for _ in range(n):
            kernel()

    def work(n):
        launch(n - 1)
        col.for_shards(launch, [1])  # a nested call: the outer shard's

    with col.ShardLaunches([kernel]) as tally:
        assert col.for_shards(work, [1, 0, 2]) == [None] * 3
        kernel()
    assert tally.counts == {"kernel": {0: 2, 1: 1, 2: 2}}
    kernel()  # outside the context: counted by no tally
    assert tally.counts == {"kernel": {0: 2, 1: 1, 2: 2}}


# ---------------------------------------------------------------- the mesh


def test_make_mesh_raises_past_the_visible_devices():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices, 0 visible"):
        tmesh.make_mesh(2)
    with pytest.raises(ValueError, match="exceeds available devices 1"):
        tmesh.make_mesh(2, ["cpu"])
    with pytest.raises(ValueError, match="sequence of 2 devices"):
        tmesh.make_mesh(2, "cpu")
    mesh = tmesh.make_mesh(3, ["cpu"] * 4)
    assert mesh.size == 3 and not mesh.is_2d
    assert tmesh.mesh_axes(mesh) == tmesh.EDGE_AXIS
    m2 = tmesh.make_mesh_2d(2, 2, ["cpu"] * 4)
    assert m2.shape == (2, 2) and tmesh.mesh_axes(m2) == (
        tmesh.EDGE_AXIS, tmesh.CAM_AXIS)
    s = _scene()
    _, topt = _options(False)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        mt.flat_solve(*_args(s), dataclasses.replace(topt, world_size=2))


@pytest.mark.parametrize("ws,cb", [(1, 0), (4, 0), (6, 0), (8, 0), (9, 0),
                                   (7, 0), (8, 4), (8, 1)])
def test_factor_mesh_2d_matches_jax(ws, cb):
    assert tmesh.factor_mesh_2d(ws, cb) == jmesh.factor_mesh_2d(ws, cb)
    for req in range(1, 5):
        assert tmesh.nearest_cam_blocks(ws, req) == jmesh.nearest_cam_blocks(
            ws, req)


def test_shard_edge_arrays_matches_jax():
    s = _scene()
    for ws in (2, 3, 8):
        got = tmesh.shard_edge_arrays(s.obs, s.cam_idx, s.pt_idx, ws)
        want = jmesh.shard_edge_arrays(s.obs, s.cam_idx, s.pt_idx, ws)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


def _both_options(**kw):
    solver = kw.pop("solver", {})
    j = jc.ProblemOption(solver_option=jc.SolverOption(**solver), **kw)
    t = tc.ProblemOption(solver_option=tc.SolverOption(**solver), **kw)
    return j, t


@pytest.mark.parametrize("case", [
    dict(world_size=2),
    dict(world_size=4, solver=dict(mesh_2d=True, cam_blocks=2)),
    dict(world_size=4, solver=dict(mesh_2d=True)),
    dict(world_size=4, solver=dict(mesh_2d=True, cam_blocks=3)),
    dict(world_size=4, solver=dict(mesh_2d=True, cam_blocks=8)),
    dict(world_size=4, use_schur=False, solver=dict(mesh_2d=True)),
    dict(world_size=2, solver=dict(cam_blocks=-1)),
    dict(world_size=2, dtype=np.float32, solver=dict(bf16_collectives=True)),
    dict(world_size=2, dtype=np.float32,
         solver=dict(bf16=True, bf16_collectives=True)),
    dict(world_size=4, dtype=np.float32, solver=dict(
        bf16=True, bf16_collectives=True, mesh_2d=True, cam_blocks=2)),
])
def test_validate_options_matches_jax(case):
    j, t = _both_options(**case)
    try:
        jc.validate_options(j)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tc.validate_options(t)
        assert str(got.value) == str(e)
    else:
        tc.validate_options(t)


def test_still_refused_and_fused_1d_refused_as_jax():
    # Telemetry and (since the metrics plane is ported) metrics validate
    # at any world size, as in the JAX package.
    for kw in (dict(telemetry="/dev/null"), dict(metrics=True),
               dict(world_size=2, metrics=True)):
        tc.validate_options(tc.ProblemOption(**kw))
        jc.validate_options(jc.ProblemOption(**kw))
    s = _scene()
    jopt, topt = _options(False, fused=True)
    jopt = dataclasses.replace(
        jopt, world_size=2, solver_option=dataclasses.replace(
            jopt.solver_option, fused_kernels=True))
    with pytest.raises(ValueError) as want:
        j_flat_solve(j_engine(), *_args(s), jopt)
    with pytest.raises(ValueError) as got:
        mt.flat_solve(*_args(s), dataclasses.replace(topt, world_size=2),
                      device=["cpu"] * 2)
    assert str(got.value) == str(want.value)


def test_sharded_dual_plans_cut_the_camera_sorted_stream():
    s = _scene()
    nc, npt = s.cameras0.shape[0], s.points0.shape[0]
    n = s.obs.shape[0]
    plan_c, _ = tseg.make_dual_plans(s.cam_idx, s.pt_idx, nc, npt, "cpu")
    for ws in (2, 3, 4):
        perms, plans = tseg.make_sharded_dual_plans(
            s.cam_idx, s.pt_idx, nc, npt, ["cpu"] * ws)
        assert [p.shape[0] for p in perms] == [
            (k + 1) * n // ws - k * n // ws for k in range(ws)]
        np.testing.assert_array_equal(np.concatenate(perms), plan_c.perm)
        for p, dp in zip(perms, plans):
            assert dp.cam.num_segments == nc and dp.pt.num_segments == npt
            np.testing.assert_array_equal(dp.cam.seg.numpy(),
                                          s.cam_idx[p])


# ---------------------------------------------------------------- flat_solve


def _masked_extras(s):
    rng = np.random.default_rng(3)
    n = s.obs.shape[0]
    cam_fixed = np.zeros(8, bool)
    cam_fixed[[0, 1]] = True
    pt_fixed = np.zeros(120, bool)
    pt_fixed[5] = True
    L = np.tril(0.3 * rng.standard_normal((n, 2, 2))) + np.eye(2)
    return dict(sqrt_info=L, cam_fixed=cam_fixed, pt_fixed=pt_fixed,
                edge_mask=(rng.random(n) > 0.05).astype(np.float64))


@functools.lru_cache(maxsize=None)
def _jax_world(ws, kind, masked=False, guards=False, fault=False):
    s = _scene()
    jopt, _ = _options(guards, kind=kind)
    kw = _masked_extras(s) if masked else {}
    if fault:
        kw["fault_plan"] = _nan_plan(s.obs.shape[0])
    return _jax_solve(_args(s), dataclasses.replace(jopt, world_size=ws),
                      **kw)


def _port(ws, kind, masked=False, guards=False, fault=False, **solver):
    s = _scene()
    _, topt = _options(guards, kind=kind, **solver)
    kw = _masked_extras(s) if masked else {}
    if fault:
        kw["fault_plan"] = fault_plan_to_torch(_nan_plan(s.obs.shape[0]))
    return mt.flat_solve(*_args(s), dataclasses.replace(topt, world_size=ws),
                         device=["cpu"] * ws, **kw)


def _same_run(a, b, rtol=1e-9):
    assert (a.iterations, a.accepted, a.pcg_iterations, a.status) == (
        b.iterations, b.accepted, b.pcg_iterations, b.status)
    k = a.iterations
    assert torch.equal(a.trace.accept[:k], b.trace.accept[:k])
    np.testing.assert_allclose(a.trace.cost[:k].numpy(),
                               b.trace.cost[:k].numpy(), rtol=rtol)


@pytest.mark.parametrize("ws,kind,masked", [
    (2, "IMPLICIT", False), (2, "EXPLICIT", False), (4, "IMPLICIT", False),
    (4, "EXPLICIT", False), (2, "IMPLICIT", True)])
def test_flat_solve_world_n_matches_jax(ws, kind, masked):
    tres = _port(ws, kind, masked)
    compare_robust(_jax_world(ws, kind, masked), tres)
    _same_run(tres, _port(1, kind, masked))
    assert tres.cameras.shape == (8, 9) and tres.points.shape == (120, 3)


def test_guarded_nan_burst_world2_recovers_as_jax():
    tres = _port(2, "IMPLICIT", guards=True, fault=True)
    jres = _jax_world(2, "IMPLICIT", guards=True, fault=True)
    compare_robust(jres, tres)
    assert mt.SolveStatus(tres.status) == mt.SolveStatus.RECOVERED
    assert tres.recoveries == int(jres.recoveries) >= 1
    one = _port(1, "IMPLICIT", guards=True, fault=True)
    assert tres.recoveries == one.recoveries


@functools.lru_cache(maxsize=None)
def _jax_bf16_world2():
    s = _scene(np.float32)
    jopt, _ = _options(False, dtype=np.float32, rung="bf16",
                       bf16_collectives=True)
    return _jax_solve(_args(s), dataclasses.replace(jopt, world_size=2))


@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_bf16_collectives_world2_within_band(kind):
    s = _scene(np.float32)

    def port(ws, rung, **solver):
        _, topt = _options(False, kind=kind, dtype=np.float32, rung=rung,
                           **solver)
        return mt.flat_solve(*_args(s), dataclasses.replace(
            topt, world_size=ws), device=["cpu"] * ws)

    tres = port(2, "bf16", bf16_collectives=True)
    c, c32 = float(tres.cost), float(port(1, None).cost)
    assert np.isfinite(c) and c < float(tres.initial_cost)
    assert abs(c - c32) / c32 <= 2e-2, (c, c32)
    if kind == "IMPLICIT":
        cj = float(_jax_bf16_world2().cost)
        assert abs(c - cj) / cj <= 2e-2, (c, cj)
    assert not torch.equal(tres.trace.cost, port(2, "bf16").trace.cost)
    # One shard's sum moves nothing: at world 1 the option changes no bit.
    one = port(1, "bf16", bf16_collectives=True)
    assert torch.equal(one.trace.cost, port(1, "bf16").trace.cost)
    assert torch.equal(one.cameras, port(1, "bf16").cameras)


def test_one_device_is_the_mesh_of_one_shard(monkeypatch):
    """flat_solve at world 1 runs the same LM loop over a one-shard mesh
    (parallel.mesh.one_shard): the edge arrays are 1-tuples."""
    from megba_tpu_torch.algo import lm

    seen = []
    real = lm.lm_solve

    def spy(cameras, points, obs, cam_idx, pt_idx, mask, option, plans,
            **kw):
        seen.append((plans, obs))
        return real(cameras, points, obs, cam_idx, pt_idx, mask, option,
                    plans, **kw)

    monkeypatch.setattr(lm, "lm_solve", spy)
    s = _scene()
    _, topt = _options(False)
    mt.flat_solve(*_args(s), topt, device="cpu")
    (plans, obs), = seen
    assert isinstance(plans, tmesh.ShardedPlans) and plans.mesh.size == 1
    assert plans.devices == (torch.device("cpu"),) and len(obs) == 1
    one = tmesh.one_shard(plans.shards[0])
    assert one.shards == plans.shards and one.mesh == plans.mesh


@pytest.mark.parametrize("case", ["plain", "forcing_warm", "neumann"])
def test_other_paths_world2_match_world1(case):
    kw = {"plain": dict(use_schur=False),
          "forcing_warm": dict(tol=1e-1, forcing=True, warm_start=True),
          "neumann": dict(precond=mt.PrecondKind.NEUMANN)}[case]
    s = _scene()
    use_schur = kw.pop("use_schur", True)
    _, topt = _options(False, use_schur=use_schur, **kw)
    one = mt.flat_solve(*_args(s), topt, device="cpu")
    two = mt.flat_solve(*_args(s), dataclasses.replace(topt, world_size=2),
                        device=["cpu"] * 2)
    _same_run(two, one)

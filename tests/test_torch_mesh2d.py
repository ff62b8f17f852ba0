"""The port's 2-D camera x edge mesh vs the JAX package, on the CPU.

- `build_camera_tile_plan`: every array and count `array_equal` to JAX's
  on the same edges, at several meshes and quanta; the port's device
  half (`device_camera_tile_plan`): each ring bucket's cameras
  non-decreasing, the buckets covering each device's edges once;
- the ring step: `ops.fused.fused_single_block_apply` (its plain
  version on the CPU) against JAX `fused_single_block_apply` in
  interpret mode, W and implicit forms, float64 and float32;
- the 2-D S.p product: the port's `solver.pcg.make_matvec_2d` against
  JAX's `make_matvec_2d` run once in a `shard_map` over a 2 x 2 mesh of
  virtual CPU devices, on IMPLICIT and EXPLICIT, unfused and fused, at
  float64 (1e-12 of the largest magnitude), and with bf16 rows and bf16
  collective payloads at float32 (within bf16 rounding);
- `flat_solve` on the 2 x 2 mesh, IMPLICIT and EXPLICIT, unfused and
  fused, at float64: trial costs at rtol 1e-9 with equal accept pattern,
  LM / PCG counts and status against the JAX package's 1-D world-4
  solve, and against the port's world-1 solve.  The reference is the
  1-D solve because the JAX package's 2-D solve does not run on this
  JAX (0.9.0): shard_map's varying-axes check refuses its PCG loop carry,
  as in JAX's own `test_mesh2d.py::test_2d_parity_world4_matches_single_
  device`; the 2-D product itself is held to JAX's above, outside the
  loop.  The fused runs are held to the same unfused JAX solve;
- the mixed rung on the 2-D mesh at float32 against JAX's 1-D world-4
  mixed solve at the JAX package's 2-D band, 1e-2 (pcg.py:481-487); the
  bf16 rung with bf16 collectives within 2e-2 of JAX's 1-D world-4 bf16
  solve with bf16 collectives and of the port's float32 solve.

CPU only; the `cuda` tests hold the kernels to these plain versions.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import megba_tpu.common as jc
from megba_tpu.core import fm as jfm
from megba_tpu.linear_system import builder as jb
from megba_tpu.ops import fused as jfused
from megba_tpu.ops import segtiles as jseg
from megba_tpu.ops.residuals import bal_residual_jacobian_analytical_fm as jeng
from megba_tpu.parallel import mesh as jmesh
from megba_tpu.solver import pcg as jpcg

import megba_tpu_torch as mt
from megba_tpu_torch.ops import fused as tfused
from megba_tpu_torch.ops import segtiles as tseg
from megba_tpu_torch.parallel.mesh import ShardedPlans, make_mesh_2d
from megba_tpu_torch.solver import pcg as tpcg

from test_torch_guards import _args, _jax_solve, _options, compare_robust

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

TILE_FIELDS = ("perm", "mask", "cam_idx", "pt_idx", "cam_local",
               "bucket_slot", "bucket_ptl", "bucket_mask")
TILE_SCALARS = ("num_cameras", "num_points", "edge_shards", "cam_blocks",
                "tile_cams", "shard_points", "n_edges_real",
                "n_edges_padded", "bucket_width")


def _scene(dtype=np.float64):
    return mt.make_synthetic_bal(num_cameras=8, num_points=120,
                                 obs_per_point=3.5, seed=3, dtype=dtype)


# ---------------------------------------------------------------- the plan


@pytest.mark.parametrize("E,C,quantum", [(2, 2, 0), (1, 2, 0), (2, 1, 0),
                                         (2, 2, 1), (3, 2, 1), (2, 3, 4)])
def test_camera_tile_plan_arrays_equal_jax(E, C, quantum):
    s = mt.make_synthetic_bal(num_cameras=11, num_points=150,
                              obs_per_point=4, seed=5)
    nc, npt = s.cameras0.shape[0], s.points0.shape[0]
    j = jseg.build_camera_tile_plan(s.cam_idx, s.pt_idx, nc, npt, E, C,
                                    quantum=quantum)
    t = tseg.build_camera_tile_plan(s.cam_idx, s.pt_idx, nc, npt, E, C,
                                    quantum=quantum)
    for f in TILE_SCALARS:
        assert getattr(t, f) == getattr(j, f), f
    for f in TILE_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)
        assert getattr(t, f).dtype == getattr(j, f).dtype, f
    assert t.reuse == j.reuse


def test_device_tile_plan_buckets_cover_each_device_once():
    s = _scene()
    nc, npt = s.cameras0.shape[0], s.points0.shape[0]
    plan = tseg.build_camera_tile_plan(s.cam_idx, s.pt_idx, nc, npt, 2, 2,
                                       quantum=1)
    shards = tseg.tile_plan_shards(plan)
    np.testing.assert_array_equal(np.sort(np.concatenate(shards)),
                                  np.arange(s.obs.shape[0]))
    dev = tseg.device_camera_tile_plan(plan, ["cpu"] * 4)
    for d, edges in enumerate(shards):
        slots = torch.cat([r.out.inv for r in dev.rings[d]]).numpy()
        np.testing.assert_array_equal(np.sort(slots),
                                      np.arange(edges.shape[0]))
        for s_, ring in enumerate(dev.rings[d]):
            cams = ring.out.seg.numpy()
            assert (np.diff(cams) >= 0).all()
            # The entry's camera and point are its edge's.
            e = edges[ring.out.inv.numpy()]
            c = d % 2
            np.testing.assert_array_equal(
                cams, s.cam_idx[e] - c * plan.tile_cams)
            np.testing.assert_array_equal(
                ring.in_idx.numpy(), s.pt_idx[e] - s_ * plan.shard_points)


def test_bucket_input_plans_gather_only():
    """A bucket's input side lists its points in entry order, unsorted:
    a `GatherPlan` with no offsets, which the expands take and every
    segment sum (kernel or plain) refuses."""
    s = _scene()
    nc, npt = s.cameras0.shape[0], s.points0.shape[0]
    plan = tseg.build_camera_tile_plan(s.cam_idx, s.pt_idx, nc, npt, 2, 2,
                                       quantum=1)
    dev = tseg.device_camera_tile_plan(plan, ["cpu"] * 4)
    gp = dev.in_plans[0][1]
    assert isinstance(gp, tseg.GatherPlan) and not hasattr(gp, "seg_ptr")
    assert (np.diff(gp.seg.numpy()) < 0).any()  # not sorted
    table = torch.arange(3.0 * gp.num_segments,
                         dtype=torch.float64).reshape(3, -1)
    got = tseg.seg_expand(table, gp)
    assert torch.equal(got, table[:, gp.seg.long()])
    J = torch.ones(6, gp.n_slots, dtype=torch.float64)
    assert torch.equal(tseg.coupling_expand(table, J, gp, 3),
                       torch.stack([got.sum(0)] * 2))
    with pytest.raises(TypeError, match="needs a SegPlan"):
        tseg.seg_reduce(got, gp)
    with pytest.raises(TypeError, match="needs a SegPlan"):
        tseg.coupling_reduce(J, torch.ones(2, gp.n_slots,
                                           dtype=torch.float64), gp, 3)


# ---------------------------------------------------------------- ring step


def _ring_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    n, Sp, Tc = 700, 90, 13
    in_local = rng.integers(0, Sp, n)
    out_local = np.sort(rng.integers(0, Tc, n))
    out_local[out_local == 4] = 5  # an empty camera
    W = rng.standard_normal((27, n)).astype(dtype)
    Jin = rng.standard_normal((6, n)).astype(dtype)
    Jout = rng.standard_normal((18, n)).astype(dtype)
    table = rng.standard_normal((3, Sp)).astype(dtype)
    return in_local, out_local, W, Jin, Jout, table, Sp, Tc


@pytest.mark.parametrize("form", ["w", "implicit"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ring_step_matches_jax_single_block_apply(form, dtype):
    in_local, out_local, W, Jin, Jout, table, Sp, Tc = _ring_inputs(dtype)
    n = in_local.shape[0]
    plan = tfused.ring_step_plan(in_local, out_local, np.arange(n), Sp, Tc,
                                 "cpu")
    T = torch.from_numpy
    if form == "w":
        want = jfused.fused_single_block_apply(
            jnp.asarray(W), jnp.asarray(table), jnp.asarray(in_local),
            jnp.asarray(out_local), Tc, w_in_major=False, interpret=True)
        got = tfused.fused_single_block_apply(T(W), T(table), plan,
                                              w_in_major=False)
        scale = tfused.fused_single_block_apply(
            T(np.abs(W)), T(np.abs(table)), plan, w_in_major=False)
    else:
        want = jfused.fused_single_block_apply(
            jnp.asarray(Jin), jnp.asarray(table), jnp.asarray(in_local),
            jnp.asarray(out_local), Tc, rows_out=jnp.asarray(Jout),
            interpret=True)
        got = tfused.fused_single_block_apply(T(Jin), T(table), plan,
                                              rows_out=T(Jout))
        scale = tfused.fused_single_block_apply(
            T(np.abs(Jin)), T(np.abs(table)), plan, rows_out=T(np.abs(Jout)))
    want = np.asarray(want)
    assert got.shape == want.shape == (9, Tc) and got.dtype == T(W).dtype
    rel = 1e-12 if dtype == np.float64 else 1e-5
    assert (np.abs(got.numpy() - want) <= rel * scale.numpy() + 1e-30).all()
    assert not got[:, 4].any()  # the empty camera


# ---------------------------------------------------------------- S.p


def _matvec_case(kind, dtype, E=2, C=2):
    """Both packages' E x C inputs of one product: JAX's rows over the
    padded 2-D stream, the port's over each device's real edges (the
    first slots of its chunk, in chunk order)."""
    s = _scene(dtype)
    nc, npt = s.cameras0.shape[0], s.points0.shape[0]
    jplan = jseg.build_camera_tile_plan(s.cam_idx, s.pt_idx, nc, npt, E, C,
                                        quantum=1)
    m = jnp.asarray(jplan.mask.astype(dtype))
    ci, pi = jnp.asarray(jplan.cam_idx), jnp.asarray(jplan.pt_idx)
    r, Jc, Jp = jeng(jnp.take(jnp.asarray(s.cameras0.T), ci, axis=1),
                     jnp.take(jnp.asarray(s.points0.T), pi, axis=1),
                     jnp.asarray(s.obs[jplan.perm].T))
    r, Jc, Jp = jb.weight_system_inputs(r, Jc, Jp, ci, pi, m)
    sysj = jb.build_schur_system(r, Jc, Jp, ci, pi, nc, npt,
                                 compute_kind=jc.ComputeKind[kind])
    region = jnp.asarray(10.0, dtype)
    Hpp_d = jb.damp_blocks(sysj.Hpp, region)
    Hll_inv = jfm.block_inv_fm(jfm.damp_rows_fm(sysj.Hll, region))
    p = np.random.default_rng(1).standard_normal((9, nc)).astype(dtype)

    tplan = tseg.build_camera_tile_plan(s.cam_idx, s.pt_idx, nc, npt, E, C,
                                        quantum=1)
    mesh = make_mesh_2d(E, C, ["cpu"] * (E * C))
    chunk = jplan.n_edges_padded // (E * C)
    shards, Jcs, Jps, Ws = [], [], [], []
    for d, edges in enumerate(tseg.tile_plan_shards(tplan)):
        _, dp = tseg.make_dual_plans(s.cam_idx[edges], s.pt_idx[edges], nc,
                                     npt, "cpu")
        dp = tfused.with_fused_plans(dp)
        sl = slice(d * chunk, d * chunk + edges.shape[0])
        shards.append(dp)
        Jcs.append(torch.from_numpy(np.array(Jc[:, sl])))
        Jps.append(dp.to_pt(torch.from_numpy(np.array(Jp[:, sl]))))
        if sysj.W is not None:
            Ws.append(torch.from_numpy(np.array(sysj.W[:, sl])))
    tplans = ShardedPlans(
        mesh=mesh, shards=tuple(shards),
        tile_plan=tseg.device_camera_tile_plan(tplan, mesh.devices))
    jin = dict(W=sysj.W, Jc=Jc, Jp=Jp, pt_idx=pi, Hpp_d=Hpp_d,
               Hll_inv=Hll_inv, plan=jseg.device_camera_tile_plan(jplan),
               nc=nc, npt=npt, p=p, shape=(E, C))
    tin = dict(W=tuple(Ws) if Ws else None, Jc=tuple(Jcs), Jp=tuple(Jps),
               plans=tplans, Hpp_d=torch.from_numpy(np.array(Hpp_d)),
               Hll_inv=torch.from_numpy(np.array(Hll_inv)),
               p=torch.from_numpy(p))
    return jin, tin


def _jax_matvec(jin, kind, bf16=False, wire=False, fused=False):
    E, C = jin["shape"]
    mesh = jmesh.make_mesh_2d(E, C, jax.devices("cpu")[:E * C])
    edge = P(None, (jmesh.EDGE_AXIS, jmesh.CAM_AXIS))
    e1 = P((jmesh.EDGE_AXIS, jmesh.CAM_AXIS))
    W = jin["W"]
    Jc, Jp = jin["Jc"], jin["Jp"]
    if bf16:
        W = None if W is None else W.astype(jnp.bfloat16)
        Jc, Jp = Jc.astype(jnp.bfloat16), Jp.astype(jnp.bfloat16)
    args = [Jc, Jp, jin["pt_idx"], jin["Hpp_d"], jin["Hll_inv"], jin["plan"],
            jin["p"]]
    specs = [edge, edge, e1, P(), P(), jseg.tile_plan_partition_specs(
        jin["plan"], e1), P()]
    if W is not None:
        args.append(W)
        specs.append(edge)

    def body(Jc, Jp, pi, Hpp_d, Hll_inv, plan, p, W=None):
        mv = jpcg.make_matvec_2d(
            W, Jc, Jp, plan, pi, Hpp_d, Hll_inv, jin["nc"], jin["npt"],
            jc.ComputeKind[kind], (jmesh.EDGE_AXIS, jmesh.CAM_AXIS),
            bf16_ops=bf16, bf16_collectives=wire, fused_kernels=fused)
        return mv(p)

    fn = jax.shard_map(body, mesh=mesh, in_specs=tuple(specs),
                       out_specs=P(), check_vma=False)
    lowered = jax.jit(fn).lower(*args)
    return np.asarray(lowered.compile(
        compiler_options={"xla_allow_excess_precision": False})(*args))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_matvec_2d_matches_jax_f64(kind, fused):
    jin, tin = _matvec_case(kind, np.float64)
    want = _jax_matvec(jin, kind, fused=fused)
    mv = tpcg.make_matvec_2d(
        tin["Jc"], tin["Jp"], tin["W"], tin["plans"], tin["Hpp_d"],
        tin["Hll_inv"], mt.ComputeKind[kind], fused_kernels=fused)
    got = mv(tin["p"]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("E", [1, 2])
def test_matvec_2d_ring_of_three_columns_matches_jax(E, fused, monkeypatch):
    """Three camera columns, where a ring differs from fetching each
    shard from its owner: device (e, c) takes point shard c from device
    (0, c) and then passes what it holds one hop, from (e, c + 1) to
    (e, c), C - 1 times a product; the sum is JAX's."""
    jin, tin = _matvec_case("IMPLICIT", np.float64, E=E, C=3)
    want = _jax_matvec(jin, "IMPLICIT", fused=fused)
    hops = []  # (sent, received): a copy, as a transfer makes one
    real = tpcg.ppermute

    def spy(x, device):
        got = real(x, device).clone()
        hops.append((x, got))
        return got

    monkeypatch.setattr(tpcg, "ppermute", spy)
    mv = tpcg.make_matvec_2d(
        tin["Jc"], tin["Jp"], tin["W"], tin["plans"], tin["Hpp_d"],
        tin["Hll_inv"], mt.ComputeKind.IMPLICIT, fused_kernels=fused)
    got = mv(tin["p"]).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    n = 3 * E
    assert len(hops) == n * 3  # n fetches, then (C - 1) n hops
    first, hop1, hop2 = hops[:n], hops[n:2 * n], hops[2 * n:]
    for d in range(n):
        right = d - d % 3 + (d + 1) % 3
        assert hop1[d][0] is first[right][1]
        assert hop2[d][0] is hop1[right][1]


@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_matvec_2d_bf16_collectives_matches_jax(kind):
    """bf16 rows, bf16 products with f32 sums and bf16 payloads on every
    collective of the product: within bf16 rounding of JAX's, and not
    the f32 product (the payloads were narrowed)."""
    jin, tin = _matvec_case(kind, np.float32)
    want = _jax_matvec(jin, kind, bf16=True, wire=True, fused=True)
    bf = torch.bfloat16
    rows = {k: None if tin[k] is None else tuple(x.to(bf) for x in tin[k])
            for k in ("Jc", "Jp", "W")}
    mv = tpcg.make_matvec_2d(
        rows["Jc"], rows["Jp"], rows["W"], tin["plans"], tin["Hpp_d"],
        tin["Hll_inv"], mt.ComputeKind[kind], bf16_ops=True,
        bf16_collectives=True, fused_kernels=True)
    got = mv(tin["p"]).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale)
    full = tpcg.make_matvec_2d(
        tin["Jc"], tin["Jp"], tin["W"], tin["plans"], tin["Hpp_d"],
        tin["Hll_inv"], mt.ComputeKind[kind])(tin["p"]).numpy()
    assert not np.array_equal(got, full)
    # Every value crossed the wire as bfloat16.
    np.testing.assert_array_equal(
        got, torch.from_numpy(got).to(bf).to(torch.float32).numpy())


# ---------------------------------------------------------------- flat_solve


@functools.lru_cache(maxsize=None)
def _jax_world4(kind, rung=None):
    dtype = np.float64 if rung is None else np.float32
    extra = dict(bf16_collectives=True) if rung == "bf16" else {}
    jopt, _ = _options(False, kind=kind, dtype=dtype, rung=rung, **extra)
    return _jax_solve(_args(_scene(dtype)), dataclasses.replace(
        jopt, world_size=4))


def _port(kind, world, fused=False, dtype=np.float64, rung=None, **solver):
    _, topt = _options(False, kind=kind, fused=fused, dtype=dtype,
                       rung=rung, **solver)
    topt = dataclasses.replace(topt, world_size=world)
    return mt.flat_solve(None, *_args(_scene(dtype)), topt,
                         device=["cpu"] * world)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_flat_solve_2x2_matches_jax_world4(kind, fused):
    tres = _port(kind, 4, fused, mesh_2d=True, cam_blocks=2)
    compare_robust(_jax_world4(kind), tres)
    one = _port(kind, 1, fused)
    assert (tres.iterations, tres.accepted, tres.pcg_iterations) == (
        one.iterations, one.accepted, one.pcg_iterations)
    np.testing.assert_allclose(tres.trace.cost[:tres.iterations].numpy(),
                               one.trace.cost[:one.iterations].numpy(),
                               rtol=1e-9)


def test_flat_solve_2x2_mixed_within_jax_band():
    tres = _port("IMPLICIT", 4, True, np.float32, "mixed", mesh_2d=True,
                 cam_blocks=2)
    jres = _jax_world4("IMPLICIT", "mixed")
    c, cj = float(tres.cost), float(jres.cost)
    assert np.isfinite(c) and c < float(tres.initial_cost)
    assert abs(c - cj) / cj <= 1e-2, (c, cj)


def test_flat_solve_2x2_bf16_collectives_within_band():
    tres = _port("IMPLICIT", 4, True, np.float32, "bf16", mesh_2d=True,
                 cam_blocks=2, bf16_collectives=True)
    jres = _jax_world4("IMPLICIT", "bf16")
    f32 = _port("IMPLICIT", 1, False, np.float32)
    c, cj, c32 = float(tres.cost), float(jres.cost), float(f32.cost)
    assert np.isfinite(c) and c < float(tres.initial_cost)
    assert abs(c - cj) / cj <= 2e-2, (c, cj)
    assert abs(c - c32) / c32 <= 2e-2, (c, c32)
    plain_wire = _port("IMPLICIT", 4, True, np.float32, "bf16", mesh_2d=True,
                       cam_blocks=2)
    assert not torch.equal(tres.trace.cost, plain_wire.trace.cost)

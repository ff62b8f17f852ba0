"""The port's multi-process runtime, argument order and public names.

- A two-process world on the CPU (this file run as a script is one rank:
  `python tests/test_torch_multihost.py <rank> <port> <outdir>`), over a
  gloo process group joined by `parallel.multihost.initialize_multihost`
  (rank 0 hosts the rendezvous on port 0 and prints the port it bound):
  the init contract (an exact repeat is idempotent, other parameters
  raise); `psum` (float64 and bf16), `all_gather` and `psum_scatter`
  across the two processes bitwise the one-process collectives; a
  world-2 `flat_solve` and `solve_pgo` at float64 bitwise the port's
  one-process world-2 solves (trace, parameters, status), the former
  held to JAX's single-process world 2 at rtol 1e-9 with equal counts
  (JAX's own two-process lane needs gloo in jaxlib, which this one
  lacks); a world-2 `solve_checkpointed` whose snapshots load in JAX's
  `load_state` with their world header.  One pair of rank processes
  serves every case (a module fixture); each runs on one intra-op
  thread, and is killed if it outlives its time limit.
- A 2-D mesh across processes raises NotImplementedError.
- JAX's argument order: `flat_solve(None, cameras, ...)` and
  `solve_checkpointed(None, cameras, ...)` run, bitwise the all-keyword
  spelling, and match JAX's results at float64.
- The public names the port gained: `ops.geo.quaternion_to_rotation_matrix`
  / `drotated_dangle_axis`, `ops.residuals.bal_residual_jacobian_analytical`,
  `core.types.BALData` / `BAState`, `BaseVertex` at the top level, the
  subpackages' re-exports, and `SolveReport.tiles` against JAX's twins at
  float64.

CPU only.
"""

import os
import subprocess
import sys

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
if __name__ == "__main__":
    sys.path.insert(0, _REPO)

import megba_tpu_torch as mt  # noqa: E402

# One intra-op thread (tests and rank processes alike): the suite runs
# several test processes a core.
torch.set_num_threads(1)

WORLD = 2


def scene():
    """tests/test_torch_sharding.py's scene (its world-2 parity holds at
    rtol 1e-9 against JAX's world 2)."""
    return mt.make_synthetic_bal(num_cameras=8, num_points=120,
                                 obs_per_point=3.5, seed=3)


def arrays(s):
    return (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)


def option(world=WORLD, max_iter=8):
    return mt.ProblemOption(
        world_size=world, jacobian_mode=mt.JacobianMode.ANALYTICAL,
        compute_kind=mt.ComputeKind.IMPLICIT,
        algo_option=mt.AlgoOption(max_iter=max_iter, epsilon1=1e-12,
                                  epsilon2=1e-15),
        solver_option=mt.SolverOption(max_iter=30, tol=1e-10,
                                      refuse_ratio=1e30))


def pose_graph():
    from megba_tpu_torch.models.pgo import make_synthetic_pose_graph

    return make_synthetic_pose_graph(num_poses=24, loop_closures=6, seed=3,
                                     meas_noise=0.01, drift_noise=0.1)


def pgo_option(world=WORLD):
    return mt.ProblemOption(
        world_size=world, algo_option=mt.AlgoOption(
            max_iter=5, epsilon1=1e-12, epsilon2=1e-15),
        solver_option=mt.SolverOption(max_iter=15, tol=1e-12))


def psum_parts():
    rng = np.random.default_rng(11)
    return [torch.from_numpy(rng.standard_normal((3, 40))) for _ in
            range(WORLD)]


def solve_record(res, prefix):
    """A result's bits, as host arrays under `prefix`."""
    out = {f"{prefix}_cost": res.cost.cpu().numpy(),
           f"{prefix}_initial_cost": res.initial_cost.cpu().numpy(),
           f"{prefix}_iterations": np.asarray(int(res.iterations)),
           f"{prefix}_status": np.asarray(int(res.status))}
    if hasattr(res, "poses"):
        out[f"{prefix}_poses"] = res.poses.cpu().numpy()
    else:
        out[f"{prefix}_cameras"] = res.cameras.cpu().numpy()
        out[f"{prefix}_points"] = res.points.cpu().numpy()
        k = int(res.iterations)
        for f in ("cost", "accept", "pcg_iters", "rho", "trust_region"):
            out[f"{prefix}_trace_{f}"] = np.asarray(
                getattr(res.trace, f))[:k]
    return out


def _rank(rank: int, port: str, outdir: str) -> None:
    """One rank of the two-process world (this file run as a script)."""
    from megba_tpu_torch.parallel import collectives as col
    from megba_tpu_torch.parallel import mesh as tmesh
    from megba_tpu_torch.parallel import multihost as mh

    addr = f"localhost:{port}"
    info = mh.initialize_multihost(addr, WORLD, rank)
    rec = {"info_rank": np.asarray(info["process_index"]),
           "info_count": np.asarray(info["process_count"]),
           "info_global": np.asarray(info["global_devices"]),
           "idempotent": np.asarray(
               mh.initialize_multihost(addr, WORLD, rank) == info)}
    try:
        mh.initialize_multihost(addr, WORLD + 1, rank)
        rec["mismatch_raises"] = np.asarray(False)
    except RuntimeError:
        rec["mismatch_raises"] = np.asarray(True)

    # The collectives across the two processes.
    mesh = tmesh.make_process_mesh(WORLD, "cpu")
    parts = psum_parts()
    cpu = torch.device("cpu")
    col.reset_gather_stats()
    with col.mesh_scope(mesh):
        local = col.for_shards(lambda k: parts[k], range(WORLD))
        rec["psum"] = col.psum(local).numpy()
        rec["psum_bf16"] = col.psum(col.for_shards(
            lambda k: parts[k].to(torch.bfloat16), range(WORLD))).float(
            ).numpy()
        rec["all_gather"] = col.all_gather(local, 1, cpu).numpy()
        rec["psum_scatter"] = torch.cat(
            col.psum_scatter(local, 2, 1, [cpu, cpu]), 1).numpy()
    rec["gathers"] = np.asarray(col.gather_stats()["gathers"])

    s = scene()
    rec.update(solve_record(mt.flat_solve(None, *arrays(s), option(),
                                          device="cpu"), "ba"))
    g = pose_graph()
    rec.update(solve_record(mt.solve_pgo(g.poses0, g.edge_i, g.edge_j,
                                         g.meas, pgo_option(),
                                         device="cpu"), "pgo"))
    mt.solve_checkpointed(None, *arrays(s), option(max_iter=4),
                          checkpoint_path=os.path.join(outdir,
                                                       f"ck{rank}.npz"),
                          checkpoint_every=2, device="cpu")
    mh.shutdown_multihost()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **rec)
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), sys.argv[2], sys.argv[3])
    raise SystemExit(0)


import dataclasses  # noqa: E402
import functools  # noqa: E402

import pytest  # noqa: E402

from megba_tpu_torch.parallel import collectives as col  # noqa: E402
from megba_tpu_torch.parallel import mesh as tmesh  # noqa: E402

RANK_TIMEOUT_S = 120


def rank_env() -> dict:
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def read_port(proc, timeout: float) -> str:
    """The port rank 0's rendezvous bound, from its first output line."""
    import selectors
    import time

    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    deadline = time.monotonic() + timeout
    seen = ""
    while time.monotonic() < deadline:
        if sel.select(timeout=0.5):
            line = proc.stdout.readline()
            seen += line
            if "rendezvous serving" in line:
                return line.split()[-1]
            if not line:
                break
    raise AssertionError(f"rank 0 printed no rendezvous port:\n{seen}")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the two ranks once; {rank: record}."""
    outdir = str(tmp_path_factory.mktemp("multihost"))
    me = os.path.abspath(__file__)
    procs = [subprocess.Popen(
        [sys.executable, me, "0", "0", outdir], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=rank_env())]
    outs = {}
    try:
        port = read_port(procs[0], RANK_TIMEOUT_S)
        procs.append(subprocess.Popen(
            [sys.executable, me, "1", port, outdir], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=rank_env()))
        for r, p in enumerate(procs):
            outs[r], _ = p.communicate(timeout=RANK_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{outs.get(r)}"
        assert f"rank {r} OK" in outs[r], outs[r]
    return {r: dict(np.load(os.path.join(outdir, f"rank{r}.npz")))
            for r in range(WORLD)}, outdir


def test_two_process_init_contract(world):
    rec, _ = world
    for r in range(WORLD):
        assert int(rec[r]["info_rank"]) == r
        assert int(rec[r]["info_count"]) == WORLD
        assert int(rec[r]["info_global"]) == WORLD
        assert bool(rec[r]["idempotent"])
        assert bool(rec[r]["mismatch_raises"])


def test_two_process_psum_bitwise_one_process(world):
    rec, _ = world
    parts = psum_parts()
    cpu = torch.device("cpu")
    want = {
        "psum": col.psum(parts).numpy(),
        "psum_bf16": col.psum([p.to(torch.bfloat16) for p in parts]).float(
        ).numpy(),
        "all_gather": col.all_gather(parts, 1, cpu).numpy(),
        "psum_scatter": torch.cat(col.psum_scatter(parts, 2, 1, [cpu, cpu]),
                                  1).numpy()}
    for r in range(WORLD):
        for k, v in want.items():
            np.testing.assert_array_equal(rec[r][k], v, err_msg=k)
        # One gather per collective.
        assert int(rec[r]["gathers"]) == 4


def _bitwise(rec, prefix, ref):
    for k, v in ref.items():
        np.testing.assert_array_equal(rec[k], v, err_msg=k)
    assert any(k.startswith(prefix) for k in ref)


@functools.lru_cache(maxsize=None)
def _jax_world2():
    import megba_tpu.common as jc
    from megba_tpu.ops.residuals import make_residual_jacobian_fn
    from megba_tpu.solve import flat_solve as j_flat_solve

    jopt = jc.ProblemOption(
        world_size=WORLD, jacobian_mode=jc.JacobianMode.ANALYTICAL,
        compute_kind=jc.ComputeKind.IMPLICIT,
        algo_option=jc.AlgoOption(max_iter=8, epsilon1=1e-12,
                                  epsilon2=1e-15),
        solver_option=jc.SolverOption(max_iter=30, tol=1e-10,
                                      refuse_ratio=1e30))
    return j_flat_solve(make_residual_jacobian_fn(
        mode=jc.JacobianMode.ANALYTICAL), *arrays(scene()), jopt)


def test_two_process_flat_solve_bitwise_one_process(world):
    from test_torch_solve import _compare

    rec, _ = world
    one = mt.flat_solve(None, *arrays(scene()), option(),
                        device=["cpu"] * WORLD)
    ref = solve_record(one, "ba")
    for r in range(WORLD):
        _bitwise(rec[r], "ba", ref)
    # The one-process world-2 solve against JAX's world 2.
    _compare(_jax_world2(), one, cost_rtol=1e-9)


def test_two_process_pgo_bitwise_one_process(world):
    rec, _ = world
    g = pose_graph()
    one = mt.solve_pgo(g.poses0, g.edge_i, g.edge_j, g.meas, pgo_option(),
                       device=["cpu"] * WORLD)
    ref = solve_record(one, "pgo")
    for r in range(WORLD):
        _bitwise(rec[r], "pgo", ref)
    assert int(one.iterations) == 5


def test_world2_snapshots_load_in_jax(world):
    from megba_tpu.utils.checkpoint import load_state as j_load_state

    _, outdir = world
    for r in range(WORLD):
        st = j_load_state(os.path.join(outdir, f"ck{r}.npz"),
                          expect_world_size=WORLD)
        assert int(st["world_size"]) == WORLD
        assert int(st["process_index"]) == r
        assert int(st["iteration"]) == 4
    a, b = (j_load_state(os.path.join(outdir, f"ck{r}.npz"))
            for r in range(WORLD))
    np.testing.assert_array_equal(a["cameras"], b["cameras"])


def test_2d_mesh_across_processes_raises(monkeypatch):
    monkeypatch.setattr(tmesh, "multiprocess_active", lambda: True)
    import megba_tpu_torch.solve as tsolve

    monkeypatch.setattr(tsolve, "multiprocess_active", lambda: True)
    opt = dataclasses.replace(option(), solver_option=dataclasses.replace(
        option().solver_option, mesh_2d=True))
    with pytest.raises(NotImplementedError, match="2-D mesh"):
        mt.flat_solve(None, *arrays(scene()), opt, device="cpu")
    layout = col.ProcessLayout([0, 1], 0)
    with pytest.raises(NotImplementedError, match="between processes"):
        with col.mesh_scope(tmesh.Mesh(
                devices=(torch.device("cpu"), None), shape=(2,),
                axis_names=(tmesh.EDGE_AXIS,), processes=(0, 1))):
            col.ppermute(torch.zeros(2), torch.device("cpu"))
    assert layout.home == 0 and layout.counts == [1, 1]


# ------------------------------------------------ JAX's argument order


def _jax_option(max_iter=8):
    import megba_tpu.common as jc

    return jc.ProblemOption(
        jacobian_mode=jc.JacobianMode.ANALYTICAL,
        compute_kind=jc.ComputeKind.IMPLICIT,
        algo_option=jc.AlgoOption(max_iter=max_iter, epsilon1=1e-12,
                                  epsilon2=1e-15),
        solver_option=jc.SolverOption(max_iter=30, tol=1e-10,
                                      refuse_ratio=1e30))


def _j_engine():
    import megba_tpu.common as jc
    from megba_tpu.ops.residuals import make_residual_jacobian_fn

    return make_residual_jacobian_fn(mode=jc.JacobianMode.ANALYTICAL)


def test_flat_solve_takes_jax_argument_order():
    from megba_tpu.solve import flat_solve as j_flat_solve
    from test_torch_solve import _compare

    s = scene()
    opt = option(world=1)
    engine = mt.make_residual_jacobian_fn(mode=mt.JacobianMode.ANALYTICAL)
    # JAX's spelling, the engine first (None: the option's engine).
    pos = mt.flat_solve(None, *arrays(s), opt, device="cpu")
    pos_f = mt.flat_solve(engine, *arrays(s), opt, device="cpu")
    kw = mt.flat_solve(residual_jac_fn=None, cameras=s.cameras0,
                       points=s.points0, obs=s.obs, cam_idx=s.cam_idx,
                       pt_idx=s.pt_idx, option=opt, device="cpu")
    ref = solve_record(kw, "k")
    for res in (pos, pos_f):
        for k, v in solve_record(res, "k").items():
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
    jres = j_flat_solve(_j_engine(), *arrays(s), _jax_option())
    _compare(jres, pos, cost_rtol=1e-9)
    # The engine is not a keyword after the arrays any more.
    with pytest.raises(TypeError):
        mt.flat_solve(*arrays(s), opt, residual_jac_fn=engine,
                      device="cpu")


def test_solve_checkpointed_takes_jax_argument_order(tmp_path):
    from megba_tpu.algo.checkpointed import (
        solve_checkpointed as j_solve_checkpointed,
    )
    from test_torch_solve import _compare

    s = scene()
    opt = option(world=1, max_iter=4)
    pos = mt.solve_checkpointed(None, *arrays(s), opt,
                                str(tmp_path / "a.npz"), 2, device="cpu")
    kw = mt.solve_checkpointed(
        residual_jac_fn=None, cameras=s.cameras0, points=s.points0,
        obs=s.obs, cam_idx=s.cam_idx, pt_idx=s.pt_idx, option=opt,
        checkpoint_path=str(tmp_path / "b.npz"), checkpoint_every=2,
        device="cpu")
    ref = solve_record(kw, "k")
    for k, v in solve_record(pos, "k").items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    jres = j_solve_checkpointed(_j_engine(), *arrays(s), _jax_option(4),
                                str(tmp_path / "j.npz"), 2)
    _compare(jres, pos, cost_rtol=1e-9)


# ------------------------------------------------ the public names


def test_geo_names_match_jax():
    import jax.numpy as jnp
    from megba_tpu.ops import geo as jgeo

    from megba_tpu_torch.ops import geo as tgeo

    rng = np.random.default_rng(5)
    for _ in range(4):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        np.testing.assert_allclose(
            tgeo.quaternion_to_rotation_matrix(torch.from_numpy(q)).numpy(),
            np.asarray(jgeo.quaternion_to_rotation_matrix(jnp.asarray(q))),
            rtol=1e-13, atol=1e-15)
    for scale in (1.0, 1e-3, 0.0):
        w, x = scale * rng.standard_normal(3), rng.standard_normal(3)
        np.testing.assert_allclose(
            tgeo.drotated_dangle_axis(torch.from_numpy(w),
                                      torch.from_numpy(x)).numpy(),
            np.asarray(jgeo.drotated_dangle_axis(jnp.asarray(w),
                                                 jnp.asarray(x))),
            rtol=1e-12, atol=1e-14)
    # Batched over a trailing edge axis, as every port geo op.
    w, x = rng.standard_normal((3, 5)), rng.standard_normal((3, 5))
    batch = tgeo.drotated_dangle_axis(torch.from_numpy(w),
                                      torch.from_numpy(x)).numpy()
    for e in range(5):
        np.testing.assert_allclose(
            batch[..., e], np.asarray(jgeo.drotated_dangle_axis(
                jnp.asarray(w[:, e]), jnp.asarray(x[:, e]))),
            rtol=1e-12, atol=1e-14)


def test_one_edge_analytical_engine_matches_jax():
    import jax.numpy as jnp
    from megba_tpu.ops.residuals import (
        bal_residual_jacobian_analytical as j_one,
    )

    from megba_tpu_torch.ops.residuals import (
        bal_residual_jacobian_analytical as t_one,
    )

    s = scene()
    for e in (0, 7, 100):
        args = (s.cameras0[s.cam_idx[e]], s.points0[s.pt_idx[e]], s.obs[e])
        t = t_one(*(torch.from_numpy(np.ascontiguousarray(a))
                    for a in args))
        j = j_one(*(jnp.asarray(a) for a in args))
        assert [tuple(a.shape) for a in t] == [(2,), (2, 9), (2, 3)]
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-12, atol=1e-12)


def test_data_model_and_top_level_names_match_jax():
    import dataclasses as dc

    import megba_tpu
    from megba_tpu.core import types as jtypes

    from megba_tpu_torch.core import types as ttypes

    for name in ("BALData", "BAState"):
        assert [f.name for f in dc.fields(getattr(ttypes, name))] == [
            f.name for f in dc.fields(getattr(jtypes, name))]
        assert getattr(mt, name) is getattr(ttypes, name)
    s = scene()
    d = mt.BALData(cameras=s.cameras0, points=s.points0, obs=s.obs,
                   cam_idx=s.cam_idx, pt_idx=s.pt_idx,
                   mask=np.ones(s.obs.shape[0]))
    assert (d.num_cameras, d.num_points, d.n_edge, d.camera_dim,
            d.point_dim) == (8, 120, s.obs.shape[0], 9, 3)
    assert mt.BaseVertex is mt.problem.BaseVertex
    missing = [n for n in megba_tpu.__all__ if not hasattr(mt, n)]
    assert missing == []


@pytest.mark.parametrize("sub", ["solver", "linear_system", "ops", "io",
                                 "parallel", "core"])
def test_subpackages_re_export_jax_names(sub):
    import importlib

    jmod = importlib.import_module(f"megba_tpu.{sub}")
    tmod = importlib.import_module(f"megba_tpu_torch.{sub}")
    assert sorted(tmod.__all__) == sorted(jmod.__all__)
    for name in jmod.__all__:
        assert getattr(tmod, name) is not None, name


def test_report_tiles_from_the_ports_plans(tmp_path):
    import json

    from megba_tpu.ops.segtiles import edge_stream_reuse as j_reuse

    s = scene()
    sink = str(tmp_path / "t.jsonl")
    for fused in (False, True):
        opt = dataclasses.replace(
            option(world=1, max_iter=1), telemetry=sink,
            solver_option=dataclasses.replace(option().solver_option,
                                              fused_kernels=fused))
        mt.flat_solve(None, *arrays(s), opt, device="cpu")
    lines = [json.loads(x) for x in open(sink).read().splitlines()]
    order = np.argsort(s.cam_idx, kind="stable")
    reuse = j_reuse(s.cam_idx[order], s.pt_idx[order], 1, 1)
    for rep, fused in zip(lines, (False, True)):
        tiles = rep["tiles"]
        assert tiles["plan"] == "csr_1d" and tiles["occupancy"] == 1.0
        for k, v in reuse.items():
            assert tiles[k] == v, k
        if fused:
            for key in ("fused_to_pt", "fused_to_cam"):
                summ = tiles[key]
                assert set(summ) == {"tiles", "tile", "occupancy", "edges",
                                     "slots"}
                assert summ["edges"] == s.obs.shape[0]
                assert summ["slots"] == summ["tiles"] * summ["tile"]
        else:
            assert "fused_to_pt" not in tiles

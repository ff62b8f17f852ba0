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
  `load_state` with their world header; the 2-D mesh across the two
  processes: `psum_groups`, the grouped `psum_scatter`, a subgroup
  `all_gather` and `ppermute` bitwise one process, 2 x 2 (two shards a
  process: only the take from row 0 crosses) and 1 x 2 (one shard a
  process: every ring hop crosses) `flat_solve`s in every S.p arm
  bitwise the one-process 2-D solves, and a 2-D `resume_elastic` onto
  the smaller mesh JAX picks.  One pair of rank processes serves every
  case (a module fixture); each runs on one intra-op thread, and is
  killed if it outlives its time limit.
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

import dataclasses
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
from megba_tpu_torch.parallel import collectives as col  # noqa: E402
from megba_tpu_torch.parallel import mesh as tmesh  # noqa: E402

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


# The 2-D layouts across the two processes: (name, world, cam_blocks,
# this process's devices).  2 x 2: rank r holds row e = r; 1 x 2: rank r
# holds column c = r.
LAYOUTS_2D = (("2x2", 4, 2, ["cpu", "cpu"]), ("1x2", 2, 2, "cpu"))
# The S.p arms of the 2-D solve: (name, kind, fused, bf16 collectives).
ARMS_2D = (("implicit", "IMPLICIT", False, False),
           ("explicit", "EXPLICIT", False, False),
           ("fused_implicit", "IMPLICIT", True, False),
           ("fused_explicit", "EXPLICIT", True, False),
           ("bf16_wire", "IMPLICIT", False, True))


def option_2d(world, cam_blocks, kind, fused, wire, max_iter=4):
    """A 2-D mesh option; the bf16 wire needs the bf16 rung (f32)."""
    opt = option(world, max_iter)
    so = dataclasses.replace(
        opt.solver_option, mesh_2d=True, cam_blocks=cam_blocks,
        fused_kernels=fused, bf16=wire, bf16_collectives=wire)
    return dataclasses.replace(
        opt, compute_kind=getattr(mt.ComputeKind, kind), solver_option=so,
        dtype=np.float32 if wire else np.float64)


def group_parts(n=4):
    rng = np.random.default_rng(12)
    return [torch.from_numpy(rng.standard_normal((2, 6))) for _ in
            range(n)]


# Subgroup collectives on the 2 x 2 mesh of shards e * 2 + c.
ROWS = [[0, 1], [2, 3]]
COLS = [[0, 2], [1, 3]]
# Down and up the columns: every hop crosses the processes.
RING = [(2, 0), (3, 1), (0, 2), (1, 3)]
RING_1X2 = [(1, 0), (0, 1)]


def subgroup_collectives(parts, devs, like):
    """The subgroup collectives of the 2-D S.p, on per-shard `parts`
    (REMOTE for another process's) and shard devices `devs` (None for
    another process's): {name: host array of this process's view}."""
    out = {}
    g = col.psum_groups(parts, COLS, [devs[0], devs[1]])
    out["psum_groups"] = [x for x in g]
    out["psum_scatter"] = col.psum_scatter(parts, 2, 1, devs, groups=ROWS)
    out["all_gather_row1"] = col.all_gather(
        [parts[2], parts[3]], 1, torch.device("cpu"), shards=[2, 3],
        like=like)
    out["ppermute"] = col.ppermute(parts, RING, devs, like)
    return out


def _dot(d):
    """{name: [tensors or REMOTE]} -> flat {name_k: array} of the
    tensors held here."""
    rec = {}
    for name, v in d.items():
        if isinstance(v, torch.Tensor):
            rec[name] = v.float().numpy()
            continue
        for k, x in enumerate(v):
            if isinstance(x, torch.Tensor):
                rec[f"{name}_{k}"] = x.float().numpy()
    return rec


def _rank(rank: int, port: str, outdir: str) -> None:
    """One rank of the two-process world (this file run as a script)."""
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

    # Subgroup collectives and hops on the 2 x 2 mesh across processes
    # (shards 2r and 2r + 1 here), then the 1 x 2 ring.
    mesh4 = tmesh.make_process_mesh(4, ["cpu", "cpu"], "cpu", mesh_2d=True,
                                    cam_blocks=2)
    gp = group_parts()
    like = ((2, 6), torch.float64)
    col.reset_gather_stats()
    with col.mesh_scope(mesh4):
        local = col.for_shards(lambda k: gp[k], range(4))
        for k, v in _dot(subgroup_collectives(local, mesh4.devices,
                                              like)).items():
            rec[f"sub_{k}"] = v
    rec["sub_gathers"] = np.asarray(col.gather_stats()["gathers"])
    rec["sub_hops"] = np.asarray(col.gather_stats()["hops"])
    mesh2 = tmesh.make_process_mesh(2, "cpu", "cpu", mesh_2d=True,
                                    cam_blocks=2)
    rec["mesh2_shape"] = np.asarray(mesh2.shape)
    with col.mesh_scope(mesh2):
        local = col.for_shards(lambda k: gp[k], range(2))
        out = col.ppermute(local, RING_1X2, mesh2.devices, like)
        rec[f"hop_{rank}"] = out[rank].numpy()

    s = scene()
    for lname, world, cb, devs in LAYOUTS_2D:
        for aname, kind, fused, wire in ARMS_2D:
            col.reset_gather_stats()
            res = mt.flat_solve(None, *arrays(s), option_2d(
                world, cb, kind, fused, wire), device=devs)
            rec.update(solve_record(res, f"m{lname}_{aname}"))
            st = col.gather_stats()
            rec[f"m{lname}_{aname}_hop_bytes"] = np.asarray(st["hop_bytes"])
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
    # A 2-D world of 4 across the processes, then a cooperative
    # shrink-world resume of each process on its own two shards.
    opt2d = option_2d(4, 2, "IMPLICIT", False, False, max_iter=2)
    ck2d = os.path.join(outdir, f"ck2d{rank}.npz")
    mt.solve_checkpointed(None, *arrays(s), opt2d, checkpoint_path=ck2d,
                          checkpoint_every=2, device=["cpu", "cpu"])
    from megba_tpu_torch.robustness.elastic import resume_elastic

    tele = os.path.join(outdir, f"resume2d{rank}.jsonl")
    res = resume_elastic(None, *arrays(s), dataclasses.replace(
        option_2d(4, 2, "IMPLICIT", False, False, max_iter=4),
        telemetry=tele), ck2d, world_size=2, cooperative=True,
        checkpoint_every=2, device=["cpu", "cpu"])
    rec.update(solve_record(res, "resume2d"))
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **rec)
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), sys.argv[2], sys.argv[3])
    raise SystemExit(0)


import functools  # noqa: E402
import json  # noqa: E402

import pytest  # noqa: E402

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


def test_2d_subgroup_collectives_bitwise_one_process(world):
    rec, _ = world
    gp = group_parts()
    cpu = torch.device("cpu")
    want = _dot(subgroup_collectives(gp, [cpu] * 4, None))
    for r in range(WORLD):
        got = {k[4:]: v for k, v in rec[r].items() if k.startswith("sub_")
               and k not in ("sub_gathers", "sub_hops")}
        # This process's outputs: its own shards' (2r, 2r + 1), the
        # column sums it owns (rank 0: both (0, c)) and the gather.
        mine = {f"psum_scatter_{2 * r}", f"psum_scatter_{2 * r + 1}",
                f"ppermute_{2 * r}", f"ppermute_{2 * r + 1}",
                "all_gather_row1"}
        if r == 0:
            mine |= {"psum_groups_0", "psum_groups_1"}
        assert set(got) == mine, sorted(got)
        for k in mine:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        # One gather for each of the three collectives, for every
        # process (the one with no part of row 1 too); two hops sent and
        # two received.
        assert int(rec[r]["sub_gathers"]) == 3
        assert int(rec[r]["sub_hops"]) == 4


def test_ppermute_across_processes(world):
    rec, _ = world
    gp = group_parts()
    for r in range(WORLD):
        np.testing.assert_array_equal(rec[r]["mesh2_shape"], [1, 2])
        # Ring (1 -> 0, 0 -> 1): each process receives the other's part.
        np.testing.assert_array_equal(rec[r][f"hop_{r}"],
                                      gp[1 - r].numpy())
    layout = col.ProcessLayout([0, 0, 1, 1], 1)
    assert layout.local == (2, 3) and layout.home == 2 and layout.nproc == 2


@pytest.mark.parametrize("arm", [a[0] for a in ARMS_2D])
@pytest.mark.parametrize("layout", [lay[0] for lay in LAYOUTS_2D])
def test_2d_flat_solve_across_processes_bitwise_one_process(world, layout,
                                                           arm):
    rec, _ = world
    _, w, cb, _ = next(x for x in LAYOUTS_2D if x[0] == layout)
    _, kind, fused, wire = next(x for x in ARMS_2D if x[0] == arm)
    one = mt.flat_solve(None, *arrays(scene()), option_2d(
        w, cb, kind, fused, wire), device=["cpu"] * w)
    prefix = f"m{layout}_{arm}"
    ref = solve_record(one, prefix)
    for r in range(WORLD):
        _bitwise(rec[r], prefix, ref)
    hop_bytes = [int(rec[r][f"{prefix}_hop_bytes"]) for r in range(WORLD)]
    if layout == "1x2":
        # Every ring hop crosses: each process receives point shards.
        assert min(hop_bytes) > 0, hop_bytes
    else:
        # Only the take from row 0 crosses, into rank 1.
        assert hop_bytes[0] == 0 and hop_bytes[1] > 0, hop_bytes


def test_2d_resume_elastic_across_processes_takes_jax_mesh(world):
    from megba_tpu.parallel.mesh import factor_mesh_2d as j_factor
    from megba_tpu.parallel.mesh import nearest_cam_blocks as j_nearest

    rec, outdir = world
    # JAX's smaller mesh for a 2 x 2 world resumed at world 2.
    e, c = j_factor(2, j_nearest(2, 2))
    ref = mt.flat_solve(None, *arrays(scene()), option_2d(
        4, 2, "IMPLICIT", False, False), device=["cpu"] * 4)
    for r in range(WORLD):
        res = rec[r]
        np.testing.assert_allclose(res["resume2d_cost"],
                                   ref.cost.numpy(), rtol=1e-6)
        np.testing.assert_allclose(res["resume2d_cameras"],
                                   ref.cameras.numpy(), rtol=1e-6,
                                   atol=1e-9)
        assert int(res["resume2d_status"]) == int(ref.status)
        with open(os.path.join(outdir, f"resume2d{r}.jsonl")) as f:
            lines = [json.loads(x) for x in f if x.strip()]
        meshes = {x["problem"].get("mesh") for x in lines
                  if x.get("problem")}
        assert meshes == {f"{e}x{c}"}, meshes


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

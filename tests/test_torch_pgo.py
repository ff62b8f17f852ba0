"""The port's pose-graph driver (models/pgo.py) vs the JAX package's.

Ports of tests/test_pgo.py's cases that are not marked slow, each held
to the JAX package's `solve_pgo` at float64 on the same seeded graph
(`meas_noise` 0.01 and an LM cap of 4, which stop before the cost
floor, where an accept decision would turn on rounding): the verbose
lines with `elapsed` masked (the trial cost of every iteration, its
accept flag and PCG count; each line's cost at rtol 1e-9), the final
cost at rtol 1e-9, equal LM, accept and PCG counts and status, and the
poses within 1e-9 of their magnitude.  The cases: SE(3) and sim(3)
(whose refuse_ratio default comes from its spec), sqrt_info, fixed
poses, Huber and Cauchy with one bad loop closure, forcing with warm
starts, `with_priors`, and the edge-sharded solve at world 2 and 4
(`device=["cpu"] * N`, against JAX's world N on its virtual CPU
devices).  The host helpers (`make_synthetic_pose_graph`,
`make_synthetic_sim3_graph`, `spanning_tree_init`, `with_priors`) give
arrays equal to JAX's.  Each JAX program compiles once (a few seconds),
so the references are `lru_cache`d.
"""

import dataclasses
import functools
import re

import jax
import numpy as np
import pytest
import torch

import megba_tpu.common as jc
from megba_tpu.factors.sim3 import (
    make_synthetic_sim3_graph as j_make_sim3,
)
from megba_tpu.models import pgo as jpgo
from megba_tpu.ops.robust import RobustKind as JRobustKind

import megba_tpu_torch as mt
from megba_tpu_torch.factors.sim3 import make_synthetic_sim3_graph
from megba_tpu_torch.models import pgo as tpgo

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

_ELAPSED = re.compile(r"elapsed [0-9.]+ ms")
_COST = re.compile(r"cost (\S+) ")

N_POSES, N_LOOPS = 64, 10
LM_CAP = 4


def _opts(robust=None, world=1, forcing=False, sim3=False, lm_cap=LM_CAP):
    """The (JAX, port) option pair of a case: f64, an LM cap that stops
    before the cost floor, a tight PCG.  sim(3) keeps SolverOption's
    refuse_ratio default, so its spec's 16 applies."""
    out = []
    for pkg, kinds in ((jc, JRobustKind), (mt, mt.RobustKind)):
        solver = dict(max_iter=60, tol=1e-12)
        if not sim3:
            solver["refuse_ratio"] = 1e30
        if forcing:
            solver.update(tol=1e-1, forcing=True, warm_start=True)
        kw = dict(dtype=np.float64, world_size=world,
                  algo_option=pkg.AlgoOption(max_iter=lm_cap, epsilon1=1e-12,
                                             epsilon2=1e-15),
                  solver_option=pkg.SolverOption(**solver))
        if robust is not None:
            kw.update(robust_kind=getattr(kinds, robust),
                      robust_delta=0.1)
        out.append(pkg.ProblemOption(**kw))
    return tuple(out)


def _graph(sim3=False, seed=3):
    if sim3:
        return make_synthetic_sim3_graph(N_POSES, N_LOOPS, meas_noise=0.01,
                                         seed=seed)
    return tpgo.make_synthetic_pose_graph(N_POSES, N_LOOPS, meas_noise=0.01,
                                          seed=seed)


def _bad_loop(g):
    """One gross loop closure: the last edge's translation."""
    meas = g.meas.copy()
    meas[-1, 3:] += np.array([4.0, -3.0, 2.0])
    return meas


def _case_arrays(case):
    """(poses0, edge_i, edge_j, meas, kw, option args) of a named case."""
    g = _graph(sim3=case == "sim3")
    arrays = [g.poses0, g.edge_i, g.edge_j, g.meas]
    kw, okw = {}, {}
    if case == "sim3":
        kw["factor"] = "sim3_between"
        okw["sim3"] = True
    elif case == "sqrt_info":
        rng = np.random.default_rng(5)
        L = np.tril(rng.uniform(-0.2, 0.2, (len(g.edge_i), 6, 6)))
        L[:, np.arange(6), np.arange(6)] = rng.uniform(0.5, 2.0,
                                                       (len(g.edge_i), 6))
        kw["sqrt_info"] = np.swapaxes(L, 1, 2)
    elif case == "fixed":
        fixed = np.zeros(N_POSES, bool)
        fixed[[0, 20, 41]] = True
        kw["fixed"] = fixed
    elif case in ("huber", "cauchy"):
        arrays[3] = _bad_loop(g)
        okw["robust"] = case.upper()
    elif case == "forcing_warm":
        okw["forcing"] = True
    elif case == "priors":
        idx = np.array([3, 17, 40])
        target = g.poses_gt[idx] + np.array([0, 0, 0, 0.05, -0.02, 0.01])
        poses0, ei, ej, meas, fixed, si = tpgo.with_priors(
            g.poses0, g.edge_i, g.edge_j, g.meas, prior_idx=idx,
            prior_poses=target,
            prior_sqrt_info=np.broadcast_to(np.eye(6) * 10.0, (3, 6, 6)))
        arrays = [tpgo.spanning_tree_init(poses0, ei, ej, meas, fixed),
                  ei, ej, meas]
        kw.update(fixed=fixed, sqrt_info=si)
    elif case.startswith("world"):
        okw["world"] = int(case[len("world"):])
    return arrays, kw, okw


CASES = ["se3", "sim3", "sqrt_info", "fixed", "huber", "cauchy",
         "forcing_warm", "priors"]


def _lines(text):
    return [_ELAPSED.sub("elapsed <t> ms", ln)
            for ln in text.splitlines()
            if ln.startswith("iter ") or ln.startswith("PGO: ")]


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The JAX package's solve of a case and its verbose lines."""
    import contextlib
    import io

    arrays, kw, okw = _case_arrays(case)
    jopt, _ = _opts(**okw)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = jpgo.solve_pgo(*arrays, jopt, verbose=True, **kw)
        jax.block_until_ready(res.cost)
        jax.effects_barrier()
    return res, _lines(buf.getvalue())


def _port_run(case, capsys, device="cpu"):
    arrays, kw, okw = _case_arrays(case)
    _, topt = _opts(**okw)
    capsys.readouterr()
    res = tpgo.solve_pgo(*arrays, topt, verbose=True, device=device, **kw)
    return res, _lines(capsys.readouterr().out)


def _compare(t_res, t_lines, j_res, j_lines):
    assert len(t_lines) == len(j_lines) == t_res.iterations + 1
    assert t_lines == j_lines
    for a, b in zip(t_lines[:-1], j_lines[:-1]):
        ca = float(_COST.search(a).group(1))
        cb = float(_COST.search(b).group(1))
        np.testing.assert_allclose(ca, cb, rtol=1e-9)
    np.testing.assert_allclose(float(t_res.cost), float(j_res.cost),
                               rtol=1e-9)
    np.testing.assert_allclose(float(t_res.initial_cost),
                               float(j_res.initial_cost), rtol=1e-12)
    assert (t_res.iterations, t_res.accepted, t_res.pcg_iterations,
            t_res.status, t_res.stopped) == (
        int(j_res.iterations), int(j_res.accepted),
        int(j_res.pcg_iterations), int(j_res.status), bool(j_res.stopped))
    jp = np.asarray(j_res.poses)
    tp = t_res.poses.numpy()
    assert tp.shape == jp.shape
    assert np.abs(tp - jp).max() <= 1e-9 * np.abs(jp).max()
    np.testing.assert_allclose(float(t_res.region), float(j_res.region),
                               rtol=1e-9)
    assert float(t_res.v) == float(j_res.v)


@pytest.mark.parametrize("case", CASES)
def test_solve_pgo_matches_jax(case, capsys):
    j_res, j_lines = _jax_run(case)
    t_res, t_lines = _port_run(case, capsys)
    assert t_res.accepted >= 1
    _compare(t_res, t_lines, j_res, j_lines)
    if case == "fixed":
        fixed = _case_arrays(case)[1]["fixed"]
        np.testing.assert_array_equal(t_res.poses.numpy()[fixed],
                                      _graph().poses0[fixed])
    if case == "priors":  # the virtual anchors come back unchanged
        arrays = _case_arrays(case)[0]
        np.testing.assert_array_equal(t_res.poses.numpy()[N_POSES:],
                                      arrays[0][N_POSES:])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_solve_matches_jax(world, capsys):
    """World N on N CPU shards against JAX's world N (74 edges: world 4
    pads the edge axis) and against the port's own world 1."""
    j_res, j_lines = _jax_run(f"world{world}")
    t_res, t_lines = _port_run(f"world{world}", capsys,
                               device=["cpu"] * world)
    _compare(t_res, t_lines, j_res, j_lines)
    one, one_lines = _port_run("se3", capsys)
    _compare(t_res, t_lines, one, one_lines)


def test_sharded_solve_needs_a_device_per_shard():
    g = _graph()
    _, topt = _opts(world=2)
    with pytest.raises(ValueError, match="exceeds available devices"):
        tpgo.solve_pgo(g.poses0, g.edge_i, g.edge_j, g.meas, topt,
                       device=["cpu"])


def test_default_gauge_and_resume(capsys):
    """Pose 0 stays where the default anchor holds it; a split solve
    through initial_region / initial_v (the SE(3) case's state) equals
    its JAX counterpart (no new JAX program: the resume state rides as
    operands of the SE(3) case's)."""
    j_res, _ = _jax_run("se3")
    t_res, _ = _port_run("se3", capsys)
    g = _graph()
    np.testing.assert_array_equal(t_res.poses.numpy()[0], g.poses0[0])
    jopt, topt = _opts()
    j2 = jpgo.solve_pgo(np.asarray(j_res.poses), g.edge_i, g.edge_j, g.meas,
                        jopt, verbose=True,
                        initial_region=float(j_res.region),
                        initial_v=float(j_res.v))
    jax.effects_barrier()
    t2 = tpgo.solve_pgo(t_res.poses.numpy(), g.edge_i, g.edge_j, g.meas,
                        topt, verbose=True,
                        initial_region=float(t_res.region),
                        initial_v=float(t_res.v), device="cpu")
    np.testing.assert_allclose(float(t2.initial_cost), float(t_res.cost),
                               rtol=1e-12)
    np.testing.assert_allclose(float(t2.cost), float(j2.cost), rtol=1e-9)
    assert (t2.iterations, t2.accepted, t2.pcg_iterations, t2.status) == (
        int(j2.iterations), int(j2.accepted), int(j2.pcg_iterations),
        int(j2.status))


@pytest.mark.parametrize("seed,n,loops,noise", [
    (0, 32, 6, 0.0), (7, 12, 3, 0.02), (11, 29, 6, 0.01)])
def test_make_synthetic_pose_graph_matches_jax(seed, n, loops, noise):
    t = tpgo.make_synthetic_pose_graph(n, loops, meas_noise=noise, seed=seed)
    j = jpgo.make_synthetic_pose_graph(n, loops, meas_noise=noise, seed=seed)
    for f in dataclasses.fields(j):
        np.testing.assert_array_equal(getattr(t, f.name),
                                      getattr(j, f.name), f.name)
        assert getattr(t, f.name).dtype == getattr(j, f.name).dtype


@pytest.mark.parametrize("seed,noise", [(0, 0.0), (2, 0.01)])
def test_make_synthetic_sim3_graph_matches_jax(seed, noise):
    t = make_synthetic_sim3_graph(16, 5, meas_noise=noise, seed=seed)
    j = j_make_sim3(16, 5, meas_noise=noise, seed=seed)
    for f in dataclasses.fields(j):
        np.testing.assert_array_equal(getattr(t, f.name),
                                      getattr(j, f.name), f.name)


@pytest.mark.parametrize("anchors", [None, [0, 9], []])
def test_spanning_tree_init_matches_jax(anchors):
    g = tpgo.make_synthetic_pose_graph(20, 4, meas_noise=0.0, seed=15)
    garbage = np.random.default_rng(0).standard_normal((20, 6)) * 3.0
    garbage[0] = g.poses_gt[0]
    fixed = None
    if anchors is not None:
        fixed = np.zeros(20, bool)
        fixed[anchors] = True
    t = tpgo.spanning_tree_init(garbage, g.edge_i, g.edge_j, g.meas, fixed)
    j = jpgo.spanning_tree_init(garbage, g.edge_i, g.edge_j, g.meas, fixed)
    np.testing.assert_array_equal(t, j)
    # Disconnected poses keep their estimate.
    ei, ej = np.array([0, 1], np.int32), np.array([1, 2], np.int32)
    np.testing.assert_array_equal(
        tpgo.spanning_tree_init(garbage[:5], ei, ej, g.meas[:2])[3:],
        garbage[3:5])


@pytest.mark.parametrize("variant", ["none", "weighted", "fixed"])
def test_with_priors_matches_jax(variant):
    g = tpgo.make_synthetic_pose_graph(8, 2, seed=9)
    kw = dict(prior_idx=[5, 2], prior_poses=g.poses_gt[[5, 2]])
    if variant == "none":
        kw = dict(prior_idx=np.zeros(0, np.int32),
                  prior_poses=np.zeros((0, 6)))
    elif variant == "weighted":
        kw.update(prior_sqrt_info=[np.eye(6) * 3.0, np.eye(6) * 0.5],
                  sqrt_info=np.tile(np.eye(6) * 2.0, (len(g.edge_i), 1, 1)))
    else:
        kw["fixed"] = np.eye(1, 8, 0, dtype=bool)[0]
    t = tpgo.with_priors(g.poses0, g.edge_i, g.edge_j, g.meas, **kw)
    j = jpgo.with_priors(g.poses0, g.edge_i, g.edge_j, g.meas, **kw)
    for a, b in zip(t, j):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def _message(fn, *args, **kw):
    with pytest.raises(Exception) as e:
        fn(*args, **kw)
    return type(e.value).__name__, str(e.value)


def test_refusals_match_jax():
    """with_priors's and solve_pgo's checks raise JAX's messages."""
    g = tpgo.make_synthetic_pose_graph(6, 2, seed=1)
    n = g.poses0.shape[0]
    args = (g.poses0, g.edge_i, g.edge_j, g.meas)
    for kw in (dict(prior_idx=[n], prior_poses=[np.zeros(6)]),
               dict(prior_idx=[0], prior_poses=[np.zeros(5)]),
               dict(prior_idx=[0], prior_poses=[np.zeros(6)],
                    prior_sqrt_info=np.broadcast_to(np.eye(6), (2, 6, 6)))):
        assert (_message(tpgo.with_priors, *args, **kw)
                == _message(jpgo.with_priors, *args, **kw))
    for bad_args, kw in (
            ((g.poses0[:, :5],) + args[1:], {}),
            (args[:3] + (g.meas[:, :4],), {}),
            (args, dict(sqrt_info=np.zeros((len(g.edge_i), 5, 5)))),
            ((np.zeros((n, 7)),) + args[1:], dict(factor="sim3_between"))):
        t_name, t_msg = _message(tpgo.solve_pgo, *bad_args, device="cpu",
                                 **kw)
        j_name, j_msg = _message(jpgo.solve_pgo, *bad_args, **kw)
        assert (t_name, t_msg) == (j_name, j_msg)
    t_name, t_msg = _message(tpgo.solve_pgo, *args, factor="bal",
                             device="cpu")
    j_name, j_msg = _message(jpgo.solve_pgo, *args, factor="bal")
    assert t_name == j_name == "FactorError"
    stem = "solve_pgo: factor 'bal' is a camera/point (Schur) family"
    assert t_msg.startswith(stem) and j_msg.startswith(stem)
    with pytest.raises(mt.factors.UnknownFactorError):
        tpgo.solve_pgo(*args, factor="nope", device="cpu")


def test_top_level_exports_and_no_card():
    """The package's solve_pgo / solve_g2o are the modules'; the entry
    points default to the card and raise without one."""
    g = tpgo.make_synthetic_pose_graph(6, 2, seed=1)
    args = (g.poses0, g.edge_i, g.edge_j, g.meas)
    res = mt.solve_pgo(*args, device="cpu")
    ref = tpgo.solve_pgo(*args, device="cpu")
    assert float(res.cost) == float(ref.cost)
    assert res.poses.device.type == "cpu"
    assert isinstance(res, tpgo.PGOResult)
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mt.solve_pgo(*args)

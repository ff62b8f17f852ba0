"""The port's g2o-style Problem / Vertex / Edge facade vs the JAX package.

Ports of tests/test_problem_api.py, each held to the JAX package's
`BaseProblem` on the same seeded scene at float64: write-back, fixed
vertices and information weighting (trial costs at rtol 1e-9, equal
accept pattern and LM / PCG counts, the written-back estimations), a
custom `forward()` (plain torch in the port, plain jnp in the JAX
package), `erase_vertex`, and the refusals of heterogeneous edges and of
wrong vertex kinds.  Pose graphs (PoseVertex + BetweenEdge) keep the JAX
package's guards and solve through the pose-graph driver: bitwise the
port's `solve_pgo` on the lowered arrays, and JAX's `BaseProblem` at
rtol 1e-9, a fixed vertex holding the gauge.  CPU only;
tests/test_torch_cuda.py solves a custom-shape edge on the card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megba_tpu as jm
from megba_tpu.core.linalg import psd_sqrt as j_psd_sqrt
from megba_tpu.ops import geo as jgeo
from megba_tpu.problem import BetweenEdge as JBetweenEdge
from megba_tpu.problem import PoseVertex as JPoseVertex

import megba_tpu_torch as mt
from megba_tpu_torch.core.linalg import psd_sqrt
from megba_tpu_torch.models.pgo import make_synthetic_pose_graph, solve_pgo
from megba_tpu_torch.ops import geo as tgeo

from test_torch_solve import _compare

# One scene for every solve; the options stop before the cost floor.
SCENE = dict(num_cameras=5, num_points=30, obs_per_point=3, seed=4,
             param_noise=4e-2, pixel_noise=0.2)
OPT = dict(algo=dict(max_iter=5, epsilon1=1e-12, epsilon2=1e-15),
           solver=dict(max_iter=30, tol=1e-10, refuse_ratio=1e30))


def _option(pkg):
    return pkg.ProblemOption(
        algo_option=pkg.AlgoOption(**OPT["algo"]),
        solver_option=pkg.SolverOption(**OPT["solver"]))


def _info(n, seed=5):
    """Per-edge SPD information matrices."""
    L = np.tril(0.3 * np.random.default_rng(seed).standard_normal(
        (n, 2, 2))) + np.eye(2)
    return L @ np.swapaxes(L, 1, 2)


def build(pkg, edge_cls=None, case="plain", **problem_kw):
    """The same graph in either package: SCENE's cameras and points, one
    edge per observation; `case` fixes the first camera and a point
    ("fixed") or gives every edge an information matrix ("info")."""
    s = mt.make_synthetic_bal(**SCENE)
    pb = pkg.BaseProblem(_option(pkg), **problem_kw)
    cams = [pkg.CameraVertex(e, fixed=(case == "fixed" and i == 0))
            for i, e in enumerate(s.cameras0)]
    pts = [pkg.PointVertex(e, fixed=(case == "fixed" and j == 3))
           for j, e in enumerate(s.points0)]
    for i, v in enumerate(cams):
        pb.append_vertex(i, v)
    for j, v in enumerate(pts):
        pb.append_vertex(1000 + j, v)
    infos = _info(s.obs.shape[0])
    edge_cls = edge_cls or pkg.BaseEdge
    for k, (c, p, uv) in enumerate(zip(s.cam_idx, s.pt_idx, s.obs)):
        pb.append_edge(edge_cls([cams[c], pts[p]], measurement=uv,
                                information=infos[k] if case == "info"
                                else None))
    return s, pb, cams, pts


@functools.lru_cache(maxsize=None)
def _jax(case):
    s, pb, cams, pts = build(jm, case=case)
    res = pb.solve()
    return res, np.stack([v.estimation for v in cams]), np.stack(
        [v.estimation for v in pts])


@pytest.mark.parametrize("case", ["plain", "fixed", "info"])
def test_solve_writes_back_and_matches_jax(case):
    s, pb, cams, pts = build(mt, case=case, device="cpu")
    before = [v.estimation.copy() for v in cams]
    res = pb.solve()
    jres, jcams, jpts = _jax(case)
    assert int(jres.iterations) > 2
    _compare(jres, res, cost_rtol=1e-9)
    assert pb.result is res
    tcams = np.stack([v.estimation for v in cams])
    np.testing.assert_allclose(tcams, jcams, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.stack([v.estimation for v in pts]), jpts,
                               rtol=1e-8, atol=1e-10)
    # Written back into the very vertex objects get_vertex returns.
    assert pb.get_vertex(1) is cams[1]
    assert not np.allclose(cams[1].estimation, before[1])
    np.testing.assert_array_equal(tcams, res.cameras.numpy())
    if case == "fixed":
        np.testing.assert_array_equal(cams[0].estimation, before[0])
        np.testing.assert_array_equal(pts[3].estimation, s.points0[3])


class TorchBALEdge(mt.BaseEdge):
    """The BAL model written out in torch by a user of the facade."""

    def forward(self):
        camera, point = self.vertex_estimation(0), self.vertex_estimation(1)
        w, t = camera[0:3], camera[3:6]
        f, k1, k2 = camera[6], camera[7], camera[8]
        P = tgeo.angle_axis_rotate_point(w, point) + t
        p = -P[0:2] / P[2]
        n = (p * p).sum(0)
        return f * (1.0 + k1 * n + k2 * n * n) * p - self.get_measurement()


class JaxBALEdge(jm.BaseEdge):
    def forward(self):
        camera, point = self.vertex_estimation(0), self.vertex_estimation(1)
        w, t = camera[0:3], camera[3:6]
        f, k1, k2 = camera[6], camera[7], camera[8]
        P = jgeo.angle_axis_rotate_point(w, point) + t
        p = -P[0:2] / P[2]
        n = jnp.dot(p, p)
        return f * (1.0 + k1 * n + k2 * n * n) * p - self.get_measurement()


def test_custom_forward_edge_matches_jax_and_builtin():
    _, pb, cams, _ = build(mt, TorchBALEdge, device="cpu")
    res = pb.solve()
    engine = pb._engine
    _, jpb, _, _ = build(jm, JaxBALEdge)
    jres = jpb.solve()
    _compare(jres, res, cost_rtol=1e-9)
    # The same model as the built-in edge (AUTODIFF: the same engine
    # arithmetic, another function).
    np.testing.assert_allclose(float(res.cost), float(_jax("plain")[0].cost),
                               rtol=1e-9)
    # One engine per problem, kept across solves, dropped by an erase.
    pb.solve()
    assert pb._engine is engine
    _, other, _, _ = build(mt, TorchBALEdge, device="cpu")
    other.solve()
    assert other._engine is not engine
    pb.erase_vertex(1000)
    assert pb._engine is None


def test_erase_vertex_removes_edges():
    s, pb, cams, pts = build(mt, device="cpu")
    n_edges = len(pb._edges)
    touching = sum(1 for e in pb._edges if e.vertices[1] is pts[0])
    assert touching > 0
    pb.erase_vertex(1000)
    assert len(pb._edges) == n_edges - touching
    with pytest.raises(KeyError):
        pb.get_vertex(1000)
    assert pb.solve().iterations > 0


def test_graph_construction_refusals_match_jax():
    class OtherEdge(mt.BaseEdge):
        pass

    _, pb, cams, pts = build(mt, device="cpu")
    with pytest.raises(TypeError, match="heterogeneous"):
        pb.append_edge(OtherEdge([cams[0], pts[0]], measurement=np.zeros(2)))
    with pytest.raises(ValueError, match="duplicate vertex id 0"):
        pb.append_vertex(0, mt.CameraVertex(np.zeros(9)))
    for pkg in (mt, jm):
        pb = pkg.BaseProblem()
        c = pkg.CameraVertex(np.zeros(9))
        pb.append_vertex(0, c)
        pb.append_vertex(1, pkg.CameraVertex(np.zeros(9)))
        with pytest.raises(NotImplementedError, match="CameraVertex, "
                                                      "PointVertex"):
            pb.append_edge(pkg.BaseEdge([c, pb.get_vertex(1)],
                                        measurement=np.zeros(2)))
        stray = pkg.PointVertex(np.zeros(3))
        with pytest.raises(ValueError, match="not in the problem"):
            pb.append_edge(pkg.BaseEdge([c, stray], measurement=np.zeros(2)))
        pb.append_vertex(2, stray)
        with pytest.raises(ValueError, match="no measurement"):
            pb.append_edge(pkg.BaseEdge([c, stray]))
        with pytest.raises(ValueError, match="cameras, points, and edges"):
            pkg.BaseProblem().solve()
    assert mt.CameraVertex(np.zeros(9), fixed=True).grad_shape == 0


def test_solve_without_card_raises_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pb, _, _ = build(mt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.solve()
    pb.device = "cpu"
    assert pb.solve().iterations > 0


def test_pose_graph_guards_match_jax_and_solve_is_refused():
    """The pose-graph guards of both packages; a pose graph then solves
    (held to solve_pgo and JAX), and only an indefinite information
    matrix refuses the solve."""
    for pkg, pv, be in ((mt, mt.PoseVertex, mt.BetweenEdge),
                        (jm, JPoseVertex, JBetweenEdge)):
        pb = pkg.BaseProblem(pkg.ProblemOption())
        v0, v1 = pv(np.zeros(6)), pv(np.ones(6))
        pb.append_vertex(0, v0)
        pb.append_vertex(1, v1)
        with pytest.raises(TypeError, match="BetweenEdge"):
            pb.append_edge(pkg.BaseEdge([v0, v1], measurement=np.zeros(6)))
        with pytest.raises(ValueError, match="6 parameters"):
            pv(np.zeros(7))
        with pytest.raises(ValueError, match="6 values"):
            be([v0, v1], measurement=np.zeros(3))
        with pytest.raises(ValueError, match="6x6"):
            be([v0, v1], measurement=np.zeros(6), information=np.eye(3))
        pb = pkg.BaseProblem(pkg.ProblemOption())
        cam, pt = pkg.CameraVertex(np.zeros(9)), pkg.PointVertex(np.zeros(3))
        pb.append_vertex(2, cam)
        pb.append_vertex(3, pt)
        with pytest.raises(TypeError, match="two PoseVertex"):
            pb.append_edge(be([cam, pt], measurement=np.zeros(6)))
    # A pose graph with PSD information and a fixed vertex (not the
    # first) solves through the pose-graph driver in both packages.
    g = make_synthetic_pose_graph(16, 3, meas_noise=0.01, seed=2)
    info = np.diag([1.0, 1.0, 1.0, 1.0, 1.0, 0.0])
    results = {}
    for pkg, pv, be in ((mt, mt.PoseVertex, mt.BetweenEdge),
                        (jm, JPoseVertex, JBetweenEdge)):
        opt = pkg.ProblemOption(
            algo_option=pkg.AlgoOption(max_iter=4, epsilon1=1e-12,
                                       epsilon2=1e-15),
            solver_option=pkg.SolverOption(max_iter=60, tol=1e-12,
                                           refuse_ratio=1e30))
        kw = dict(device="cpu") if pkg is mt else {}
        pb = pkg.BaseProblem(opt, **kw)
        verts = [pv(p, fixed=(k == 5)) for k, p in enumerate(g.poses0)]
        for k, v in enumerate(verts):
            pb.append_vertex(10 + k, v)
        for e, (a, b) in enumerate(zip(g.edge_i, g.edge_j)):
            pb.append_edge(be([verts[a], verts[b]], measurement=g.meas[e],
                              information=info if e % 3 == 0 else None))
        res = pb.solve()
        assert pb.result is res
        out = np.stack([v.estimation for v in verts])
        results[pkg] = (res, out, opt)
    t_res, t_out, t_opt = results[mt]
    j_res, j_out, _ = results[jm]
    # The fixed vertex holds; pose 0 (no longer the default anchor) moves.
    np.testing.assert_array_equal(t_out[5], g.poses0[5])
    assert np.abs(t_out[0] - g.poses0[0]).max() > 1e-6
    infos = np.stack([info if e % 3 == 0 else np.eye(6)
                      for e in range(len(g.edge_i))])
    fixed = np.arange(16) == 5
    ref = solve_pgo(g.poses0, g.edge_i, g.edge_j, g.meas, t_opt,
                    sqrt_info=psd_sqrt(infos, what="edge"), fixed=fixed,
                    device="cpu")
    assert torch.equal(t_res.cost, ref.cost)
    assert torch.equal(t_res.poses, ref.poses)
    np.testing.assert_array_equal(t_out, ref.poses.numpy())
    assert (t_res.iterations, t_res.accepted, t_res.pcg_iterations) == (
        ref.iterations, ref.accepted, ref.pcg_iterations)
    np.testing.assert_allclose(float(t_res.cost), float(j_res.cost),
                               rtol=1e-9)
    assert (t_res.iterations, t_res.accepted, t_res.pcg_iterations,
            t_res.status) == (int(j_res.iterations), int(j_res.accepted),
                              int(j_res.pcg_iterations), int(j_res.status))
    assert t_res.accepted >= 1
    assert np.abs(t_out - j_out).max() <= 1e-9 * np.abs(j_out).max()
    with pytest.raises(ValueError, match="indefinite"):
        pb2 = mt.BaseProblem(device="cpu")
        verts = [mt.PoseVertex(np.full(6, 0.1 * k)) for k in range(2)]
        for k, v in enumerate(verts[:2]):
            pb2.append_vertex(k, v)
        pb2.append_edge(mt.BetweenEdge(verts[:2], measurement=np.zeros(6),
                                       information=-np.eye(6)))
        pb2.solve()


def test_pose_graph_without_fixed_vertex_anchors_the_first_pose():
    """No fixed vertex: the facade passes fixed=None, so solve_pgo's
    default gauge anchor (the first pose) holds, as in the JAX package;
    the result is solve_pgo's on the lowered arrays."""
    g = make_synthetic_pose_graph(8, 2, meas_noise=0.01, seed=6)
    opt = mt.ProblemOption(algo_option=mt.AlgoOption(max_iter=3))
    pb = mt.BaseProblem(opt, device="cpu")
    verts = [mt.PoseVertex(p) for p in g.poses0]
    for k, v in enumerate(verts):
        pb.append_vertex(k, v)
    for e, (a, b) in enumerate(zip(g.edge_i, g.edge_j)):
        pb.append_edge(mt.BetweenEdge([verts[a], verts[b]],
                                      measurement=g.meas[e]))
    res = pb.solve()
    ref = solve_pgo(g.poses0, g.edge_i, g.edge_j, g.meas, opt,
                    device="cpu")
    assert torch.equal(res.poses, ref.poses)
    np.testing.assert_array_equal(verts[0].estimation, g.poses0[0])
    assert res.iterations == ref.iterations >= 1


def test_psd_sqrt_matches_jax():
    rng = np.random.default_rng(8)
    A = rng.standard_normal((5, 6, 6))
    info = A @ np.swapaxes(A, 1, 2)
    info[0] = np.diag([1.0, 2.0, 0.0, 3.0, 0.0, 1.0])  # semidefinite
    W = psd_sqrt(info)
    np.testing.assert_allclose(W, j_psd_sqrt(info), rtol=0, atol=0)
    np.testing.assert_allclose(np.swapaxes(W, 1, 2) @ W, info, atol=1e-10)
    bad = info.copy()
    bad[3] = -np.eye(6)
    for fn in (psd_sqrt, j_psd_sqrt):
        with pytest.raises(ValueError, match="element 3 .* indefinite"):
            fn(bad)

"""The port's g2o reader, writer and `solve_g2o` vs the JAX package's.

`read_g2o` on the text the JAX package's `write_g2o` writes (SE(3) with
FIX records and EDGE_SE3_PRIOR records, sim(3)), on hand-written SE(2),
mixed and adversarial records, and on gzip / bz2 files: every field
equal to JAX's parse.  The port's writer writes JAX's text, and a round
trip through it restores the graph.  Every refusal raises the JAX
package's message.  `solve_g2o` (spanning-tree init, `prior_ids`, file
priors, a sim(3) file) is held to JAX's at float64 as
tests/test_torch_pgo.py holds `solve_pgo`: verbose lines with `elapsed`
masked, final cost at rtol 1e-9, equal counts and status, poses within
1e-9 of their magnitude.  One parsed graph reaches both packages
through `convert.g2o_graph_to_torch`.
"""

import bz2
import contextlib
import dataclasses
import functools
import gzip
import io

import jax
import numpy as np
import pytest
import torch

import megba_tpu.common as jc
from megba_tpu.factors.sim3 import make_synthetic_sim3_graph
from megba_tpu.io import g2o as jg2o
from megba_tpu.models.pgo import make_synthetic_pose_graph

import megba_tpu_torch as mt
from megba_tpu_torch.convert import g2o_graph_to_torch
from megba_tpu_torch.io import g2o as tg2o

from test_torch_pgo import _compare, _lines

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

_DIAG21 = " ".join("1" if i in (0, 6, 11, 15, 18, 20) else "0"
                   for i in range(21))
_DIAG28 = " ".join("1" if i in (0, 7, 13, 18, 22, 25, 27) else "0"
                   for i in range(28))
_EDGE01 = ("EDGE_SE3:QUAT 0 1 1 0 0 0 0 0 1 1 0 0 0 0 0 1 0 0 0 0 1 0 0 0 "
           "1 0 0 1 0 1\n")
_V0 = "VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1\n"
_S0 = "VERTEX_SIM3:QUAT 0 0 0 0 0 0 0 1 1\n"


def _weights(n, seed, dim=6):
    """Seeded SPD information matrices [n, dim, dim]."""
    a = np.random.default_rng(seed).uniform(-0.3, 0.3, (n, dim, dim))
    return a @ np.swapaxes(a, 1, 2) + np.eye(dim) * 2.0


def _jgraph(kind):
    """A JAX `G2OGraph` of a kind: `se3` (weighted, FIX records),
    `priors` (EDGE_SE3_PRIOR records, no FIX), `sim3` (weighted)."""
    if kind == "sim3":
        s = make_synthetic_sim3_graph(num_poses=12, loop_closures=3,
                                      meas_noise=0.01, seed=4)
        n, n_e = 12, len(s.edge_i)
        return jg2o.G2OGraph(
            poses=s.poses0, edge_i=s.edge_i, edge_j=s.edge_j, meas=s.meas,
            info=_weights(n_e, 1, 7), fixed=np.eye(1, n, 0, dtype=bool)[0],
            ids=np.arange(n, dtype=np.int64) * 3 + 1, sim3=True)
    g = make_synthetic_pose_graph(num_poses=24, loop_closures=5,
                                  meas_noise=0.01, seed=6)
    n, n_e = 24, len(g.edge_i)
    fixed = np.zeros(n, bool)
    fixed[[0, 11]] = True
    graph = jg2o.G2OGraph(
        poses=g.poses0, edge_i=g.edge_i, edge_j=g.edge_j, meas=g.meas,
        info=_weights(n_e, 2), fixed=fixed,
        ids=np.arange(n, dtype=np.int64) + 100)
    if kind == "priors":
        idx = np.array([2, 13], np.int32)
        graph = dataclasses.replace(
            graph, fixed=np.eye(1, n, 0, dtype=bool)[0], had_fix=False,
            prior_idx=idx,
            prior_meas=g.poses_gt[idx] + np.array([0, 0, 0, 0.03, 0, -0.02]),
            prior_info=_weights(2, 3) * 100.0)
    return graph


def _text(kind):
    """The JAX writer's text of a kind."""
    buf = io.StringIO()
    jg2o.write_g2o(buf, _jgraph(kind))
    return buf.getvalue()


_HAND = {
    "se2": ("VERTEX_SE2 0 0 0 0\nVERTEX_SE2 1 1 0 1.5707963\n"
            "VERTEX_SE2 2 1 1 3.1415926\nVERTEX_SE2 3 0 1 -1.5707963\n"
            "EDGE_SE2 0 1 1 0 1.5707963 2 0.1 0 3 0 5\n"
            "EDGE_SE2 1 2 1 0 1.5707963 1 0 0 1 0 1\n"
            "EDGE_SE2 2 3 1 0 1.5707963 1 0 0 1 0 1\n"
            "EDGE_SE2 3 0 1 0 1.5707963 1 0 0 1 0 1\nFIX 0\n"),
    "mixed": (_V0 + "VERTEX_SE2 1 1 0 0.3\nVERTEX_SE3:QUAT 2 2 0 0 0 0 "
              "0.38941834 0.92106099\n" + _EDGE01
              + "EDGE_SE2 1 2 1 0 0.1 1 0 0 1 0 1\n"),
    "unknown_tags": ("VERTEX_TRACKXYZ 99 1 2 3\nVERTEX_SE2 4 0 0 0\n"
                     "VERTEX_SE2 7 1 0 0\nEDGE_SE2 4 7 1 0 0 1 0 0 1 0 1\n"
                     "FIX 99\n"),
    "negative_w": ("VERTEX_SE3:QUAT 0 0 0 0 0 0 0 -1\n"
                   "VERTEX_SE3:QUAT 1 1 0 0 0 0 -0.6 -0.8\n" + _EDGE01),
    "file_prior": (_V0 + "VERTEX_SE3:QUAT 1 1 0 0 0 0 0 1\n"
                   "EDGE_SE3:QUAT 0 1 1.05 0 0 0 0 0 1 " + _DIAG21 + "\n"
                   "EDGE_SE3_PRIOR 0 0.5 0 0 0 0 0 1 " + _DIAG21 + "\n"),
}


def _source(kind):
    return _HAND[kind] if kind in _HAND else _text(kind)


def _assert_graphs_equal(t, j):
    assert type(t) is tg2o.G2OGraph
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, bool):
            assert a is b, f.name
        else:
            np.testing.assert_array_equal(a, b, f.name)
            assert a.dtype == b.dtype, f.name


@pytest.mark.parametrize("kind", ["se3", "priors", "sim3", "se2", "mixed",
                                  "unknown_tags", "negative_w",
                                  "file_prior"])
def test_read_g2o_matches_jax(kind):
    text = _source(kind)
    _assert_graphs_equal(tg2o.read_g2o(io.StringIO(text)),
                         jg2o.read_g2o(io.StringIO(text)))


@pytest.mark.parametrize("suffix,opener", [(".g2o.gz", gzip.open),
                                           (".g2o.bz2", bz2.open),
                                           (".g2o", open)])
def test_read_compressed_files(tmp_path, suffix, opener):
    path = str(tmp_path / f"graph{suffix}")
    with opener(path, "wt") as f:
        f.write(_text("se3"))
    _assert_graphs_equal(tg2o.read_g2o(path), jg2o.read_g2o(path))


@pytest.mark.parametrize("kind", ["se3", "priors", "sim3", "se2"])
def test_write_g2o_matches_jax_and_round_trips(kind):
    """The port's writer writes JAX's text (also with new poses), and
    reading it back restores the graph to the text's 9 digits (the new
    poses move the translations: the rotations stay on the principal
    branch the reader returns)."""
    j = jg2o.read_g2o(io.StringIO(_source(kind)))
    t = g2o_graph_to_torch(j)
    _assert_graphs_equal(t, j)
    new = t.poses.copy()
    new[:, 3:6] += 0.01
    for poses in (None, new):
        tb, jb = io.StringIO(), io.StringIO()
        tg2o.write_g2o(tb, t, poses=poses)
        jg2o.write_g2o(jb, j, poses=poses)
        assert tb.getvalue() == jb.getvalue()
    back = tg2o.read_g2o(io.StringIO(tb.getvalue()))
    np.testing.assert_allclose(back.poses, new, atol=1e-7)
    for f in ("meas", "info", "prior_meas", "prior_info"):
        np.testing.assert_allclose(getattr(back, f), getattr(t, f),
                                   rtol=1e-7, atol=1e-7)
    for f in ("edge_i", "edge_j", "fixed", "ids", "prior_idx"):
        np.testing.assert_array_equal(getattr(back, f), getattr(t, f))


def test_compressed_write(tmp_path):
    t = tg2o.read_g2o(io.StringIO(_text("se3")))
    for suffix in (".gz", ".bz2"):
        path = str(tmp_path / f"out.g2o{suffix}")
        tg2o.write_g2o(path, t)
        _assert_graphs_equal(tg2o.read_g2o(path), jg2o.read_g2o(path))


def test_sqrt_info_of_matches_jax():
    for kind in ("se3", "sim3", "se2"):
        j = jg2o.read_g2o(io.StringIO(_source(kind)))
        np.testing.assert_array_equal(
            tg2o.sqrt_info_of(g2o_graph_to_torch(j)), jg2o.sqrt_info_of(j))
    g = _jgraph("se3")
    buf = io.StringIO()
    jg2o.write_g2o(buf, dataclasses.replace(g, info=np.tile(
        np.eye(6), (g.edge_i.shape[0], 1, 1))))
    unit = tg2o.read_g2o(io.StringIO(buf.getvalue()))
    assert tg2o.sqrt_info_of(unit) is None


_REFUSED = {
    "vertex_count": "VERTEX_SE3:QUAT 5 1.0 2.0\n",
    "edge_count": _V0 + "EDGE_SE3:QUAT 0 0 1 2 3\n",
    "se2_unknown_vertex": ("VERTEX_SE2 0 0 0 0\n"
                           "EDGE_SE2 0 7 1 0 0 1 0 0 1 0 1\n"),
    "no_vertex": "# empty\nUNKNOWN_TAG 1 2 3\n",
    "duplicate": _V0 + "VERTEX_SE3:QUAT 0 1 0 0 0 0 0 1\n",
    "duplicate_cross_kind": ("VERTEX_SE3:QUAT 3 0 0 0 0 0 0 1\n"
                             "VERTEX_SE2 3 1 0 0.5\n"),
    "bare_tag": "VERTEX_SE3:QUAT\n",
    "bare_edge": "EDGE_SE3:QUAT 0\n",
    "se2_vertex_count": "VERTEX_SE2 0 0 0\n",
    "se2_edge_count": "VERTEX_SE2 0 0 0 0\nEDGE_SE2 0 0 1 2\n",
    "vertex_nonfinite": "VERTEX_SE3:QUAT 0 nan 0 0 0 0 0 1\n",
    "edge_nonfinite": (_V0 + "VERTEX_SE3:QUAT 1 1 0 0 0 0 0 1\n"
                       + _EDGE01.replace(" 1 0 0 0 0 0 1 1", " inf 0 0 0 0 0 "
                                         "1 1", 1)),
    "prior_count": _V0 + "EDGE_SE3_PRIOR 0 1 2 3\n",
    "prior_params": (_V0 + "EDGE_SE3_PRIOR 0 99 0 0 0 0 0 0 1 " + _DIAG21
                     + "\n"),
    "prior_unknown": _V0 + "EDGE_SE3_PRIOR 7 0 0 0 0 0 0 1 " + _DIAG21 + "\n",
    "prior_nonfinite": (_V0 + "EDGE_SE3_PRIOR 0 nan 0 0 0 0 0 1 " + _DIAG21
                        + "\n"),
    "sim3_vertex_count": "VERTEX_SIM3:QUAT 0 0 0 0 0 0 0 1\n",
    "sim3_edge_count": _S0 + "EDGE_SIM3:QUAT 0 0 1 2 3\n",
    "sim3_vertex_scale": "VERTEX_SIM3:QUAT 0 0 0 0 0 0 0 1 -2\n",
    "sim3_edge_scale": (_S0 + "VERTEX_SIM3:QUAT 1 0 0 0 0 0 0 1 1\n"
                        "EDGE_SIM3:QUAT 0 1 0 0 0 0 0 0 1 0 " + _DIAG28
                        + "\n"),
    "sim3_duplicate": _S0 + _S0,
    "sim3_unknown": (_S0 + "EDGE_SIM3:QUAT 0 9 1 0 0 0 0 0 1 1 " + _DIAG28
                     + "\n"),
    "sim3_nonfinite": "VERTEX_SIM3:QUAT 0 0 0 inf 0 0 0 1 1\n",
    "mix_se3_then_sim3": _V0 + "VERTEX_SIM3:QUAT 1 0 0 0 0 0 0 1 1\n",
    "mix_sim3_then_se2": _S0 + "VERTEX_SE2 1 0 0 0\n",
    "mix_sim3_then_prior": (_S0 + "EDGE_SE3_PRIOR 0 0 0 0 0 0 0 1 "
                            + _DIAG21 + "\n"),
}


def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


@pytest.mark.parametrize("kind", list(_REFUSED))
def test_read_refusals_match_jax(kind):
    text = _REFUSED[kind]
    assert (_message(tg2o.read_g2o, io.StringIO(text))
            == _message(jg2o.read_g2o, io.StringIO(text)))


def _options(lm_cap=4):
    """(JAX, port) f64 options with an LM cap before the cost floor."""
    return tuple(pkg.ProblemOption(
        dtype=np.float64,
        algo_option=pkg.AlgoOption(max_iter=lm_cap, epsilon1=1e-12,
                                   epsilon2=1e-15),
        solver_option=pkg.SolverOption(max_iter=60, tol=1e-12,
                                       refuse_ratio=1e30))
        for pkg in (jc, mt))


def test_solve_g2o_refusals_match_jax():
    jopt, topt = _options()
    sim3 = jg2o.read_g2o(io.StringIO(_text("sim3")))
    se3 = jg2o.read_g2o(io.StringIO(_text("se3")))
    for graph, kw in ((sim3, dict(prior_ids=[1])),
                      (sim3, dict(init="spanning_tree")),
                      (sim3, dict(init="odometry")),
                      (se3, dict(init="odometry")),
                      (se3, dict(prior_ids=[999]))):
        assert (_message(tg2o.solve_g2o, g2o_graph_to_torch(graph), topt,
                         device="cpu", **kw)
                == _message(jg2o.solve_g2o, graph, jopt, **kw))


# The solve cases: (the graph's kind, solve_g2o's keywords).  prior_ids
# and the file priors add two priors each to a graph of one size, so the
# two share one JAX program.
_SOLVES = {
    "spanning_tree": ("se3", dict(init="spanning_tree")),
    "prior_ids": ("priors_free", dict(prior_ids=[105, 118],
                                      prior_weight=1e2)),
    "file_priors": ("priors", {}),
    "sim3": ("sim3", {}),
}


def _solve_graph(kind):
    if kind == "priors_free":  # no FIX records, no file priors
        j = jg2o.read_g2o(io.StringIO(_text("se3")))
        return dataclasses.replace(
            j, fixed=np.eye(1, j.poses.shape[0], 0, dtype=bool)[0],
            had_fix=False)
    return jg2o.read_g2o(io.StringIO(_text(kind)))


@functools.lru_cache(maxsize=None)
def _jax_solve(case):
    kind, kw = _SOLVES[case]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        graph, res = jg2o.solve_g2o(_solve_graph(kind), _options()[0],
                                    verbose=True, **kw)
        jax.block_until_ready(res.cost)
        jax.effects_barrier()
    return graph, res, _lines(buf.getvalue())


@pytest.mark.parametrize("case", list(_SOLVES))
def test_solve_g2o_matches_jax(case, capsys):
    kind, kw = _SOLVES[case]
    j_graph, j_res, j_lines = _jax_solve(case)
    capsys.readouterr()
    t_graph, t_res = tg2o.solve_g2o(g2o_graph_to_torch(_solve_graph(kind)),
                                    _options()[1], verbose=True,
                                    device="cpu", **kw)
    t_lines = _lines(capsys.readouterr().out)
    assert t_res.accepted >= 1
    _compare(t_res, t_lines, j_res, j_lines)
    assert t_res.poses.shape[0] == j_graph.poses.shape[0]
    _assert_graphs_equal(t_graph, j_graph)


def test_solve_g2o_from_a_path_is_solve_pgo(tmp_path):
    """A file with EDGE_SE3_PRIOR records through solve_g2o equals
    with_priors + solve_pgo on its arrays, bitwise, and the top-level
    export is the module's."""
    from megba_tpu_torch.core.linalg import psd_sqrt
    from megba_tpu_torch.models.pgo import solve_pgo, with_priors

    path = str(tmp_path / "priors.g2o")
    with open(path, "w") as f:
        f.write(_text("priors"))
    _, topt = _options(lm_cap=3)
    graph, res = mt.solve_g2o(path, topt, device="cpu")
    n = graph.poses.shape[0]
    args = with_priors(graph.poses, graph.edge_i, graph.edge_j, graph.meas,
                       prior_idx=graph.prior_idx,
                       prior_poses=graph.prior_meas,
                       prior_sqrt_info=psd_sqrt(graph.prior_info),
                       fixed=np.zeros(n, bool),
                       sqrt_info=tg2o.sqrt_info_of(graph))
    ref = solve_pgo(*args[:4], topt, sqrt_info=args[5], fixed=args[4],
                    device="cpu")
    assert float(res.cost) == float(ref.cost)
    assert bool((res.poses == ref.poses[:n]).all())
    assert (res.iterations, res.accepted, res.pcg_iterations) == (
        ref.iterations, ref.accepted, ref.pcg_iterations)

"""The port's chunked drivers (algo/checkpointed.py) vs the JAX package's.

On the scenes of tests/test_checkpointed.py (6 cameras, 40 points; a
64-pose graph for the pose-graph driver) at float64, with the parity
options of tests/test_torch_guards.py (8 LM iterations, 30 PCG at tol
1e-10), in chunks of 4:

- `solve_checkpointed` against JAX's `solve_checkpointed`
  (`use_tiled=False`): stitched trial costs at rtol 1e-9, equal accept
  pattern, LM / accepted / PCG counts and status; against the port's own
  straight `flat_solve` (equal counts, trial costs at rtol 1e-12);
- a partial snapshot (after the first chunk) written by the port or by
  JAX, resumed by the port, equal to JAX's full run; the port's also
  resumed by JAX to its full run;
- the whole-run aggregates, and a finished snapshot resumed without new
  iterations;
- a foreign snapshot refused, `checkpoint_every` validated, an
  `elastic=` that is neither an ElasticConfig nor an ElasticMonitor
  refused with JAX's TypeError;
- a NaN burst whose window spans the chunk boundary, under guards,
  against JAX (trial costs NaN at the same iterations, the recovery
  trace, recoveries and status);
- `solve_pgo_checkpointed` against JAX's, straight and resumed (the
  verbose lines' trial costs at rtol 1e-9, equal counts and status).

CPU only.  The JAX references are cached: each compiles its programs
once.
"""

import contextlib
import functools
import io
import re

import numpy as np
import pytest
import torch

import megba_tpu.common as jc
from megba_tpu.algo.checkpointed import (
    solve_checkpointed as j_solve_checkpointed,
    solve_pgo_checkpointed as j_solve_pgo_checkpointed,
)
from megba_tpu.ops.residuals import make_residual_jacobian_fn as j_engine
from megba_tpu.robustness import faults as jfaults

import megba_tpu_torch as mt
from megba_tpu_torch.convert import fault_plan_to_torch, result_to_numpy
from megba_tpu_torch.models import pgo as tpgo
from megba_tpu_torch.utils.checkpoint import load_state

from test_torch_guards import _options, compare_robust
from test_torch_solve import _compare

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

EVERY = 4
_COST = re.compile(r"^iter \d+: cost (\S+) ")


def _scene(seed):
    return mt.make_synthetic_bal(num_cameras=6, num_points=40,
                                 obs_per_point=4, seed=seed,
                                 param_noise=4e-2, pixel_noise=0.3)


def _args(s):
    return (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)


def _jax_run(seed, path, guards=False, max_iter=8, fault=None):
    jopt, _ = _options(guards, max_iter=max_iter)
    kw = {} if fault is None else dict(fault_plan=fault)
    return j_solve_checkpointed(
        j_engine(mode=jc.JacobianMode.ANALYTICAL), *_args(_scene(seed)),
        jopt, checkpoint_path=str(path), checkpoint_every=EVERY,
        use_tiled=False, **kw)


def _port_run(seed, path, guards=False, max_iter=8, **kw):
    _, topt = _options(guards, max_iter=max_iter)
    return mt.solve_checkpointed(None,
        *_args(_scene(seed)), topt, checkpoint_path=str(path),
        checkpoint_every=EVERY, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _jax_full(seed, tmp):
    return _jax_run(seed, f"{tmp}/jax_full_{seed}.npz")


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("checkpointed"))


@pytest.mark.parametrize("seed", [0, 1])
def test_chunked_matches_jax_and_straight(seed, tmp):
    tres = _port_run(seed, f"{tmp}/port_{seed}.npz")
    _compare(_jax_full(seed, tmp), tres, cost_rtol=1e-9)
    st = load_state(f"{tmp}/port_{seed}.npz")
    assert int(st["iteration"]) == tres.iterations
    assert "extra_v" in st and "extra_trace_cost" in st
    # The chunk boundary relinearises at the carried parameters: the
    # chunked trajectory is the straight one.
    _, topt = _options(False)
    straight = result_to_numpy(mt.flat_solve(None, *_args(_scene(seed)), topt,
                                             device="cpu"))
    t = result_to_numpy(tres)
    for key in ("iterations", "accepted", "pcg_iterations", "status"):
        assert t[key] == straight[key], key
    np.testing.assert_array_equal(t["trace"]["accept"],
                                  straight["trace"]["accept"])
    np.testing.assert_allclose(t["trace"]["cost"], straight["trace"]["cost"],
                               rtol=1e-12)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_partial_snapshot_resumes_to_the_full_run(writer, tmp_path, tmp):
    """A snapshot after the first chunk, written by either package,
    finishes in the port to JAX's full run; written by the port, it also
    finishes in JAX to JAX's full run."""
    seed = 1
    path = tmp_path / "partial.npz"
    (_port_run if writer == "port" else _jax_run)(seed, path,
                                                  max_iter=EVERY)
    assert int(load_state(str(path))["iteration"]) == EVERY
    full = _jax_full(seed, tmp)
    if writer == "port":
        jpath = tmp_path / "partial_for_jax.npz"
        jpath.write_bytes(path.read_bytes())
        jres = _jax_run(seed, jpath)
        assert (int(jres.iterations), int(jres.accepted),
                int(jres.pcg_iterations)) == (
            int(full.iterations), int(full.accepted),
            int(full.pcg_iterations))
        np.testing.assert_allclose(np.asarray(jres.trace.cost),
                                   np.asarray(full.trace.cost), rtol=1e-9)
    _compare(full, _port_run(seed, path), cost_rtol=1e-9)


def test_aggregates_and_finished_snapshot(tmp_path):
    seed = 2
    path = tmp_path / "agg.npz"
    first = _port_run(seed, path, max_iter=EVERY)
    full = _port_run(seed, path)
    _, topt = _options(False)
    straight = mt.flat_solve(None, *_args(_scene(seed)), topt, device="cpu")
    assert (full.iterations, full.accepted, full.pcg_iterations) == (
        straight.iterations, straight.accepted, straight.pcg_iterations)
    # The initial cost is the first chunk's, not the resume point's.
    assert float(full.initial_cost) == float(first.initial_cost)
    np.testing.assert_allclose(float(full.initial_cost),
                               float(straight.initial_cost), rtol=1e-12)
    # A finished snapshot resumes without new LM iterations: a 0-iteration
    # evaluate at the saved parameters, the whole-run aggregates kept.
    done = int(load_state(str(path))["iteration"])
    again = _port_run(seed, path)
    assert int(load_state(str(path))["iteration"]) == done
    assert (again.iterations, again.accepted, again.pcg_iterations) == (
        full.iterations, full.accepted, full.pcg_iterations)
    assert again.status == full.status
    assert again.trace.cost.shape[0] == done
    np.testing.assert_allclose(float(again.cost), float(full.cost),
                               rtol=1e-10)


def test_foreign_snapshot_refused(tmp_path):
    path = str(tmp_path / "run.npz")
    _port_run(2, path, max_iter=EVERY)
    with pytest.raises(ValueError, match="different problem"):
        _port_run(3, path)
    # A snapshot with no fingerprint is refused too.
    st = load_state(path)
    st.pop("extra_topology")
    np.savez(path, **st)
    with pytest.raises(ValueError, match="different problem"):
        _port_run(2, path)


def test_checkpoint_every_and_elastic_validated(tmp_path):
    _, topt = _options(False)
    args = _args(_scene(0))
    with pytest.raises(ValueError, match="checkpoint_every"):
        mt.solve_checkpointed(None, *args, topt,
                              checkpoint_path=str(tmp_path / "x.npz"),
                              checkpoint_every=0, device="cpu")
    with pytest.raises(TypeError, match="ElasticConfig or ElasticMonitor"):
        mt.solve_checkpointed(None, *args, topt,
                              checkpoint_path=str(tmp_path / "x.npz"),
                              elastic=object(), device="cpu")
    with pytest.raises(TypeError, match="ElasticConfig or ElasticMonitor"):
        mt.solve_pgo_checkpointed(np.zeros((2, 6)), [0], [1],
                                  np.zeros((1, 6)), topt,
                                  checkpoint_path=str(tmp_path / "y.npz"),
                                  elastic=object(), device="cpu")
    assert not (tmp_path / "x.npz").exists()


def test_nan_burst_across_chunk_boundary_matches_jax(tmp_path):
    """Iterations 3 and 4 poisoned: the window spans the boundary at 4,
    so the second chunk's fault plan is re-offset (with_offset)."""
    seed = 0
    n = _scene(seed).obs.shape[0]
    plan = jfaults.make_nan_burst(n, [2, 9], start=3, stop=5)
    jres = _jax_run(seed, tmp_path / "j.npz", guards=True, fault=plan)
    tres = _port_run(seed, tmp_path / "t.npz", guards=True,
                     fault_plan=fault_plan_to_torch(plan))
    t = compare_robust(jres, tres)
    assert tres.status == mt.SolveStatus.RECOVERED and tres.recoveries >= 1
    assert t["trace"]["recovery"][3:5].any()
    assert not t["trace"]["recovery"][:3].any()


# ---------------------------------------------------------- pose graphs

PGO_LM = 4
PGO_EVERY = 2


def _pgo_graph():
    return tpgo.make_synthetic_pose_graph(64, 10, meas_noise=0.01, seed=3)


def _pgo_options(max_iter=PGO_LM):
    out = []
    for pkg in (jc, mt):
        out.append(pkg.ProblemOption(
            dtype=np.float64,
            algo_option=pkg.AlgoOption(max_iter=max_iter, epsilon1=1e-12,
                                       epsilon2=1e-15),
            solver_option=pkg.SolverOption(max_iter=60, tol=1e-12,
                                           refuse_ratio=1e30)))
    return out


def _trial_costs(text):
    return np.array([float(m.group(1)) for m in map(_COST.match,
                                                    text.splitlines()) if m])


def _pgo_run(solver, option, path):
    g = _pgo_graph()
    kw = {"device": "cpu"} if solver is mt.solve_pgo_checkpointed else {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = solver(g.poses0, g.edge_i, g.edge_j, g.meas, option,
                     checkpoint_path=str(path), checkpoint_every=PGO_EVERY,
                     verbose=True, **kw)
    return res, _trial_costs(buf.getvalue())


@pytest.mark.parametrize("resumed", [False, True], ids=["straight",
                                                        "resumed"])
def test_pgo_checkpointed_matches_jax(resumed, tmp_path):
    jopt, topt = _pgo_options()
    jres, jcost = _pgo_run(j_solve_pgo_checkpointed, jopt,
                           tmp_path / "j.npz")
    tcost_head = np.zeros(0)
    if resumed:
        _, tcost_head = _pgo_run(mt.solve_pgo_checkpointed,
                                 _pgo_options(PGO_EVERY)[1],
                                 tmp_path / "t.npz")
        assert int(load_state(str(tmp_path / "t.npz"))["iteration"]) \
            == PGO_EVERY
    tres, tcost = _pgo_run(mt.solve_pgo_checkpointed, topt,
                           tmp_path / "t.npz")
    assert (tres.iterations, tres.accepted, tres.pcg_iterations,
            tres.status) == (int(jres.iterations), int(jres.accepted),
                             int(jres.pcg_iterations), int(jres.status))
    np.testing.assert_allclose(np.concatenate([tcost_head, tcost]), jcost,
                               rtol=1e-9)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost),
                               rtol=1e-9)
    np.testing.assert_allclose(float(tres.initial_cost),
                               float(jres.initial_cost), rtol=1e-9)
    assert tres.accepted >= 1

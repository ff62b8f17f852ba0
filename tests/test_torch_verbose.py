"""The port's verbose line against the JAX package's.

`flat_solve(..., verbose=True)` prints one line per LM iteration in both
packages; the JAX package's format is a contract
(megba_tpu/observability/emit.py, parsed by megba_tpu/utils/curves.py):
`iter k: cost C log10 L accept A pcg_iters P elapsed T ms`.  One verbose
solve of each package on the same seed, float64 (the conftest enables
x64 for JAX), must print the same lines with the elapsed field masked.
Iteration 0 prints `elapsed 0.0 ms` in both host loops, `solve_bal`'s
problem-stats line is JAX's byte for byte, and no `coarse plan:` line is
printed.
"""

import re

import jax
import numpy as np
import pytest

import megba_tpu.common as jc
from megba_tpu.ops.residuals import make_residual_jacobian_fn
from megba_tpu.solve import flat_solve as j_flat_solve
from megba_tpu.utils.curves import parse_verbose_curve

import megba_tpu_torch as mt

_ELAPSED = re.compile(r"elapsed [0-9.]+ ms")
_COST_LOG10 = re.compile(r"cost (\S+) log10 (\S+) ")


def _lines(text):
    return [_ELAPSED.sub("elapsed <t> ms", ln)
            for ln in text.splitlines() if ln.startswith("iter ")]


def test_verbose_lines_match_jax(capsys):
    s = mt.make_synthetic_bal(num_cameras=6, num_points=60,
                              obs_per_point=3, seed=4, param_noise=1e-2,
                              pixel_noise=0.5)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    kw = dict(max_iter=4, epsilon1=1e-12, epsilon2=1e-15)
    capsys.readouterr()
    jres = j_flat_solve(
        make_residual_jacobian_fn(mode=jc.JacobianMode.ANALYTICAL), *args,
        jc.ProblemOption(jacobian_mode=jc.JacobianMode.ANALYTICAL,
                         algo_option=jc.AlgoOption(**kw)), verbose=True)
    jax.block_until_ready(jres.cost)
    jax.effects_barrier()
    want = _lines(capsys.readouterr().out)
    mt.flat_solve(*args, mt.ProblemOption(
        jacobian_mode=mt.JacobianMode.ANALYTICAL,
        algo_option=mt.AlgoOption(**kw)), device="cpu", verbose=True)
    got = _lines(capsys.readouterr().out)
    assert len(want) == int(jres.iterations) >= 2
    assert got == want
    # The JAX package's parser reads every line.
    assert len(parse_verbose_curve("\n".join(got))) == len(got)
    for ln in got:
        cost, log10 = map(float, _COST_LOG10.search(ln).groups())
        assert abs(log10 - np.log10(cost)) <= 1e-3


# ---------------------------------------------------------------------------
# solve_bal's problem-stats line, iteration 0's clock, the verbose clocks
# ---------------------------------------------------------------------------


class _Stop(Exception):
    pass


def _jax_stats_line(monkeypatch, capsys, bal):
    """JAX `solve_bal(verbose=True)`'s output up to its solve: the
    problem-stats line is printed before `flat_solve`, which is stubbed
    out here (no program is compiled)."""
    import megba_tpu.solve as jsolve

    def stop(*args, **kwargs):
        raise _Stop

    monkeypatch.setattr(jsolve, "flat_solve", stop)
    capsys.readouterr()
    with pytest.raises(_Stop):
        jsolve.solve_bal(bal, verbose=True)
    return capsys.readouterr().out


@pytest.mark.parametrize("order", ["camera_sorted", "shuffled"])
def test_solve_bal_stats_line_matches_jax(order, monkeypatch, capsys):
    from megba_tpu.io.bal import BALFile as JBALFile

    s = mt.make_synthetic_bal(num_cameras=5, num_points=40,
                              obs_per_point=3, seed=1)
    perm = np.arange(s.obs.shape[0])
    if order == "shuffled":
        perm = np.random.default_rng(0).permutation(perm)
    arrays = (s.cameras0, s.points0, s.obs[perm], s.cam_idx[perm],
              s.pt_idx[perm])
    want = _jax_stats_line(monkeypatch, capsys, JBALFile(*arrays))
    mt.solve_bal(mt.BALFile(*arrays), mt.ProblemOption(
        algo_option=mt.AlgoOption(max_iter=1)), verbose=True, device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert want.endswith("\n") and got[0] == want[:-1]
    assert want.startswith("problem: 5 cameras, 40 points, 120 observations")
    if order == "shuffled":
        assert want.endswith("Hpl blocks n/a (edges unsorted)\n")
    else:
        assert want.endswith("Hpl blocks 120\n")


def test_iteration_zero_elapsed_is_zero(capsys):
    """Both host loops start their clock at iteration 0's line, as the
    JAX package's emit does."""
    from megba_tpu_torch.models import pgo as tpgo

    s = mt.make_synthetic_bal(num_cameras=4, num_points=30,
                              obs_per_point=3, seed=2, param_noise=1e-2)
    algo = mt.AlgoOption(max_iter=2, epsilon1=1e-12, epsilon2=1e-15)
    capsys.readouterr()
    mt.flat_solve(s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
                  mt.ProblemOption(algo_option=algo), device="cpu",
                  verbose=True)
    ba = [ln for ln in capsys.readouterr().out.splitlines()
          if ln.startswith("iter ")]
    g = tpgo.make_synthetic_pose_graph(num_poses=16, loop_closures=3,
                                       seed=0)
    tpgo.solve_pgo(g.poses0, g.edge_i, g.edge_j, g.meas,
                   mt.ProblemOption(algo_option=algo), verbose=True,
                   device="cpu")
    pg = [ln for ln in capsys.readouterr().out.splitlines()
          if ln.startswith("iter ")]
    for lines in (ba, pg):
        assert len(lines) == 2
        assert lines[0].startswith("iter 0: ")
        assert lines[0].endswith(" elapsed 0.0 ms")


def test_no_coarse_plan_line_on_two_level(capsys):
    """JAX prints no `coarse plan:` line; its seconds stay on the result
    and on the timer's "coarse_plan" phase."""
    s = mt.make_synthetic_bal(num_cameras=6, num_points=60,
                              obs_per_point=3, seed=3, param_noise=1e-2)
    from megba_tpu_torch.utils.timing import PhaseTimer

    timer = PhaseTimer()
    capsys.readouterr()
    res = mt.flat_solve(
        s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
        mt.ProblemOption(algo_option=mt.AlgoOption(max_iter=1),
                         solver_option=mt.SolverOption(
                             precond=mt.PrecondKind.TWO_LEVEL,
                             coarse_clusters=2)),
        device="cpu", verbose=True, timer=timer)
    out = capsys.readouterr().out
    assert "coarse plan" not in out
    assert [ln for ln in out.splitlines() if ln.startswith("iter ")]
    assert res.coarse_plan_seconds is not None
    assert timer.counts["coarse_plan"] == 1
    assert timer.totals["coarse_plan"] >= res.coarse_plan_seconds


def test_verbose_clock_evicts_by_last_touch(capsys):
    """The JAX package's regression (tests/test_observability.py): a long
    solve that keeps printing keeps its clock through a burst of more than
    `_MAX_CLOCKS` short ones."""
    from megba_tpu_torch.observability import emit

    saved = dict(emit._VERBOSE_CLOCKS)
    try:
        emit._VERBOSE_CLOCKS.clear()
        emit._emit_verbose_line(1, 0, 1.0, True, 3)  # the long solve
        t0 = emit._VERBOSE_CLOCKS[1][0]
        for i in range(2 * emit._MAX_CLOCKS):
            emit._emit_verbose_line(1000 + i, 0, 1.0, True, 1)  # burst
            emit._emit_verbose_line(1, i + 1, 0.5, True, 1)  # still live
        assert 1 in emit._VERBOSE_CLOCKS, "live solve's clock evicted"
        assert emit._VERBOSE_CLOCKS[1][0] == t0, "clock restarted"
        assert len(emit._VERBOSE_CLOCKS) <= emit._MAX_CLOCKS + 1
    finally:
        emit._VERBOSE_CLOCKS.clear()
        emit._VERBOSE_CLOCKS.update(saved)
        capsys.readouterr()


@pytest.mark.parametrize("args", [(49, 7776, 31843, 12, 9, 1234),
                                  (1, 2, 3, 4, 5, -1)])
def test_emit_problem_stats_matches_jax(args, capsys):
    from megba_tpu.observability.emit import emit_problem_stats as j_stats

    from megba_tpu_torch.observability.emit import emit_problem_stats

    capsys.readouterr()
    j_stats(*args)
    want = capsys.readouterr().out
    emit_problem_stats(*args)
    assert capsys.readouterr().out == want

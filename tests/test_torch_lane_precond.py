"""The lane-batched fleet's preconditioners and plain full-system solver
against the JAX package.

- `solve_many` with SCHUR_DIAG on IMPLICIT and EXPLICIT, NEUMANN (order
  2) on IMPLICIT and `use_schur=False` on IMPLICIT and EXPLICIT, at
  float64, against the JAX package's `solve_many` with the same option on
  `test_torch_lane_options`' six problems, LM-capped before the cost
  floor: trial costs at rtol 1e-9, equal accepts, PCG counts, status and
  `precond_fallback` traces, cameras within the lane tests' tolerance;
- SCHUR_DIAG under guards with the Hll blocks of one lane's points
  crushed for one iteration (`make_point_indefinite_burst`): that lane's
  Schur diagonal goes indefinite, its camera blocks fall back to the Hpp
  inverse and the counts ride its `precond_fallback` trace as in JAX,
  its batch-mates' traces stay zero;
- each option's lanes bitwise alone, batched in 4 lanes and in 8.

Each JAX reference compiles one vmapped program (12-16 s), once per
module (`lru_cache`).
"""

import dataclasses
import functools

import numpy as np
import pytest

import megba_tpu.serving as js
from megba_tpu.common import RobustOption as JRobustOption
from megba_tpu.robustness import faults as jfaults

import megba_tpu_torch.serving as ts
from megba_tpu_torch.common import RobustOption
from megba_tpu_torch.convert import fault_plan_to_torch
from megba_tpu_torch.serving.compile_pool import reset_process_cache
from test_torch_lane_options import LM_CAP, _fleet, _to_jax
from test_torch_lane_rungs import (
    check_lanes_bitwise,
    compare_fleets,
    jax_option,
    port_option,
)

# name -> (compute kind, fused_kernels, ProblemOption fields, SolverOption
# fields, AlgoOption fields), as test_torch_lane_rungs' cases.
SD = dict(preconditioner="SCHUR_DIAG")
CAP = dict(max_iter=LM_CAP)
CASES = {
    "schur_diag_implicit": ("IMPLICIT", False, {}, SD, CAP),
    "schur_diag_explicit": ("EXPLICIT", False, {}, SD, CAP),
    "neumann_implicit": ("IMPLICIT", False, {},
                         dict(precond="NEUMANN", neumann_order=2), CAP),
    "plain_implicit": ("IMPLICIT", False, dict(use_schur=False), {}, CAP),
    "plain_explicit": ("EXPLICIT", False, dict(use_schur=False), {}, CAP),
}


def _opt(name):
    return port_option(CASES[name])


def _jopt(name):
    return jax_option(CASES[name])


@functools.lru_cache(maxsize=None)
def _port_run(name):
    return ts.solve_many(_fleet(), _opt(name))


@pytest.mark.parametrize("name", list(CASES))
def test_solve_many_matches_jax(name):
    got = _port_run(name)
    want = js.solve_many([_to_jax(p) for p in _fleet()], _jopt(name))
    compare_fleets(got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_lanes_bitwise_alone_and_batched(name):
    check_lanes_bitwise(_opt(name), _port_run(name))


def test_each_option_gets_its_own_program():
    """The compile pool keys every option field: each case and IMPLICIT
    build a bucket program of their own."""
    from megba_tpu_torch.factors import engine_for
    from megba_tpu_torch.serving import BucketLadder, FleetStats, classify
    from megba_tpu_torch.serving.compile_pool import CompilePool

    p = _fleet()[0]
    opts = [port_option(("IMPLICIT", False, {}, {}, CAP))] + [
        _opt(name) for name in CASES]
    engine = engine_for("bal", opts[0].jacobian_mode)
    shape = classify(*p.dims(), np.float64, BucketLadder())
    reset_process_cache()
    stats = FleetStats()
    pool = CompilePool(stats=stats)
    for o in opts:
        pool.program(engine, o, shape, 8, 9, 3, 2, device="cpu")
    assert stats.pool_misses == len(opts) and stats.pool_hits == 0
    assert len(pool.entries()) == len(opts)


CRUSHED_LANE = 2


def _crush(p, jax_side: bool):
    plan = jfaults.make_point_indefinite_burst(
        p.points.shape[0], list(range(8)), start=1, stop=2,
        n_edges=p.obs.shape[0], dtype=np.float64)
    return plan if jax_side else fault_plan_to_torch(plan)


def test_schur_diag_fallback_trace_under_crush_matches_jax():
    probs = _fleet()
    opt = dataclasses.replace(_opt("schur_diag_implicit"),
                              robust_option=RobustOption(guards=True))
    jo = dataclasses.replace(_jopt("schur_diag_implicit"),
                             robust_option=JRobustOption(guards=True))
    port = [dataclasses.replace(p, fault_plan=_crush(p, False))
            if i == CRUSHED_LANE else p for i, p in enumerate(probs)]
    jax_probs = [_to_jax(p) for p in probs]
    jax_probs[CRUSHED_LANE] = dataclasses.replace(
        jax_probs[CRUSHED_LANE], fault_plan=_crush(probs[CRUSHED_LANE], True))
    got = ts.solve_many(port, opt)
    compare_fleets(got, js.solve_many(jax_probs, jo))
    fallback = [int(r.trace.precond_fallback.sum()) for r in got]
    assert fallback[CRUSHED_LANE] >= 1
    assert sum(fallback) == fallback[CRUSHED_LANE]
    # The crushed lane alone is its lane of the batch.
    alone = ts.solve_many([port[CRUSHED_LANE]], opt)[0]
    assert alone.lanes == 1
    assert torch_equal(alone.trace.precond_fallback,
                       got[CRUSHED_LANE].trace.precond_fallback)
    assert alone.cost.tobytes() == got[CRUSHED_LANE].cost.tobytes()


def torch_equal(a, b) -> bool:
    return a.numpy().tobytes() == b.numpy().tobytes()

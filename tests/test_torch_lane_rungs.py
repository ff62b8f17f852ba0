"""The lane-batched fleet's precision rungs against the JAX package, and
the coarse preconditioners' refusal.

- `solve_many` with `mixed_precision_pcg` on IMPLICIT and fused EXPLICIT
  at float64 against the JAX package's `solve_many` with the same option
  on `test_torch_lane_options`' six problems, LM-capped before the cost
  floor and started from trust region 1 (mixed at f64 from the default
  region is chaotic: ROADMAP, the mixed-f64 sensitivity): trial costs at
  rtol 1e-9, equal accepts, PCG counts, status and `precond_fallback`
  traces, cameras within the lane tests' tolerance.  JAX's bucket
  program runs `fused_kernels` on its unfused XLA path;
- `bf16` at float32 on IMPLICIT and fused IMPLICIT, run towards
  convergence (20 LM iterations, PCG tolerance 1e-6 of the RHS energy,
  floored at 1e-3 on the rung): the final cost within the JAX package's
  bf16 band (2e-2) of JAX's `solve_many` compiled without XLA's excess
  precision (its default keeps bf16 products at f32) and of the port's
  own f32 fleet.  Not tighter: on these small noisy problems the rung's
  trajectory turns on its bf16 rounding, and JAX's strict and default
  compiles of the same fleet part by more than 1e-3 in final cost;
- each rung's lanes bitwise alone, batched in 4 lanes and in 8;
- TWO_LEVEL / MULTILEVEL raise JAX's `ValueError`, word for word, from
  `solve_many` and from a `FleetQueue` future (the queue constructs).

Each JAX reference compiles one vmapped program (12-16 s), once per
module (`lru_cache`).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

import megba_tpu.serving as js
import megba_tpu.serving.compile_pool as j_pool
from megba_tpu.common import (
    AlgoOption as JAlgoOption,
    ComputeKind as JComputeKind,
    PrecondKind as JPrecondKind,
    PreconditionerKind as JPreconditionerKind,
    ProblemOption as JProblemOption,
    SolverOption as JSolverOption,
)

import megba_tpu_torch.serving as ts
from megba_tpu_torch.common import (
    AlgoOption,
    ComputeKind,
    Device,
    PrecondKind,
    PreconditionerKind,
    ProblemOption,
    SolverOption,
)
from test_torch_lane_options import LM_CAP, _bits, _fleet, _to_jax

# name -> (compute kind, fused_kernels, ProblemOption fields, SolverOption
# fields, AlgoOption fields); enums by name.
MIXED_ALGO = dict(max_iter=LM_CAP, initial_region=1.0)
MIXED = {
    "mixed_implicit": ("IMPLICIT", False, dict(mixed_precision_pcg=True),
                       {}, MIXED_ALGO),
    "mixed_fused_explicit": ("EXPLICIT", True,
                             dict(mixed_precision_pcg=True), {}, MIXED_ALGO),
}
# bf16 runs towards convergence: its final costs are compared.
BF16_SOLVER = dict(bf16=True, tol=1e-6, tol_relative=True)
BF16_ALGO = dict(max_iter=20)
BF16 = {
    "bf16_implicit": ("IMPLICIT", False, {}, BF16_SOLVER, BF16_ALGO),
    "bf16_fused_implicit": ("IMPLICIT", True, {}, BF16_SOLVER, BF16_ALGO),
}
BF16_BAND = 2e-2  # the JAX package's bf16 band (tests/test_bf16.py)


def _solver_fields(solver, precond_kind, preconditioner_kind):
    return {k: (preconditioner_kind[v] if k == "preconditioner"
                else precond_kind[v] if k == "precond" else v)
            for k, v in solver.items()}


def port_option(case, dtype=np.float64, bf16=True):
    """The port's option of `case`; `bf16=False` drops the rung."""
    kind, fk, top, solver, algo = case
    solver = _solver_fields({k: v for k, v in solver.items()
                             if bf16 or k != "bf16"},
                            PrecondKind, PreconditionerKind)
    return ProblemOption(dtype=dtype, device=Device.CPU,
                         compute_kind=ComputeKind[kind],
                         algo_option=AlgoOption(**algo),
                         solver_option=SolverOption(fused_kernels=fk,
                                                    **solver), **top)


def jax_option(case, dtype=np.float64):
    kind, fk, top, solver, algo = case
    solver = _solver_fields(solver, JPrecondKind, JPreconditionerKind)
    return JProblemOption(dtype=dtype, compute_kind=JComputeKind[kind],
                          algo_option=JAlgoOption(**algo),
                          solver_option=JSolverOption(fused_kernels=fk,
                                                      **solver), **top)


def _strict_program(orig):
    """JAX's bucket program compiled without XLA's excess precision."""
    def program(engine, option, faulted=False):
        jitted = orig(engine, option, faulted)

        def run(*args):
            compiled = jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
            return compiled(*args)
        return run
    return program


def jax_solve_many(case, dtype=np.float64, strict=False, probs=None):
    """JAX's `solve_many` of `probs` (the fleet) under `case`."""
    probs = _fleet() if probs is None else probs
    orig = j_pool.batched_solve_program
    if strict:
        j_pool.batched_solve_program = _strict_program(orig)
    try:
        res = js.solve_many([_to_jax(p) for p in probs],
                            jax_option(case, dtype))
        jax.block_until_ready([r.cost for r in res])
    finally:
        j_pool.batched_solve_program = orig
    return res


def compare_fleets(got, want, cost_rtol=1e-9):
    """Per problem: equal counts, status, accept / PCG / fallback traces,
    trial costs at `cost_rtol`, cameras at the lane tests' tolerance."""
    assert len(got) == len(want)
    for t, j in zip(got, want):
        k = t.iterations
        assert k == int(j.iterations)
        assert (t.accepted, t.pcg_iterations, t.status, t.recoveries) == (
            int(j.accepted), int(j.pcg_iterations), int(j.status),
            int(j.recoveries))
        assert (t.lane, t.lanes, str(t.shape)) == (j.lane, j.lanes,
                                                   str(j.shape))
        for f in ("accept", "pcg_iters", "precond_fallback"):
            np.testing.assert_array_equal(
                getattr(t.trace, f)[:k].numpy(),
                np.asarray(getattr(j.trace, f))[:k], err_msg=f)
        np.testing.assert_allclose(t.trace.cost[:k].numpy(),
                                   np.asarray(j.trace.cost)[:k],
                                   rtol=cost_rtol)
        np.testing.assert_allclose(float(t.cost), float(j.cost),
                                   rtol=cost_rtol)
        np.testing.assert_allclose(t.cameras, np.asarray(j.cameras),
                                   rtol=1e-7, atol=1e-9)


def check_lanes_bitwise(opt, batched):
    """Problems 0, 2 and 5 alone (1 lane) and the first three (4 lanes)
    bitwise their lanes of the fleet (8 lanes)."""
    probs = _fleet()
    three = ts.solve_many(probs[:3], opt)
    assert {r.lanes for r in batched} == {8}
    assert {r.lanes for r in three} == {4}
    for i in (0, 2, 5):
        alone = ts.solve_many([probs[i]], opt)[0]
        assert alone.lanes == 1
        assert _bits(alone) == _bits(batched[i])
    for a, b in zip(three, batched):
        assert _bits(a) == _bits(b)


@functools.lru_cache(maxsize=None)
def _port_run(name, bf16=True):
    case = {**MIXED, **BF16}[name]
    dtype = np.float32 if name in BF16 else np.float64
    return ts.solve_many(_fleet(), port_option(case, dtype, bf16))


@pytest.mark.parametrize("name", list(MIXED))
def test_mixed_solve_many_matches_jax(name):
    got = _port_run(name)
    compare_fleets(got, jax_solve_many(MIXED[name]))
    assert all(t.iterations == LM_CAP for t in got)


@pytest.mark.parametrize("name", list(BF16))
def test_bf16_solve_many_matches_jax_and_f32(name):
    got = _port_run(name)
    want = jax_solve_many(BF16[name], np.float32, strict=True)
    f32 = _port_run(name, bf16=False)
    for t, j, r in zip(got, want, f32):
        c, c0 = float(t.cost), float(t.initial_cost)
        assert np.isfinite(c) and c < c0
        assert abs(c - float(j.cost)) / float(j.cost) <= BF16_BAND, (
            t.name, c, float(j.cost))
        assert abs(c - float(r.cost)) / float(r.cost) <= BF16_BAND, (
            t.name, c, float(r.cost))
    # The rung changed the arithmetic.
    assert any(float(t.cost) != float(r.cost) for t, r in zip(got, f32))


@pytest.mark.parametrize("name", list(MIXED) + list(BF16))
def test_rung_lanes_bitwise_alone_and_batched(name):
    case = {**MIXED, **BF16}[name]
    opt = port_option(case, np.float32 if name in BF16 else np.float64)
    check_lanes_bitwise(opt, _port_run(name))


COARSE = ("TWO_LEVEL", "MULTILEVEL")


def _coarse_error(kind):
    """JAX's `ValueError` text for a coarse preconditioner in its fleet."""
    with pytest.raises(ValueError) as got:
        js.solve_many([_to_jax(_fleet()[0])], JProblemOption(
            dtype=np.float64,
            solver_option=JSolverOption(precond=JPrecondKind[kind])))
    return str(got.value)


@pytest.mark.parametrize("kind", COARSE)
def test_coarse_preconditioners_raise_jax_value_error(kind):
    want = _coarse_error(kind)
    assert want.startswith(f"SolverOption.precond={kind} needs a "
                           "camera-cluster plan operand")
    opt = ProblemOption(dtype=np.float64, device=Device.CPU,
                        solver_option=SolverOption(
                            precond=PrecondKind[kind]))
    with pytest.raises(ValueError) as got:
        ts.solve_many(_fleet()[:2], opt)
    assert str(got.value) == want
    with ts.FleetQueue(opt) as q:
        fut = q.submit(_fleet()[0])
        q.flush()
        with pytest.raises(ValueError) as got:
            fut.result(timeout=60)
    assert str(got.value) == want
    # JAX's queue constructs too, and its future carries the same error.
    with js.FleetQueue(JProblemOption(
            dtype=np.float64,
            solver_option=JSolverOption(precond=JPrecondKind[kind]))) as q:
        fut = q.submit(_to_jax(_fleet()[0]))
        q.flush()
        with pytest.raises(ValueError) as got:
            fut.result(timeout=60)
    assert str(got.value) == want


def test_every_option_jax_batches_is_accepted():
    """No option the JAX package's fleet runs makes the port's gate
    raise; the gate checks options only."""
    from megba_tpu_torch.algo.lanes import check_lane_option

    base = ProblemOption(dtype=np.float64, device=Device.CPU)
    for kw in (dict(mixed_precision_pcg=True), dict(use_schur=False),
               dict(dtype=np.float32, solver_option=SolverOption(bf16=True)),
               dict(solver_option=SolverOption(
                   preconditioner=PreconditionerKind.SCHUR_DIAG)),
               dict(solver_option=SolverOption(precond=PrecondKind.NEUMANN,
                                               fused_kernels=True)),
               dict(use_schur=False, compute_kind=ComputeKind.EXPLICIT)):
        check_lane_option(dataclasses.replace(base, **kw))

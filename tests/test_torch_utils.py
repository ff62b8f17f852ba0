"""The port's small host utilities vs the JAX package's.

- `utils/debug`: `describe_array` and `print_blocks` print JAX's text for
  tensors and arrays; `assert_all_finite` checks eagerly;
- `utils/timing.trace_profile`: a no-op for None, and on the CPU a
  torch.profiler trace in the directory that names the PhaseTimer
  ranges of a solve;
- `utils/curves`: `parse_verbose_curve` of a port f64 solve equals JAX's
  parse of JAX's solve (iterations, accepts, PCG counts equal; costs at
  rtol 1e-9), and `dtype_parity_payload` keeps JAX's keys.

CPU only.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import megba_tpu.common as jc
from megba_tpu.ops.residuals import make_residual_jacobian_fn as j_engine
from megba_tpu.solve import flat_solve as j_flat_solve
from megba_tpu.utils import curves as jcurves
from megba_tpu.utils import debug as jdebug

import megba_tpu_torch as mt
from megba_tpu_torch import utils as tutils
from megba_tpu_torch.utils import curves as tcurves
from megba_tpu_torch.utils import debug as tdebug
from megba_tpu_torch.utils.timing import PhaseTimer, trace_profile

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)


def _printed(fn, *args, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_describe_array_text_is_jax(dtype):
    rng = np.random.default_rng(0)
    for a in (rng.standard_normal((3, 5)).astype(dtype),
              np.array([1.0, np.nan, np.inf], dtype),
              np.zeros((0, 2), dtype), np.arange(4, dtype=dtype)):
        want = jdebug.describe_array("x", a)
        assert tdebug.describe_array("x", a) == want
        assert tdebug.describe_array("x", torch.from_numpy(a)) == want
        assert tdebug.describe_array("x", a, max_items=2) == \
            jdebug.describe_array("x", a, max_items=2)


def test_print_blocks_text_is_jax():
    b = np.random.default_rng(1).standard_normal((4, 3, 3))
    want = _printed(jdebug.print_blocks, "Hpp", b)
    assert _printed(tdebug.print_blocks, "Hpp", b) == want
    assert _printed(tdebug.print_blocks, "Hpp", torch.from_numpy(b)) == want
    assert _printed(tdebug.print_blocks, "Hpp", b, range(3)) == \
        _printed(jdebug.print_blocks, "Hpp", b, range(3))


def test_assert_all_finite_is_eager():
    x = torch.ones(3)
    assert tdebug.assert_all_finite(x) is x
    a = np.ones(2)
    assert tdebug.assert_all_finite(a, debug=True) is a
    bad = torch.tensor([1.0, float("nan"), float("inf")])
    with pytest.raises(FloatingPointError) as tinfo:
        tdebug.assert_all_finite(bad, name="v")
    with pytest.raises(FloatingPointError) as jinfo:
        jdebug.assert_all_finite(bad.numpy(), name="v")
    assert str(tinfo.value) == str(jinfo.value) == \
        "v contains 2 non-finite values"
    with pytest.raises(FloatingPointError):
        tdebug.assert_all_finite(bad.numpy())
    # The package exports them as the JAX package does.
    assert tutils.assert_all_finite is tdebug.assert_all_finite
    assert tutils.describe_array is tdebug.describe_array
    assert tutils.print_blocks is tdebug.print_blocks
    assert tutils.trace_profile is trace_profile


def _scene():
    return mt.make_synthetic_bal(num_cameras=6, num_points=40,
                                 obs_per_point=3, seed=4)


def _options(max_iter=4):
    kw = dict(max_iter=max_iter, epsilon1=1e-12, epsilon2=1e-15)
    skw = dict(max_iter=30, tol=1e-10, refuse_ratio=1e30)
    j = jc.ProblemOption(
        dtype=np.float64, jacobian_mode=jc.JacobianMode.ANALYTICAL,
        algo_option=jc.AlgoOption(**kw), solver_option=jc.SolverOption(**skw))
    t = mt.ProblemOption(
        dtype=np.float64, jacobian_mode=mt.JacobianMode.ANALYTICAL,
        algo_option=mt.AlgoOption(**kw), solver_option=mt.SolverOption(**skw))
    return j, t


def _arrays(s):
    return s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx


def test_trace_profile(tmp_path):
    with trace_profile(None) as prof:
        assert prof is None
    s = _scene()
    _, topt = _options(2)
    logdir = tmp_path / "trace"
    with trace_profile(str(logdir)) as prof:
        mt.flat_solve(None,
                      *_arrays(s), topt, device="cpu", timer=PhaseTimer())
    files = list(logdir.glob("trace-*.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"megba.phase.plan", "megba.phase.dispatch"} <= names
    assert any(e.key == "megba.phase.dispatch"
               for e in prof.key_averages())


def test_parse_verbose_curve_matches_jax():
    s = _scene()
    jopt, topt = _options()
    f = j_engine(mode=jc.JacobianMode.ANALYTICAL)
    jres, jcurve = jcurves.run_with_curve(
        lambda: j_flat_solve(f, *_arrays(s), jopt, use_tiled=False,
                             verbose=True))
    tres, tcurve = tcurves.run_with_curve(
        lambda: mt.flat_solve(None, *_arrays(s), topt, device="cpu",
                              verbose=True))
    assert len(tcurve) == len(jcurve) == int(jres.iterations) > 0
    for a, b in zip(tcurve, jcurve):
        assert (a["iter"], a["accept"], a["pcg_iters"]) == (
            b["iter"], b["accept"], b["pcg_iters"])
        np.testing.assert_allclose(a["cost"], b["cost"], rtol=1e-9)
    # The same text parses alike in both parsers.
    text = _printed(mt.flat_solve, None, *_arrays(s), topt, device="cpu",
                    verbose=True)
    assert tcurves.parse_verbose_curve(text) == \
        jcurves.parse_verbose_curve(text)
    with pytest.raises(ValueError, match="no verbose iteration lines"):
        tcurves.parse_verbose_curve("nothing here")
    assert tcurves.parse_verbose_curve("", require=False) == []


def test_dtype_parity_payload_keys():
    s = _scene()

    def solve_for(dtype):
        opt = mt.ProblemOption(
            dtype=dtype, jacobian_mode=mt.JacobianMode.ANALYTICAL,
            algo_option=mt.AlgoOption(max_iter=3))
        return mt.flat_solve(None,
                             *_arrays(s), opt, device="cpu", verbose=True)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        payload = tcurves.dtype_parity_payload(solve_for, 1e-3, label="t")
    assert set(payload) == {
        "runs", "final_rel_diff", "curve_rel_gaps", "max_curve_rel_gap",
        "iterations_equal", "curve_len_f64", "curve_len_f32", "rel_tol",
        "gap_tol", "pass"}
    assert set(payload["runs"]) == {"float64", "float32"}
    assert set(payload["runs"]["float64"]) == {
        "initial_cost", "final_cost", "iterations", "accepted",
        "pcg_iterations", "elapsed_s", "curve"}
    assert payload["pass"] is True
    assert "[t] final rel diff" in out.getvalue()

"""The port's telemetry (observability/report.py, summarize.py,
trace.trace_to_dict, utils/meminfo.py) against the JAX package's.

- `trace_to_dict` equal to JAX's on the same trace;
- `flat_solve(telemetry=)` writes one SolveReport line whose keys, at
  every level, are the JAX package's for the same solve (and whose
  result block agrees with it); the knob wins over MEGBA_TELEMETRY;
- each package's summarize renders the other's reports, the same text;
- `solve_many` telemetry: one report per problem with the `fleet` block,
  read back by `summarize --aggregate` and `--fleet` of both packages;
- with telemetry off no report module is imported.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import megba_tpu.observability.summarize as j_summarize
from megba_tpu.common import AlgoOption as JAlgoOption
from megba_tpu.common import ProblemOption as JProblemOption
from megba_tpu.observability.trace import SolveTrace as JSolveTrace
from megba_tpu.observability.trace import trace_to_dict as j_trace_to_dict
from megba_tpu.ops.residuals import make_residual_jacobian_fn as j_engine
from megba_tpu.solve import flat_solve as j_flat_solve

import megba_tpu_torch as mt
import megba_tpu_torch.observability.summarize as t_summarize
from megba_tpu_torch.common import AlgoOption, Device, ProblemOption
from megba_tpu_torch.observability.report import (
    SCHEMA,
    SolveReport,
    backend_topology,
    config_to_dict,
)
from megba_tpu_torch.observability.trace import (
    TRACE_FIELDS,
    SolveTrace,
    trace_to_dict,
)
from megba_tpu_torch.utils.meminfo import device_memory_stats

OPT = ProblemOption(device=Device.CPU, algo_option=AlgoOption(max_iter=3))
JOPT = JProblemOption(algo_option=JAlgoOption(max_iter=3))


def _scene():
    s = mt.make_synthetic_bal(num_cameras=4, num_points=30, seed=0)
    return (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """One flat_solve report from each package on the same scene."""
    tmp = tmp_path_factory.mktemp("telemetry")
    t_path, j_path = str(tmp / "port.jsonl"), str(tmp / "jax.jsonl")
    mt.flat_solve(*_scene(), dataclasses.replace(OPT, telemetry=t_path))
    j_flat_solve(j_engine(), *_scene(),
                 dataclasses.replace(JOPT, telemetry=j_path))
    return t_path, j_path


def test_trace_to_dict_matches_jax():
    rng = np.random.default_rng(0)
    vals = {}
    for f in TRACE_FIELDS:
        if f in ("accept", "recovery"):
            vals[f] = rng.random(6) > 0.5
        elif f in ("pcg_iters", "pcg_breakdown", "precond_fallback"):
            vals[f] = rng.integers(0, 40, 6).astype(np.int32)
        else:
            vals[f] = rng.standard_normal(6)
    t = SolveTrace(**{f: torch.from_numpy(v.copy()) for f, v in vals.items()})
    j = JSolveTrace(**vals)
    for n in (0, 4, 6):
        assert trace_to_dict(t, n) == j_trace_to_dict(j, n)


def test_flat_solve_report_has_jax_keys(reports):
    t_path, j_path = reports
    t_lines = open(t_path).read().splitlines()
    assert len(t_lines) == 1
    t, j = json.loads(t_lines[0]), json.loads(open(j_path).read())
    assert t["schema"] == j["schema"] == SCHEMA
    assert _keys(t) - {"phases." + p for p in t["phases"]} - {
        "phases." + p + "." + k for p in t["phases"]
        for k in ("total_s", "calls")} == _keys(j) - {
        "phases." + p for p in j["phases"]} - {
        "phases." + p + "." + k for p in j["phases"]
        for k in ("total_s", "calls")}
    assert set(t["trace"]) == set(j["trace"]) == set(TRACE_FIELDS)
    for k in ("iterations", "accepted", "pcg_iterations", "status",
              "status_name", "recoveries", "stopped", "precond_fallback"):
        assert t["result"][k] == j["result"][k], k
    for k in ("initial_cost", "final_cost", "region"):
        assert t["result"][k] == pytest.approx(j["result"][k], rel=1e-9)
    assert {"lowering", "plan", "dispatch", "execute"} <= set(t["phases"])
    assert t["backend"] == backend_topology("cpu")
    assert t["backend"]["backend"] == "cpu" and t["memory"] is None
    assert t["config"]["telemetry"] == t_path
    assert t["problem"] == {"num_cameras": 4, "num_points": 30,
                            "num_edges": j["problem"]["num_edges"],
                            "num_edges_padded": j["problem"]["num_edges"],
                            "world_size": 1}


def test_config_to_dict_has_jax_fields():
    t = config_to_dict(ProblemOption())
    from megba_tpu.observability.report import config_to_dict as j_config

    j = j_config(JProblemOption())
    assert _keys(t) == _keys(j)
    assert {k: v for k, v in t.items() if k != "device"
            and not isinstance(v, dict)} == {
        k: v for k, v in j.items() if k != "device"
        and not isinstance(v, dict)}


def test_each_summarize_renders_the_other(reports):
    for path in reports:
        reps_t = t_summarize.load_reports(path)
        reps_j = j_summarize.load_reports(path)
        assert len(reps_t) == len(reps_j) == 1
        a = t_summarize.format_report(reps_t[0])
        b = j_summarize.format_report(reps_j[0])
        assert a == b and "LM iters" in a
        assert (t_summarize.aggregate_reports(reps_t)
                == j_summarize.aggregate_reports(reps_j))
        for mod in (t_summarize, j_summarize):
            buf = io.StringIO()
            with redirect_stdout(buf):
                assert mod.main([path]) == 0
            assert "report 0" in buf.getvalue()


def test_telemetry_knob_wins_over_environment(tmp_path, monkeypatch):
    env_path, knob_path = tmp_path / "env.jsonl", tmp_path / "knob.jsonl"
    monkeypatch.setenv("MEGBA_TELEMETRY", str(env_path))
    mt.flat_solve(*_scene(), OPT)
    mt.flat_solve(*_scene(), dataclasses.replace(OPT,
                                                 telemetry=str(knob_path)))
    assert len(env_path.read_text().splitlines()) == 1
    assert len(knob_path.read_text().splitlines()) == 1
    rep = SolveReport.from_json(env_path.read_text())
    assert rep.config["telemetry"] is None  # the env var is not the knob


def test_solve_many_reports_and_fleet_views(tmp_path):
    path = str(tmp_path / "fleet.jsonl")
    fl = mt.io.synthetic.make_fleet(5, size_range=(12, 40), seed=0)
    probs = [mt.FleetProblem.from_synthetic(s, name=f"f{i}")
             for i, s in enumerate(fl)]
    res = mt.solve_many(probs, dataclasses.replace(OPT, telemetry=path))
    lines = open(path).read().splitlines()
    assert len(lines) == len(probs)
    reps = [SolveReport.from_json(x) for x in lines]
    by_name = {rep.fleet["name"]: rep for rep in reps}
    assert sorted(by_name) == sorted(p.name for p in probs)
    for r in res:
        rep = by_name[r.name]
        assert rep.fleet["bucket"] == str(r.shape)
        assert (rep.fleet["lane"], rep.fleet["lanes"]) == (r.lane, r.lanes)
        assert rep.result["iterations"] == r.iterations
        assert rep.result["final_cost"] == float(r.cost)
        assert rep.problem["num_edges_padded"] == r.shape.n_edge
        assert rep.fleet["stats"]["problems"] >= 1
    jreps = j_summarize.load_reports(path)
    agg_t, agg_j = (t_summarize.aggregate_reports(reps),
                    j_summarize.aggregate_reports(jreps))
    assert agg_t == agg_j and f"{len(probs)}" in agg_t
    assert t_summarize.fleet_table(reps) == j_summarize.fleet_table(jreps)
    for mode in ("--aggregate", "--fleet"):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert t_summarize.main([mode, path]) == 0
        assert buf.getvalue().strip()


def test_device_memory_stats_and_topology_without_card():
    assert device_memory_stats("cpu") is None
    topo = backend_topology("cpu")
    assert topo["process_index"] == 0 and topo["device_count"] == 1
    if not torch.cuda.is_available():
        assert device_memory_stats() is None


def test_telemetry_off_imports_no_report_module():
    code = (
        "import sys\n"
        "import megba_tpu_torch as mt\n"
        "from megba_tpu_torch.common import AlgoOption, Device, "
        "ProblemOption\n"
        "s = mt.make_synthetic_bal(num_cameras=3, num_points=12, seed=0)\n"
        "mt.flat_solve(s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,"
        " ProblemOption(device=Device.CPU, algo_option=AlgoOption("
        "max_iter=1)))\n"
        "fl = [mt.FleetProblem.from_synthetic(s)]\n"
        "mt.solve_many(fl, ProblemOption(device=Device.CPU, algo_option="
        "AlgoOption(max_iter=1)))\n"
        "bad = [m for m in sys.modules if m.endswith('observability.report')"
        " or m.endswith('observability.summarize') or m == 'jax']\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "MEGBA_TELEMETRY"}
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   env=env)

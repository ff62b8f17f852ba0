"""The port's analysis layer (megba_tpu_torch/analysis) on the CPU.

- The lint lanes: the port is clean under its own linter; for every
  ported rule its findings on the six fixtures under
  tests/data/lint_fixtures/ and on the JAX package's own sources equal
  JAX's `lint_paths` (path, line, column, rule); the allow pragmas
  suppress; the CLI's exit codes are 0, 1 and 2.
- `edge_budget` against JAX's on venice, fleet and pose-graph shapes:
  equal where the layouts are the same, lower by the stated term where
  the port's unfused kernels keep fewer intermediates.
- The strict-dtype mode passes the BA and PGO solves and fires on an
  f32 + f64 op and on a NaN.
- The rebuild sentinel stays quiet on a repeated solve and fires on a
  changed signature.
- The census of the canonical specs equals the committed budget, spec
  by spec, and holds PERF.md's host-read figures.

CPU only, one intra-op thread.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import megba_tpu_torch as mt
from megba_tpu_torch.analysis import edge_budget as teb
from megba_tpu_torch.analysis import retrace
from megba_tpu_torch.analysis.lint import lint_paths
from megba_tpu_torch.analysis.rules import ALL_RULES

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(glob.glob(os.path.join(_REPO, "tests", "data",
                                         "lint_fixtures", "*.py")))
CLI_TIMEOUT_S = 120


def _key(findings):
    return sorted((os.path.relpath(f.path, _REPO), f.line, f.col, f.rule)
                  for f in findings)


# ------------------------------------------------------------------ lint


def test_port_is_lint_clean():
    assert lint_paths([os.path.join(_REPO, "megba_tpu_torch")]) == []


def test_ported_rules_match_jax_on_fixtures_and_jax_sources():
    from megba_tpu.analysis.lint import lint_paths as j_lint_paths

    assert len(FIXTURES) == 6
    for path in FIXTURES:
        assert _key(lint_paths([path])) == _key(
            j_lint_paths([path], rules=list(ALL_RULES))), path
    # The fixtures linted together (the identity lane reads the option
    # classes across files) and the JAX package's own sources.
    for paths in (FIXTURES, [os.path.join(_REPO, "megba_tpu")]):
        assert _key(lint_paths(paths)) == _key(
            j_lint_paths(paths, rules=list(ALL_RULES)))
    assert _key(lint_paths(FIXTURES))


def test_allow_pragmas_suppress(tmp_path):
    src = ("import time\n\n\ndef f():\n    a = time.perf_counter()\n"
           "    b = time.perf_counter()  # megba: allow-raw-clock\n"
           "    return a, b\n")
    p = tmp_path / "clock.py"
    p.write_text(src)
    found = lint_paths([str(p)])
    assert [(f.line, f.rule) for f in found] == [(5, "raw-clock")]
    assert "megba_tpu_torch.utils.timing.monotonic_s()" in found[0].message


def _cli(*args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "megba_tpu_torch.analysis.lint", *args],
        cwd=_REPO, capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
        env=env)


def test_lint_cli_exit_codes(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("def f():\n    return 1\n")
    dirty = tmp_path / "dirty.py"
    dirty.write_text("import time\n\nT = time.time()\n")
    assert _cli(str(clean)).returncode == 0
    out = _cli(str(dirty))
    assert out.returncode == 1
    assert f"{dirty}:3:4: raw-clock" in out.stdout
    assert _cli().returncode == 2
    from megba_tpu_torch.analysis.lint import run_lint

    assert run_lint([str(clean), "--rule", "no-such-rule"]) == 2
    assert run_lint([str(clean)]) == 0


# ----------------------------------------------------------- edge budget

# (cameras, cd, points, pd, rd, edge slots): venice, one fleet union
# bucket, and a pose graph (poses, pose dim, rd, edges).
VENICE = (1778, 9, 993923, 3, 2, 5001946)
FLEET = (128, 9, 1024, 3, 2, 4096)
POSE_GRAPH = (50000, 6, 6, 60000)


@pytest.mark.parametrize("shape", [VENICE, FLEET], ids=["venice", "fleet"])
def test_edge_budget_matches_jax_schur(shape):
    from megba_tpu.analysis import edge_budget as jeb

    for explicit in (False, True):
        for operand, param in (("f32", "f32"), ("f64", "f64"),
                               ("bf16", "f32")):
            kw = dict(explicit=explicit, operand=operand, param=param,
                      acc=param)
            fused = dict(kw, transient_roundtrips=False)
            # Fused arms (kernels 7 and 8): the same layout as JAX's.
            assert teb.schur_sp_budget(*shape, **fused) == \
                jeb.schur_sp_budget(*shape, **fused)
            t = teb.schur_sp_budget(*shape, **kw)
            j = jeb.schur_sp_budget(*shape, **kw)
            assert t["flops_per_sp"] == j["flops_per_sp"]
            if explicit:
                # Kernels 5 and 4 round the W contraction: JAX's layout.
                assert t == j
            else:
                # Kernels 2 and 3 gather and reduce in-kernel: only the
                # u rows round-trip.
                nc, cd, npt, pd, rd, e = shape
                ab = teb.OPERAND_BYTES[param]
                assert j["bytes_touched_per_sp"] - t[
                    "bytes_touched_per_sp"] == 2.0 * 2 * e * (cd + pd) * ab
    assert teb.schur_sp_budget(*FLEET, explicit=True, lanes=4) == \
        jeb.schur_sp_budget(*FLEET, explicit=True, lanes=4)


def test_edge_budget_pose_graph():
    from megba_tpu.analysis import edge_budget as jeb

    n, d, rd, e = POSE_GRAPH
    t, j = teb.pgo_sp_budget(n, d, rd, e), jeb.pgo_sp_budget(n, d, rd, e)
    assert t["flops_per_sp"] == j["flops_per_sp"]
    # The port's u permutes (11 rd a slot) against JAX's round-trip of
    # the gathered pair, u and the products (2 (4 d + rd) a slot).
    assert t["bytes_touched_per_sp"] - j["bytes_touched_per_sp"] == \
        8.0 * e * (11 * rd - 2 * (4 * d + rd))
    assert teb.coupling_rows_per_edge(9, 3, 2) == \
        jeb.coupling_rows_per_edge(9, 3, 2)
    assert teb.coupling_macs_per_edge(9, 3, 2, True) == \
        jeb.coupling_macs_per_edge(9, 3, 2, True)


# ----------------------------------------------------------- strict dtype


def test_strict_mode_passes_ba_and_pgo():
    from megba_tpu_torch.analysis import strict_dtype

    info = strict_dtype.run_lane("cpu")
    assert info["ops"] > 1000
    assert info["nans_declared"] == 0


def test_strict_mode_fires_on_mix_and_nan():
    from megba_tpu_torch.analysis.strict_dtype import (
        StrictDtypeError,
        strict_promotion,
    )

    a32 = torch.ones(3, dtype=torch.float32)
    a64 = torch.ones(3, dtype=torch.float64)
    with pytest.raises(StrictDtypeError, match="mixes floating dtypes"):
        with strict_promotion():
            a32 + a64
    with pytest.raises(StrictDtypeError, match="NaN"):
        with strict_promotion():
            torch.zeros(2) / torch.zeros(2)
    # The declared arm: bf16 operands beside f32 accumulation.
    with strict_promotion():
        out = a32 + a32.to(torch.bfloat16)
    assert out.dtype == torch.float32


@pytest.mark.parametrize("guard", [False, True])
def test_strict_mode_fires_on_nan_in_pcg_matvec(guard):
    from megba_tpu_torch.analysis.strict_dtype import (
        StrictDtypeError,
        strict_promotion,
    )
    from megba_tpu_torch.solver.pcg import _pcg_core

    a = torch.eye(4, dtype=torch.float64) * 2.0
    b = torch.arange(1.0, 5.0, dtype=torch.float64)
    calls = []

    def matvec(v):
        calls.append(1)
        out = a @ v
        return out * float("nan") if len(calls) > 1 else out

    with pytest.raises(StrictDtypeError, match="NaN"):
        with strict_promotion():
            _pcg_core(matvec, lambda r: r, b, 10, 1e-30, 1e6, False,
                      guard=guard, max_restarts=1)
    assert len(calls) == 2


def test_strict_mode_declares_only_the_fault_site():
    from megba_tpu_torch.analysis.strict_dtype import (
        StrictDtypeError,
        strict_promotion,
    )
    from megba_tpu_torch.robustness.faults import (
        make_nan_burst,
        poison_residuals,
    )

    plan = make_nan_burst(3, [1], 0, 2)
    r = torch.ones((2, 3), dtype=torch.float64)
    with strict_promotion() as mode:
        poisoned = poison_residuals(r, plan, 0)
    assert mode.nans_declared == 1
    # The fault's NaN carried on by other code raises.
    with pytest.raises(StrictDtypeError, match="NaN"):
        with strict_promotion():
            torch.sum(poisoned)


# ------------------------------------------------------------- retrace


def _small(seed=0, n_cam=4):
    s = mt.make_synthetic_bal(num_cameras=n_cam, num_points=24,
                              obs_per_point=3, seed=seed)
    return (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)


def test_retrace_sentinel_quiet_on_repeat_fires_on_new_signature():
    opt = mt.ProblemOption(algo_option=mt.AlgoOption(max_iter=2))
    mt.flat_solve(None, *_small(), opt, device="cpu")
    with retrace.sentinel(max_compiles=0) as s:
        mt.flat_solve(None, *_small(), opt, device="cpu")
    assert s.total_new() == 0
    with pytest.raises(retrace.RetraceError, match="new builds"):
        with retrace.sentinel(max_compiles=0):
            mt.flat_solve(None, *_small(seed=7, n_cam=5), opt, device="cpu")
    retrace.note_build("kernel_build", "libx-test.so")
    with pytest.raises(retrace.RetraceError, match="more than once"):
        with retrace.sentinel():
            retrace.note_build("kernel_build", "libx-test.so")
    assert retrace.site_totals(["kernel_build"])["kernel_build"] >= 2


# -------------------------------------------------------------- census


@pytest.fixture(scope="module")
def census_records():
    from megba_tpu_torch.analysis import program_audit

    return program_audit.audit_all(device="cpu")


def test_census_matches_committed_budget(census_records):
    from megba_tpu_torch.analysis import program_audit

    budget = program_audit.load_budget()
    assert set(census_records) == set(budget["specs"])
    assert program_audit.check_against(census_records, budget) == []
    assert set(budget["skipped"]) == {"ba_tiled_f32"}


def test_census_holds_jax_pcg_psums_and_perf_claim(census_records):
    from megba_tpu.analysis.program_audit import program_specs as j_specs

    jax_names = set(j_specs())
    assert set(census_records) | {"ba_tiled_f32"} == jax_names
    for name, rec in census_records.items():
        if rec["jax_pcg_psums"]:
            assert rec["pcg_sums"] == rec["jax_pcg_psums"], name
    # The 2-D S.p: one grouped scatter, two subgroup sums, the ring's
    # take and one hop (C = 2), one gather.
    per = census_records["ba_2d_w4_f32"]["per_pcg"]
    assert {k: v for k, v in per.items() if k.startswith("coll:")} == {
        "coll:psum_groups": 2, "coll:psum_scatter": 1, "coll:ppermute": 2,
        "coll:all_gather": 1}
    # PERF.md: 3 host reads per LM step, 1 per PCG iteration, and the
    # first test of each PCG loop, on the default path.
    single = census_records["ba_single_f32"]
    assert single["per_lm"]["host_reads"] == 3 + 1
    assert single["per_pcg"]["host_reads"] == 1

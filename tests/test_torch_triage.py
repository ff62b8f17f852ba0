"""The port's pre-flight triage (robustness/triage.py) vs the JAX
package's, and `flat_solve(..., triage=...)`.

- `connected_components` and `huber_weight` on toy inputs;
- `check_problem` (the report's `to_dict()` with `triage_s` masked, and
  every internal mask) and `triage_problem` (the action, the REJECT
  report, `plan_repair`'s arrays and counters) equal to JAX's on the toy
  graphs and knob scenes of tests/test_triage.py, for `factor=None`, rig
  and pinhole_radial (planar has no hooks);
- `flat_solve(triage=REPAIR)` on a degenerate scene against JAX's at
  float64 (trial costs at rtol 1e-9, equal counts and status, the same
  `triage_*` timer events); REJECT raises `ProblemRejected` from a
  "triage" phase with no "lowering" phase after it; WARN solves bitwise
  as the untriaged call.

CPU only; no JAX solve compiles except the REPAIR reference.
"""

import numpy as np
import pytest
import torch

import megba_tpu.common as jc
from megba_tpu.factors import get_factor as j_get_factor
from megba_tpu.io.synthetic import project_batch_depth
from megba_tpu.ops.residuals import make_residual_jacobian_fn as j_engine
from megba_tpu.robustness import triage as jtri
from megba_tpu.solve import flat_solve as j_flat_solve
from megba_tpu.utils.timing import PhaseTimer as JPhaseTimer

import megba_tpu_torch as mt
from megba_tpu_torch.factors.radial import make_synthetic_radial
from megba_tpu_torch.factors.rig import make_synthetic_rig
from megba_tpu_torch.robustness import triage as ttri
from megba_tpu_torch.utils.timing import PhaseTimer

from test_torch_guards import _options
from test_torch_solve import _compare

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

REPAIR = dict(on_degenerate="REPAIR")


def _clean(seed=0, **kw):
    return mt.make_synthetic_bal(num_cameras=6, num_points=48,
                                 obs_per_point=3, seed=seed,
                                 dtype=np.float64, **kw)


def _arrays(s):
    return [s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx]


def _toy_degrees():
    s = _clean()
    pts = np.concatenate([s.points0, [[0.1, 0.2, 0.3], [0.3, 0.1, 0.2]]])
    cams = np.concatenate([s.cameras0, s.cameras0[:1]])
    np_pt = s.points0.shape[0]
    ci = np.concatenate([s.cam_idx, [0]]).astype(np.int32)
    pi = np.concatenate([s.pt_idx, [np_pt]]).astype(np.int32)
    obs = np.concatenate([s.obs, [[0.0, 0.0]]])
    return [cams, pts, obs, ci, pi]


def _toy_camera():
    cams = np.zeros((3, 9))
    cams[:, 5] = -5.0
    cams[:, 6] = 500.0
    pts = np.array([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.0, 0.1, 0.0],
                    [-0.1, 0.1, 0.0], [0.1, -0.1, 0.0]])
    ci = np.array([0] * 5 + [1] * 5 + [2], np.int32)
    pi = np.array(list(range(5)) * 2 + [0], np.int32)
    uv, _ = project_batch_depth(cams[ci], pts[pi])
    return [cams, pts, uv, ci, pi]


def _duplicate():
    s = _clean()
    ci = np.concatenate([s.cam_idx, s.cam_idx[5:6]]).astype(np.int32)
    pi = np.concatenate([s.pt_idx, s.pt_idx[5:6]]).astype(np.int32)
    obs = np.concatenate([s.obs, s.obs[5:6] + 1.0])
    return [s.cameras0, s.points0, obs, ci, pi]


def _nonfinite():
    s = _clean()
    cams, pts, obs = s.cameras0.copy(), s.points0.copy(), s.obs.copy()
    cams[2, 4] = np.inf
    pts[7] = np.nan
    obs[11, 0] = np.nan
    return [cams, pts, obs, s.cam_idx, s.pt_idx]


def _nan_camera_block():
    s = _clean()
    cams = np.concatenate([s.cameras0, np.full((1, 9), np.nan)])
    return [cams, s.points0, s.obs, s.cam_idx, s.pt_idx]


def _outlier():
    s = _clean()
    obs = s.obs.copy()
    obs[3] += 1e6
    return [s.cameras0, s.points0, obs, s.cam_idx, s.pt_idx]


def _low_parallax():
    cams = np.zeros((2, 9))
    cams[:, 5] = -5.0
    cams[:, 6] = 500.0
    pts = np.array([[0.0, 0.0, 0.0], [0.3, 0.1, 0.0], [0.1, 0.3, 0.0],
                    [-0.2, 0.1, 0.0]])
    ci = np.array([0, 1] * 4, np.int32)
    pi = np.repeat(np.arange(4), 2).astype(np.int32)
    uv, _ = project_batch_depth(cams[ci], pts[pi])
    return [cams, pts, uv, ci, pi]


def _caller_operands():
    """A caller-masked edge (its point drops to degree 1), a caller-fixed
    point and camera."""
    s = _clean(n_disconnect=1)
    mask = np.ones(s.obs.shape[0])
    mask[np.nonzero(s.pt_idx == int(s.pt_idx[0]))[0][0]] = 0.0
    pt_fixed = np.zeros(s.points0.shape[0], bool)
    pt_fixed[9] = True
    cam_fixed = np.zeros(s.cameras0.shape[0], bool)
    cam_fixed[-1] = True
    return _arrays(s), dict(edge_mask=mask, cam_fixed=cam_fixed,
                            pt_fixed=pt_fixed)


def _rig_behind():
    s = make_synthetic_rig()
    pts = s.points0.copy()
    pts[int(s.pt_idx[0])] = [0.0, 0.0, 6.0]  # behind the rig
    return [s.cameras0, pts, s.obs, s.cam_idx, s.pt_idx]


def _radial_knobs():
    s = make_synthetic_radial()
    pts, obs = s.points0.copy(), s.obs.copy()
    pts[int(s.pt_idx[0])] = [0.0, 0.0, 6.0]
    obs[5] += 1e6
    pts[int(s.pt_idx[20])] = np.nan
    return [s.cameras0, pts, obs, s.cam_idx, s.pt_idx]


# name: (arrays, operands, policy, factor)
SCENES = {
    "clean": (lambda: _arrays(_clean()), {}, {}, None),
    "clean_reject": (lambda: _arrays(_clean()), {},
                     dict(on_degenerate="REJECT"), None),
    "toy_degrees": (_toy_degrees, {}, dict(REPAIR, geometric=False), None),
    "toy_degrees_reject": (_toy_degrees, {}, dict(geometric=False), None),
    "toy_camera": (_toy_camera, {}, dict(geometric=False), None),
    "duplicate": (_duplicate, {}, REPAIR, None),
    "nonfinite": (_nonfinite, {}, REPAIR, None),
    "nan_camera_block": (_nan_camera_block, {}, REPAIR, None),
    "behind": (lambda: _arrays(_clean(n_behind_camera=2)), {}, REPAIR,
               None),
    "orphan": (lambda: _arrays(_clean(n_orphan_points=5)), {}, REPAIR,
               None),
    "disconnect": (lambda: _arrays(_clean(n_disconnect=2)), {}, REPAIR,
                   None),
    "knobs_warn": (lambda: _arrays(_clean(n_orphan_points=3,
                                          n_behind_camera=2,
                                          n_disconnect=1)), {},
                   dict(on_degenerate="WARN"), None),
    "outlier_downweight": (_outlier, {}, dict(REPAIR, max_residual_px=1e3),
                           None),
    "outlier_delete": (_outlier, {}, dict(REPAIR, max_residual_px=1e3,
                                          downweight_outliers=False), None),
    "low_parallax": (_low_parallax, {}, REPAIR, None),
    "caller_operands": (None, None, REPAIR, None),
    "rig_behind": (_rig_behind, {}, REPAIR, "rig"),
    "rig_duplicates_structural": (
        lambda: _arrays(make_synthetic_rig(rig_cameras=2)), {},
        dict(geometric=False), None),
    "radial_knobs": (_radial_knobs, {}, dict(REPAIR, max_residual_px=1e3),
                     "pinhole_radial"),
}


def _scene_inputs(name):
    make, operands, policy, factor = SCENES[name]
    if name == "caller_operands":
        arrays, operands = _caller_operands()
    else:
        arrays = make()
    return arrays, operands, policy, factor


def _policy(mod, policy):
    kw = dict(policy)
    if "on_degenerate" in kw:
        kw["on_degenerate"] = mod.TriageAction[kw["on_degenerate"]]
    return mod.TriagePolicy(**kw)


def _report(report):
    d = report.to_dict()
    d["triage_s"] = None
    return d


def _run(mod, get_factor, name):
    """(check_problem's report and internals, triage_problem's outcome
    or the rejected report) of one package."""
    arrays, operands, policy, factor = _scene_inputs(name)
    spec = None if factor is None else get_factor(factor)
    pol = _policy(mod, policy)
    report, internals = mod.check_problem(*arrays, pol, factor=spec,
                                          **operands)
    try:
        outcome = mod.triage_problem(*arrays, pol, factor=spec, **operands)
    except mod.ProblemRejected as exc:
        return report, internals, ("rejected", _report(exc.report))
    return report, internals, outcome


def _repair_arrays(rep):
    if rep is None:
        return None
    out = {f: getattr(rep, f) for f in ("edge_mask", "cam_fixed",
                                        "pt_fixed", "cameras", "points",
                                        "obs")}
    out.update(rep.counters())
    out["is_noop"] = rep.is_noop
    return out


def _assert_equal(a, b, where):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("name", sorted(SCENES))
def test_triage_matches_jax(name):
    jrep, jint, jout = _run(jtri, j_get_factor, name)
    trep, tint, tout = _run(ttri, mt.get_factor, name)
    _assert_equal(_report(jrep), _report(trep), "check_problem report")
    _assert_equal(jint, tint, "internals")
    if isinstance(jout, tuple):
        assert isinstance(tout, tuple), "the port did not reject"
        _assert_equal(jout[1], tout[1], "rejected report")
        return
    assert tout.action.value == jout.action.value
    _assert_equal(_report(jout.report), _report(tout.report), "report")
    _assert_equal(_repair_arrays(jout.repair), _repair_arrays(tout.repair),
                  "repair")


def test_connected_components_and_huber_weight_match_jax():
    k = 50
    cases = [
        (np.array([0, 1, 1]), np.array([0, 0, 1]), 2, 2, None),
        (np.array([0, 1]), np.array([0, 1]), 2, 3, None),
        (np.repeat(np.arange(k), 2)[1:-1], np.repeat(np.arange(k - 1), 2),
         k, k - 1, None),
        (np.array([0, 1, 1]), np.array([0, 0, 1]), 2, 2,
         np.array([True, False, True])),
    ]
    for ci, pi, nc, npt, alive in cases:
        want = jtri.connected_components(ci, pi, nc, npt, edge_alive=alive)
        got = ttri.connected_components(ci, pi, nc, npt, edge_alive=alive)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    s2 = np.array([0.0, 1.0, 1e6, 4e6, 1e12])
    np.testing.assert_array_equal(ttri.huber_weight(s2, 1e3),
                                  jtri.huber_weight(s2, 1e3))


# ------------------------------------------------------------ flat_solve


def _degenerate():
    return _clean(seed=4, n_orphan_points=3, n_behind_camera=2,
                  n_disconnect=1)


def test_flat_solve_repair_matches_jax():
    s = _degenerate()
    jopt, topt = _options(False)
    jtimer, ttimer = JPhaseTimer(), PhaseTimer()
    jres = j_flat_solve(
        j_engine(mode=jc.JacobianMode.ANALYTICAL), *_arrays(s), jopt,
        use_tiled=False, timer=jtimer,
        triage=_policy(jtri, REPAIR))
    tres = mt.flat_solve(None, *_arrays(s), topt, device="cpu", timer=ttimer,
                         triage=_policy(ttri, REPAIR))
    _compare(jres, tres, cost_rtol=1e-9)
    events = {k: v["calls"] for k, v in ttimer.as_dict().items()
              if k.startswith("triage_")}
    assert events and events == {
        k: v["calls"] for k, v in jtimer.as_dict().items()
        if k.startswith("triage_")}
    assert {"triage", "lowering", "plan", "dispatch"} <= set(ttimer.totals)
    assert np.isfinite(float(tres.cost))
    assert float(tres.cost) < float(tres.initial_cost)


def test_flat_solve_reject_before_lowering():
    s = _degenerate()
    _, topt = _options(False)
    timer = PhaseTimer()
    with pytest.raises(mt.ProblemRejected) as info:
        mt.flat_solve(None, *_arrays(s), topt, device="cpu", timer=timer,
                      triage=mt.TriagePolicy())
    assert info.value.report.degenerate
    assert list(timer.totals) == ["triage"]
    # A clean problem passes a REJECT policy untouched.
    timer.reset()
    mt.flat_solve(None, *_arrays(_clean()), topt, device="cpu", timer=timer,
                  triage=mt.TriagePolicy())
    assert {"triage", "lowering", "plan", "dispatch"} <= set(timer.totals)


def test_flat_solve_warn_is_the_untriaged_solve():
    s = _degenerate()
    _, topt = _options(False)
    plain = mt.flat_solve(None, *_arrays(s), topt, device="cpu")
    warned = mt.flat_solve(None, *_arrays(s), topt, device="cpu",
                           triage=mt.TriagePolicy(
                               on_degenerate=mt.TriageAction.WARN))
    assert torch.equal(plain.cameras, warned.cameras)
    assert torch.equal(plain.points, warned.points)
    assert torch.equal(plain.trace.cost, warned.trace.cost, )
    assert (plain.iterations, plain.pcg_iterations) == (
        warned.iterations, warned.pcg_iterations)

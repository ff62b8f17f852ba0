"""The port's factor registry and its families vs the JAX package.

float64 (the conftest enables x64 for JAX), CPU only:

- the registry API (`register_factor`, `get_factor`, `list_factors`,
  `require_schur`, the typed errors and their messages), the seven
  built-in names in the JAX package's order, and `engine_for("bal")` being
  the very engine `make_residual_jacobian_fn()` returns;
- each family's residual and AUTODIFF Jacobian per edge against the JAX
  engine at 1e-12 (the pose prior also at E_R = I, where the Jacobian
  must be finite), the two pose-graph residuals, and the geo helpers
  they are built on, small angles and every quaternion pivot included;
- the synthetic generators (the same draws from the same seed);
- `flat_solve(..., factor=...)` for the five camera/point families
  against the JAX package's `flat_solve(None, ..., factor=...)` with
  `ProblemOption()` (AUTODIFF, an LM cap before the cost floor): trial
  costs at rtol 1e-9, equal accept pattern, LM / PCG counts and status;
- the refuse-ratio defaults, the robust-loss refusal and the width
  checks.

tests/test_torch_cuda.py runs the families through the kernels on the
card.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megba_tpu.common as jc
import megba_tpu.factors as jf
from megba_tpu.factors import priors as j_priors
from megba_tpu.factors import radial as j_radial
from megba_tpu.factors import rig as j_rig
from megba_tpu.factors import sim3 as j_sim3
from megba_tpu.factors.registry import (
    apply_factor_solver_defaults as j_apply_defaults,
)
from megba_tpu.factors.registry import require_schur as j_require_schur
from megba_tpu.models import pgo as j_pgo
from megba_tpu.models import planar as j_planar
from megba_tpu.ops import geo as jgeo
from megba_tpu.ops.robust import RobustKind as JRobustKind
from megba_tpu.solve import flat_solve as j_flat_solve

import megba_tpu_torch as mt
import megba_tpu_torch.factors as tf
from megba_tpu_torch.convert import to_torch
from megba_tpu_torch.factors import pose_graph as t_pose_graph
from megba_tpu_torch.factors import priors as t_priors
from megba_tpu_torch.factors import radial as t_radial
from megba_tpu_torch.factors import rig as t_rig
from megba_tpu_torch.factors import sim3 as t_sim3
from megba_tpu_torch.factors.registry import (
    apply_factor_solver_defaults,
    require_pose_graph,
    require_schur,
    resolve_refuse_ratio,
)
from megba_tpu_torch.models import planar as t_planar
from megba_tpu_torch.ops import geo as tgeo
from megba_tpu_torch.ops.residuals import make_residual_jacobian_fn

from test_torch_solve import _compare

SCHUR = ["bal", "planar", "rig", "pinhole_radial", "pose_prior"]
# LM iterations of the solve parities: the small scenes reach their cost
# floor at the fourth, where an accept decision is rounding.
LM_CAP = 3


def _scene(name, seed=0):
    """The port's generator of each family (the JAX package's draws)."""
    if name == "planar":
        return t_planar.make_synthetic_planar(6, 40, 3, seed=seed)
    if name == "rig":
        return t_rig.make_synthetic_rig(6, 40, 2, 2, seed=seed)
    if name == "pinhole_radial":
        return t_radial.make_synthetic_radial(6, 40, 3, seed=seed)
    if name == "pose_prior":
        return t_priors.make_synthetic_priors(8, 2, prior_noise=0.01,
                                              seed=seed)
    return mt.make_synthetic_bal(num_cameras=6, num_points=40,
                                 obs_per_point=3, seed=seed)


def _fm(a):
    return np.ascontiguousarray(np.asarray(a, np.float64).T)


def _edge_rows(name, seed=0):
    """Feature-major (cam, pt, obs) rows of a scene's edges."""
    s = _scene(name, seed)
    return (_fm(s.cameras0[s.cam_idx]), _fm(s.points0[s.pt_idx]),
            _fm(s.obs))


def _port(fn, *rows):
    out = fn(*(torch.from_numpy(a) for a in rows))
    return [t.numpy() for t in (out if isinstance(out, tuple) else (out,))]


def _close_per_row(got, want, rtol=1e-12):
    """|got - want| <= rtol times the row's largest |want| (or 1)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want).max(axis=-1, keepdims=True), 1.0)
    assert (np.abs(got - want) <= rtol * scale).all(), float(
        (np.abs(got - want) / scale).max())


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


def test_builtin_factors_match_jax_names_order_and_specs():
    t, j = tf.list_factors(), jf.list_factors()
    assert list(t) == list(j)[:len(t)] == [
        "bal", "planar", "rig", "pinhole_radial", "pose_prior",
        "se3_between", "sim3_between"]
    for name, spec in t.items():
        js = j[name]
        assert spec.kind == js.kind
        fields = (("cam_dim", "pt_dim", "obs_dim", "residual_dim",
                   "robust_ok", "unique_edges", "point_coupled",
                   "refuse_ratio", "description") if spec.kind == "schur"
                  else ("pose_dim", "meas_dim", "residual_dim",
                        "refuse_ratio", "description"))
        for f in fields:
            assert getattr(spec, f) == getattr(js, f), (name, f)
        if spec.kind == "schur":
            assert (spec.analytical_fn is None) == (js.analytical_fn is None)
            assert (spec.triage is None) == (js.triage is None), name


def _message(exc_type, fn, *args, **kw):
    with pytest.raises(exc_type) as ei:
        fn(*args, **kw)
    return str(ei.value)


def test_registry_errors_carry_jax_messages():
    # Unknown names (the same registered set, so the same message).
    for pkg in (tf, jf):
        pkg.get_factor("bal")
    assert (_message(tf.UnknownFactorError, tf.get_factor, "pinhole_radail")
            == _message(jf.UnknownFactorError, jf.get_factor,
                        "pinhole_radail"))
    # Duplicates, refused unless allow_override.
    t_clone = dataclasses.replace(tf.get_factor("bal"), description="x")
    j_clone = dataclasses.replace(jf.get_factor("bal"), description="x")
    assert (_message(tf.DuplicateFactorError, tf.register_factor, t_clone)
            == _message(jf.DuplicateFactorError, jf.register_factor,
                        j_clone))
    original = tf.get_factor("bal")
    try:
        tf.register_factor(t_clone, allow_override=True)
        assert tf.get_factor("bal").description == "x"
    finally:
        tf.register_factor(original, allow_override=True)
    assert list(tf.list_factors())[0] == "bal"
    # Width checks of the spec itself.
    for pkg in (tf, jf):
        with pytest.raises(pkg.FactorError, match="cam_dim must be >= 1"):
            pkg.FactorSpec(name="bad", cam_dim=0, pt_dim=3, obs_dim=2,
                           residual_dim=2, residual_fn=lambda c, p, o: o)
        with pytest.raises(pkg.FactorError, match="pose_dim must be >= 1"):
            pkg.PoseFactorSpec(name="bad", pose_dim=0, meas_dim=6,
                               residual_dim=6,
                               residual_fn=lambda i, j, m: m)
    with pytest.raises(tf.FactorError, match="wants a FactorSpec"):
        tf.register_factor("bal")
    # A probe registers, resolves and unregisters.
    probe = tf.FactorSpec(name="_probe", cam_dim=2, pt_dim=2, obs_dim=1,
                          residual_dim=1, residual_fn=lambda c, p, o: o)
    tf.register_factor(probe)
    assert tf.get_factor("_probe") is probe is tf.get_factor(probe)
    tf.unregister_factor("_probe")
    with pytest.raises(tf.UnknownFactorError, match="_probe"):
        tf.get_factor("_probe")


def test_pipeline_refusals_match_jax():
    se3, bal = tf.get_factor("se3_between"), tf.get_factor("bal")
    # The same stem; each names its own pose-graph driver.
    t_msg = _message(tf.FactorError, require_schur, se3, "flat_solve")
    j_msg = _message(jf.FactorError, j_require_schur,
                     jf.get_factor("se3_between"), "flat_solve")
    stem = ("flat_solve: factor 'se3_between' is a pose-graph family (two "
            "same-kind blocks); solve it with")
    assert t_msg.startswith(stem) and j_msg.startswith(stem)
    assert "megba_tpu_torch.models.pgo.solve_pgo(factor=...)" in t_msg
    assert require_schur(bal, "x") is bal
    with pytest.raises(tf.FactorError, match="is a camera/point"):
        require_pose_graph(bal, "solve_pgo")
    assert require_pose_graph(se3, "solve_pgo") is se3


def test_engine_for_identity_and_refusals():
    A, F, N = (mt.JacobianMode.AUTODIFF, mt.JacobianMode.AUTODIFF_FORWARD,
               mt.JacobianMode.ANALYTICAL)
    assert tf.engine_for("bal") is make_residual_jacobian_fn()
    assert tf.engine_for("bal", A) is mt.make_residual_jacobian_fn(mode=A)
    assert tf.engine_for(tf.get_factor("bal"), F) is \
        make_residual_jacobian_fn(mode=F)
    assert tf.engine_for("rig") is tf.engine_for("rig")
    assert tf.engine_for("rig") is not tf.engine_for("pinhole_radial")
    assert (_message(tf.FactorError, tf.engine_for, "rig", N)
            == _message(jf.FactorError, jf.engine_for, "rig",
                        jc.JacobianMode.ANALYTICAL))
    with pytest.raises(tf.FactorError, match="pose-graph family"):
        tf.engine_for("sim3_between")
    # The BAL closed form through the registry: the analytical Jacobian,
    # and the value-only residual the LM loop costs trial points with.
    engine = tf.engine_for("bal", N)
    rows = _edge_rows("bal")
    want = _port(make_residual_jacobian_fn(mode=N), *rows)
    for g, w in zip(_port(engine, *rows), want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(_port(engine.residual, *rows)[0], want[0])


# ---------------------------------------------------------------------------
# Per-edge residuals and Jacobians
# ---------------------------------------------------------------------------


def _prior_rows_at_identity():
    """Pose-prior edges whose camera equals its prior (E_R = I, E_t = 0)
    beside perturbed ones, and small and zero rotations."""
    s = _scene("pose_prior", seed=3)
    cam = s.obs.copy()  # every camera at its prior
    cam[::3] += 1e-3 * np.random.default_rng(3).standard_normal(
        cam[::3].shape)
    cam[1, 0:3] = 0.0
    obs = s.obs.copy()
    obs[1, 0:3] = 0.0  # a prior and a camera both at zero rotation
    cam[2, 0:3] = obs[2, 0:3] + 1e-9  # under the log's series threshold
    return _fm(cam), _fm(np.zeros((cam.shape[0], 3))), _fm(obs)


@pytest.mark.parametrize("name", SCHUR + ["pose_prior_at_identity"])
def test_family_residual_and_autodiff_jacobian_match_jax(name):
    factor = "pose_prior" if name.startswith("pose_prior") else name
    rows = (_prior_rows_at_identity() if name == "pose_prior_at_identity"
            else _edge_rows(factor, seed=1))
    got = _port(tf.engine_for(factor), *rows)
    want = [np.asarray(a) for a in jf.engine_for(factor)(
        *(jnp.asarray(a) for a in rows))]
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        _close_per_row(g, w)
    np.testing.assert_array_equal(
        _port(tf.get_factor(factor).residual_fn, *rows)[0], got[0])
    if factor == "pose_prior":
        assert not got[2].any()  # the point side of a unary factor


@pytest.mark.parametrize("name", ["se3_between", "sim3_between"])
def test_pose_graph_residuals_match_jax(name):
    rng = np.random.default_rng(4)
    d = 6 if name == "se3_between" else 7
    n = 12
    pi, pj = rng.standard_normal((2, n, d)) * 0.4
    if name == "se3_between":
        meas = np.stack([np.asarray(_j_relative6(a, b))
                         for a, b in zip(pi, pj)])
    else:
        meas = j_sim3.relative_sim3(pi, pj)
        np.testing.assert_allclose(t_sim3.relative_sim3(pi, pj), meas,
                                   rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(
            t_sim3.compose_sim3(pi, t_sim3.relative_sim3(pi, pj)), pj,
            rtol=1e-12, atol=1e-12)
    meas[::2] += 0.05 * rng.standard_normal(meas[::2].shape)
    meas[1] = _j_relative6(pi[1], pj[1]) if d == 6 else \
        j_sim3.relative_sim3(pi[1], pj[1])  # an exact edge: E_R = I
    t_fn = tf.get_factor(name).residual_fn
    j_fn = jf.get_factor(name).residual_fn

    def t_edge(x, m):
        return t_fn(x[:d], x[d:], m)

    x = np.concatenate([pi, pj], axis=1)
    tr = t_fn(*(torch.from_numpy(_fm(a)) for a in (pi, pj, meas))).numpy()
    tj = torch.func.vmap(torch.func.jacrev(t_edge))(
        torch.from_numpy(x), torch.from_numpy(meas)).numpy()
    jr = np.asarray(jax.vmap(j_fn)(pi, pj, meas)).T
    jj = np.asarray(jax.vmap(jax.jacfwd(
        lambda x, m: j_fn(x[:d], x[d:], m)))(x, meas))
    _close_per_row(tr, jr)
    assert np.isfinite(tj).all()
    _close_per_row(tj.reshape(n, -1), jj.reshape(n, -1))
    assert np.abs(tr[:, 1]).max() < 1e-12


def _j_relative6(a, b):
    from megba_tpu.core.host_se3 import relative

    return relative(a, b)


def _rotations():
    """Angle-axis vectors: random, small (under and near the series
    thresholds), zero, and near pi about each axis (each quaternion
    pivot of the Shepperd construction)."""
    rng = np.random.default_rng(7)
    w = [rng.standard_normal(3) * s for s in (0.3, 1.0, 2.0)]
    w += [np.array([1e-7, -2e-7, 3e-8]), np.array([1e-5, 0.0, 2e-5]),
          np.zeros(3)]
    w += [np.pi * 0.999 * e for e in np.eye(3)]
    w += [np.array([0.0, 2.9, 0.4]), np.array([0.3, 0.2, -3.0])]
    return np.stack(w)


def test_geo_helpers_match_jax():
    w = _rotations()
    tw = torch.from_numpy(_fm(w))
    R_t = tgeo.angle_axis_to_rotation_matrix(tw).numpy()  # [3, 3, n]
    R_j = np.asarray(jax.vmap(jgeo.angle_axis_to_rotation_matrix)(w))
    np.testing.assert_allclose(np.moveaxis(R_t, -1, 0), R_j, rtol=0,
                               atol=1e-15)
    np.testing.assert_allclose(
        np.moveaxis(tgeo.skew(tw).numpy(), -1, 0),
        np.asarray(jax.vmap(jgeo.skew)(w)), atol=0)
    th = np.linspace(-3, 3, 7)
    np.testing.assert_allclose(
        np.moveaxis(tgeo.rotation2d_to_matrix(torch.from_numpy(th)).numpy(),
                    -1, 0),
        np.asarray(jax.vmap(jgeo.rotation2d_to_matrix)(th)), atol=1e-15)
    q_t = tgeo.rotation_matrix_to_quaternion(torch.from_numpy(R_t)).numpy()
    q_j = np.asarray(jax.vmap(jgeo.rotation_matrix_to_quaternion)(R_j))
    np.testing.assert_allclose(q_t.T, q_j, atol=1e-13)
    # Every pivot of the construction is taken at least once.
    tr = np.trace(R_j, axis1=1, axis2=2)
    scores = np.stack([tr, R_j[:, 0, 0], R_j[:, 1, 1], R_j[:, 2, 2]])
    assert set(np.argmax(scores, axis=0)) == {0, 1, 2, 3}
    aa_t = tgeo.rotation_matrix_to_angle_axis(torch.from_numpy(R_t)).numpy()
    aa_j = np.asarray(jax.vmap(jgeo.rotation_matrix_to_angle_axis)(R_j))
    np.testing.assert_allclose(aa_t.T, aa_j, atol=1e-12)
    np.testing.assert_allclose(aa_t.T, w, atol=1e-9)  # the round trip
    v = np.random.default_rng(1).standard_normal((5, 4))
    np.testing.assert_allclose(
        tgeo.normalize(torch.from_numpy(v.T)).numpy().T,
        np.asarray(jax.vmap(jgeo.normalize)(v)), atol=1e-15)
    a = np.random.default_rng(2).standard_normal((3, 4, 2))
    b = np.random.default_rng(3).standard_normal((4, 2, 2))
    np.testing.assert_allclose(
        tgeo.mm(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.einsum("ikn,kjn->ijn", a, b), rtol=1e-14)


def test_log_map_gradient_is_finite_at_identity():
    """The double-where of `quaternion_to_angle_axis`: reverse- and
    forward-mode derivatives of the log map are finite at R = I and as
    n -> 0, and match the JAX package's."""
    w = np.array([[0.0, 0.0, 0.0], [1e-9, -2e-9, 1e-9], [0.2, 0.1, -0.3]])

    def t_log(v):
        return tgeo.rotation_matrix_to_angle_axis(
            tgeo.angle_axis_to_rotation_matrix(v))

    def j_log(v):
        return jgeo.rotation_matrix_to_angle_axis(
            jgeo.angle_axis_to_rotation_matrix(v))

    for v in w:
        tv = torch.from_numpy(v)
        jr = torch.func.jacrev(t_log)(tv).numpy()
        jfw = torch.func.jacfwd(t_log)(tv).numpy()
        want = np.asarray(jax.jacfwd(j_log)(v))
        assert np.isfinite(jr).all() and np.isfinite(jfw).all()
        np.testing.assert_allclose(jr, want, atol=1e-9)
        np.testing.assert_allclose(jfw, want, atol=1e-9)


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["planar", "rig", "pinhole_radial",
                                  "pose_prior"])
def test_generators_match_jax(name):
    t = _scene(name, seed=2)
    j = {"planar": lambda: j_planar.make_synthetic_planar(6, 40, 3, seed=2),
         "rig": lambda: j_rig.make_synthetic_rig(6, 40, 2, 2, seed=2),
         "pinhole_radial": lambda: j_radial.make_synthetic_radial(
             6, 40, 3, seed=2),
         "pose_prior": lambda: j_priors.make_synthetic_priors(
             8, 2, prior_noise=0.01, seed=2)}[name]()
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-13,
                                       err_msg=f.name)


# ---------------------------------------------------------------------------
# flat_solve(factor=...)
# ---------------------------------------------------------------------------


def _options():
    kw = dict(max_iter=LM_CAP, epsilon1=1e-12, epsilon2=1e-15)
    return (jc.ProblemOption(algo_option=jc.AlgoOption(**kw)),
            mt.ProblemOption(algo_option=mt.AlgoOption(**kw)))


@functools.lru_cache(maxsize=None)
def _jax_solve(name):
    s = _scene(name)
    jopt, _ = _options()
    return j_flat_solve(None, s.cameras0, s.points0, s.obs, s.cam_idx,
                        s.pt_idx, jopt, factor=name)


@pytest.mark.parametrize("name", SCHUR)
def test_flat_solve_factor_matches_jax(name):
    s = _scene(name)
    _, topt = _options()
    tres = mt.flat_solve(s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
                         topt, device="cpu", factor=name)
    jres = _jax_solve(name)
    assert int(jres.iterations) >= (2 if name == "pose_prior" else LM_CAP)
    t = _compare(jres, tres, cost_rtol=1e-9)
    spec = tf.get_factor(name)
    assert t["cameras"].shape == (s.cameras0.shape[0], spec.cam_dim)
    np.testing.assert_allclose(t["cameras"], np.asarray(jres.cameras),
                               rtol=1e-8, atol=1e-10)
    if name == "pose_prior":  # the dummy point never moves
        np.testing.assert_array_equal(t["points"], s.points0)


def test_flat_solve_factor_typed_errors_before_any_device_work():
    s = _scene("rig")
    _, topt = _options()
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx, topt)
    jargs = (None, s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
             _options()[0])
    # No device is needed to refuse: the default device (the card) is
    # never reached.
    with pytest.raises(tf.UnknownFactorError):
        mt.flat_solve(*args, factor="nope")
    with pytest.raises(tf.FactorError, match="pose-graph family"):
        mt.flat_solve(*args, factor="se3_between")
    assert (_message(tf.FactorError, mt.flat_solve, *args, factor="bal")
            == _message(jf.FactorError, j_flat_solve, *jargs, factor="bal"))
    # The robust refusal of a robust_ok=False family, in the JAX words.
    p = _scene("pose_prior")
    t_huber = dataclasses.replace(topt, robust_kind=mt.RobustKind.HUBER)
    j_huber = dataclasses.replace(_options()[0],
                                  robust_kind=JRobustKind.HUBER)
    pa = (p.cameras0, p.points0, p.obs, p.cam_idx, p.pt_idx)
    assert (_message(tf.FactorError, mt.flat_solve, *pa, t_huber,
                     factor="pose_prior")
            == _message(jf.FactorError, j_flat_solve, None, *pa, j_huber,
                        factor="pose_prior"))
    # validate_factor_arrays alone.
    tf.validate_factor_arrays(tf.get_factor("rig"), s.cameras0, s.points0,
                              s.obs)
    with pytest.raises(tf.FactorError,
                       match=r"points width 3 \(factor wants 2\)"):
        tf.validate_factor_arrays(tf.get_factor("planar"), s.cameras0[:, :4],
                                  s.points0, s.obs[:, :1])


def test_refuse_ratio_defaults_resolve_as_in_jax():
    so = mt.SolverOption()
    sim3, se3 = tf.get_factor("sim3_between"), tf.get_factor("se3_between")
    assert resolve_refuse_ratio(sim3, so) == 16.0
    assert resolve_refuse_ratio(
        sim3, dataclasses.replace(so, refuse_ratio=4.0)) == 4.0
    assert resolve_refuse_ratio(se3, so) == so.refuse_ratio
    _, opt = _options()
    assert apply_factor_solver_defaults(se3, opt) is opt
    resolved = apply_factor_solver_defaults(sim3, opt)
    assert resolved.solver_option.refuse_ratio == 16.0
    assert dataclasses.replace(resolved,
                               solver_option=opt.solver_option) == opt
    assert j_apply_defaults(jf.get_factor("sim3_between"), _options()[0]) \
        .solver_option.refuse_ratio == 16.0
    # A Schur family that declares a default gets it at flat_solve: the
    # solve of a BAL clone with refuse_ratio 1e30 is the solve with
    # SolverOption(refuse_ratio=1e30).
    clone = dataclasses.replace(tf.get_factor("bal"), name="_bal_refuse",
                                refuse_ratio=1e30)
    tf.register_factor(clone)
    try:
        s = _scene("bal")
        a = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
        got = mt.flat_solve(*a, opt, device="cpu", factor="_bal_refuse")
        want = mt.flat_solve(*a, dataclasses.replace(
            opt, solver_option=dataclasses.replace(
                opt.solver_option, refuse_ratio=1e30)), device="cpu")
        assert torch.equal(got.trace.cost, want.trace.cost)
    finally:
        tf.unregister_factor("_bal_refuse")


def test_to_torch_takes_the_factor_widths():
    s = _scene("rig")
    si = np.tile(np.eye(2), (s.obs.shape[0], 1, 1))
    t = to_torch(s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx, si,
                 device="cpu", factor="rig")
    assert t["cameras"].shape == (7, 6) and t["obs"].shape == (8, len(s.obs))
    assert t["sqrt_info"].shape == (4, len(s.obs))
    with pytest.raises(ValueError, match="expected 9 feature rows"):
        to_torch(s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
                 device="cpu")
    with pytest.raises(tf.FactorError, match="pose-graph"):
        to_torch(s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
                 device="cpu", factor="se3_between")


def test_between_residual_is_registered_and_pgo_matches():
    assert tf.get_factor("se3_between").residual_fn is \
        t_pose_graph.between_residual
    assert jf.get_factor("se3_between").residual_fn is \
        j_pgo.between_residual

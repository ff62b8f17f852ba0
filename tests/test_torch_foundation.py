"""Port foundation vs the JAX package: options, status codes, host input,
layout helpers and compensated sums.  Inputs come from numpy seeds and
go through both packages; CPU only."""

import dataclasses
import enum
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import megba_tpu.common as jc
from megba_tpu.core import fm as jfm
from megba_tpu.core.types import is_cam_sorted as j_is_cam_sorted
from megba_tpu.core.types import pad_edges as j_pad_edges
from megba_tpu.io.bal import loads_bal as j_loads_bal
from megba_tpu.io.synthetic import make_synthetic_bal as j_make
from megba_tpu.ops.accum import comp_dot as j_comp_dot
from megba_tpu.ops.accum import comp_sum as j_comp_sum

import megba_tpu_torch.common as tc
from megba_tpu_torch.core import fm as tfm
from megba_tpu_torch.core.types import is_cam_sorted, pad_edges
from megba_tpu_torch.io.bal import load_bal, loads_bal, save_bal
from megba_tpu_torch.io.synthetic import make_synthetic_bal
from megba_tpu_torch.ops.accum import comp_dot, comp_sum

REPO = Path(__file__).resolve().parents[1]


def _same_value(a, b):
    if hasattr(a, "name") and hasattr(a, "value"):
        return a.name == b.name and a.value == b.value
    if dataclasses.is_dataclass(a):
        return all(_same_value(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return a == b


@pytest.mark.parametrize("name", ["SolverOption", "AlgoOption",
                                  "RobustOption", "ProblemOption"])
def test_option_defaults_equal_field_by_field(name):
    j_opt, t_opt = getattr(jc, name)(), getattr(tc, name)()
    j_fields = [f.name for f in dataclasses.fields(j_opt)]
    assert [f.name for f in dataclasses.fields(t_opt)] == j_fields
    for f in j_fields:
        a, b = getattr(j_opt, f), getattr(t_opt, f)
        if name == "ProblemOption" and f == "device":
            # The one deliberate difference: the port's default backend.
            assert (a.name, b.name) == ("TPU", "CUDA")
            continue
        if name == "ProblemOption" and f == "dtype":
            assert np.dtype(a) == np.dtype(b)
            continue
        assert _same_value(a, b), (name, f, a, b)


@pytest.mark.parametrize("enum_name", [
    "AlgoKind", "LinearSystemKind", "ComputeKind", "SolverKind",
    "JacobianMode", "PrecondKind", "EdgeOrder", "PreconditionerKind",
    "SolveStatus"])
def test_enum_codes_equal(enum_name):
    j_enum, t_enum = getattr(jc, enum_name), getattr(tc, enum_name)
    assert [(m.name, m.value) for m in j_enum] == [
        (m.name, m.value) for m in t_enum]


def test_robust_kind_and_status_names():
    from megba_tpu.ops.robust import RobustKind as JRK

    assert [(m.name, m.value) for m in JRK] == [
        (m.name, m.value) for m in tc.RobustKind]
    for code in range(6):
        assert tc.status_name(code) == jc.status_name(code)


@pytest.mark.parametrize("field,value", [
    ("use_schur", False),
    ("world_size", 2),
    ("solver_option", tc.SolverOption(fused_kernels=True, bf16=True,
                                      bf16_collectives=True)),
    ("jacobian_mode", tc.JacobianMode.AUTODIFF),
    ("jacobian_mode", tc.JacobianMode.AUTODIFF_FORWARD),
    ("mixed_precision_pcg", True),
    ("robust_kind", tc.RobustKind.HUBER),
    ("robust_option", tc.RobustOption(guards=True)),
    ("solver_option", tc.SolverOption(precond=tc.PrecondKind.NEUMANN)),
    ("solver_option", tc.SolverOption(
        preconditioner=tc.PreconditionerKind.SCHUR_DIAG)),
    ("solver_option", tc.SolverOption(forcing=True)),
    ("solver_option", tc.SolverOption(warm_start=True)),
    ("solver_option", tc.SolverOption(mesh_2d=True)),
    ("solver_option", tc.SolverOption(edge_order=tc.EdgeOrder.COOBS)),
    ("solver_option", tc.SolverOption(bf16=True, bf16_collectives=True)),
    ("solver_option", tc.SolverOption(fused_kernels=True, mesh_2d=True)),
    ("telemetry", "t.jsonl"),
    ("metrics", True),
    ("solver_option", tc.SolverOption(precond=tc.PrecondKind.TWO_LEVEL)),
    ("solver_option", tc.SolverOption(precond=tc.PrecondKind.MULTILEVEL)),
    ("solver_option", tc.SolverOption(forcing=True, mesh_2d=True)),
])
def test_unported_options_raise_typed(field, value):
    # float32: the bf16 rung exists at f32 only (f64 is a ValueError);
    # the fused kernels, the whole precision ladder and the multi-device
    # options (world_size, mesh_2d, bf16_collectives) are ported, as are
    # mixed_precision_pcg, both autodiff Jacobian modes, the robust
    # losses, forcing and warm starts, guards, the plain solver, COOBS,
    # SCHUR_DIAG, NEUMANN, TWO_LEVEL and MULTILEVEL, the JSONL telemetry
    # and the metrics plane: they validate.  Nothing is refused.
    base = dict(jacobian_mode=tc.JacobianMode.ANALYTICAL, dtype=np.float32)
    base[field] = value
    if (field, value) in _PORTED:
        tc.validate_options(tc.ProblemOption(**base))
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        tc.validate_options(tc.ProblemOption(**base))


_PORTED = [
    ("mixed_precision_pcg", True),
    ("jacobian_mode", tc.JacobianMode.AUTODIFF),
    ("jacobian_mode", tc.JacobianMode.AUTODIFF_FORWARD),
    ("robust_kind", tc.RobustKind.HUBER),
    ("solver_option", tc.SolverOption(forcing=True)),
    ("solver_option", tc.SolverOption(warm_start=True)),
    ("use_schur", False),
    ("robust_option", tc.RobustOption(guards=True)),
    ("solver_option", tc.SolverOption(precond=tc.PrecondKind.NEUMANN)),
    ("solver_option", tc.SolverOption(
        preconditioner=tc.PreconditionerKind.SCHUR_DIAG)),
    ("solver_option", tc.SolverOption(edge_order=tc.EdgeOrder.COOBS)),
    ("solver_option", tc.SolverOption(precond=tc.PrecondKind.TWO_LEVEL)),
    ("solver_option", tc.SolverOption(precond=tc.PrecondKind.MULTILEVEL)),
    ("world_size", 2),
    ("solver_option", tc.SolverOption(fused_kernels=True, bf16=True,
                                      bf16_collectives=True)),
    ("solver_option", tc.SolverOption(mesh_2d=True)),
    ("solver_option", tc.SolverOption(bf16=True, bf16_collectives=True)),
    ("solver_option", tc.SolverOption(fused_kernels=True, mesh_2d=True)),
    ("solver_option", tc.SolverOption(forcing=True, mesh_2d=True)),
    ("telemetry", "t.jsonl"),
    ("metrics", True),
]


@pytest.mark.parametrize("kw,refused", [
    # Guards, use_schur=False, NEUMANN, TWO_LEVEL, MULTILEVEL, the
    # multi-device options, telemetry and (since the metrics plane is
    # ported) metrics: each case held metrics, the last refused option,
    # beside them.  Nothing is refused any more, so each case validates
    # in both packages (its id is the case's old one).
    pytest.param(dict(robust_kind=tc.RobustKind.HUBER,
                      robust_option=tc.RobustOption(guards=True),
                      world_size=2, telemetry="t.jsonl", metrics=True,
                      solver_option=tc.SolverOption(
                          precond=tc.PrecondKind.TWO_LEVEL)),
                 None, id="kw0-guards"),
    pytest.param(dict(robust_kind=tc.RobustKind.CAUCHY, metrics=True,
                      solver_option=tc.SolverOption(
                          mesh_2d=True, edge_order=tc.EdgeOrder.COOBS)),
                 None, id="kw1-use_schur"),
    pytest.param(dict(jacobian_mode=tc.JacobianMode.AUTODIFF, world_size=2,
                      telemetry="t.jsonl", metrics=True), None,
                 id="kw2-telemetry"),
    pytest.param(dict(metrics=True, solver_option=tc.SolverOption(
        warm_start=True, precond=tc.PrecondKind.MULTILEVEL, mesh_2d=True,
        preconditioner=tc.PreconditionerKind.SCHUR_DIAG)), None,
        id="kw3-precond"),
])
def test_still_refused_beside_ported_options(kw, refused):
    assert refused is None
    tc.validate_options(tc.ProblemOption(**kw))
    jc.validate_options(_to_jax_option(kw))


def _to_jax_option(kw):
    """The JAX package's ProblemOption of the same keyword values (enums
    and nested options by name)."""
    from megba_tpu.ops import robust as jrobust

    def conv(v):
        if isinstance(v, enum.Enum):
            home = jrobust if type(v).__name__ == "RobustKind" else jc
            return getattr(home, type(v).__name__)[v.name]
        if dataclasses.is_dataclass(v):
            return getattr(jc, type(v).__name__)(
                **{f.name: conv(getattr(v, f.name))
                   for f in dataclasses.fields(v)})
        return v

    return jc.ProblemOption(**{k: conv(v) for k, v in kw.items()})


def test_option_value_errors():
    """The JAX package's ValueErrors on the newly ported options."""
    with pytest.raises(ValueError, match="eta_min must be > 0"):
        tc.validate_options(tc.ProblemOption(
            solver_option=tc.SolverOption(eta_min=0.0)))
    with pytest.raises(ValueError, match="eta_min <= tol"):
        tc.validate_options(tc.ProblemOption(
            solver_option=tc.SolverOption(forcing=True, tol=1e-8)))
    with pytest.raises(ValueError, match="jacobian_mode must be"):
        tc.validate_options(tc.ProblemOption(
            jacobian_mode=jc.JacobianMode.AUTODIFF))
    for kw in (dict(), dict(robust_kind=tc.RobustKind.CAUCHY),
               dict(solver_option=tc.SolverOption(forcing=True,
                                                  warm_start=True))):
        tc.validate_options(tc.ProblemOption(**kw))
    # The ValueErrors of guards, the plain solver and NEUMANN, each equal
    # to the JAX package's.
    for kw, msg in (
            (dict(solver_option=tc.SolverOption(
                precond=tc.PrecondKind.NEUMANN, neumann_order=0)),
             "neumann_order must be >= 1"),
            (dict(use_schur=False, solver_option=tc.SolverOption(
                precond=tc.PrecondKind.NEUMANN)), "precond=NEUMANN"),
            (dict(robust_option=tc.RobustOption(max_recoveries=0)),
             "max_recoveries must be >= 1"),
            (dict(robust_option=tc.RobustOption(damping_inflation=1.0)),
             "damping_inflation must be > 1"),
            (dict(robust_option=tc.RobustOption(pcg_max_restarts=-1)),
             "pcg_max_restarts must be >= 0"),
            # The coarse families' knobs.
            (dict(solver_option=tc.SolverOption(
                precond=tc.PrecondKind.TWO_LEVEL, coarse_clusters=-1)),
             "coarse_clusters must be >= 0"),
            (dict(solver_option=tc.SolverOption(
                precond=tc.PrecondKind.MULTILEVEL, coarsen_factor=1.0)),
             "coarsen_factor must be > 1"),
            (dict(solver_option=tc.SolverOption(
                precond=tc.PrecondKind.MULTILEVEL, max_levels=16)),
             r"max_levels must be in \[2, 15\]"),
            (dict(solver_option=tc.SolverOption(
                precond=tc.PrecondKind.TWO_LEVEL, smooth_omega=2.0)),
             r"smooth_omega must be in \[0, 2\)"),
            (dict(solver_option=tc.SolverOption(smooth_omega=0.5)),
             "requires precond=TWO_LEVEL or MULTILEVEL")):
        with pytest.raises(ValueError, match=msg):
            tc.validate_options(tc.ProblemOption(**kw))
        jkw = {k: (getattr(jc, type(v).__name__)(**{
            f.name: (getattr(jc, type(getattr(v, f.name)).__name__)[
                getattr(v, f.name).name]
                if isinstance(getattr(v, f.name), enum.Enum)
                else getattr(v, f.name)) for f in dataclasses.fields(v)})
            if dataclasses.is_dataclass(v) else v) for k, v in kw.items()}
        with pytest.raises(ValueError, match=msg):
            jc.validate_options(jc.ProblemOption(**jkw))


def test_supported_option_validates():
    tc.validate_options(tc.ProblemOption(
        jacobian_mode=tc.JacobianMode.ANALYTICAL, dtype=np.float32))


@pytest.mark.parametrize("kw", [
    dict(num_cameras=6, num_points=40, obs_per_point=3, seed=0),
    dict(num_cameras=9, num_points=150, obs_per_point=3.4, seed=5,
         dtype=np.float32),
    dict(num_cameras=12, num_points=90, obs_per_point=4, seed=11,
         n_orphan_points=2, n_behind_camera=1, n_disconnect=1),
    dict(num_cameras=10, num_points=60, obs_per_point=3, seed=3,
         locality="ring"),
])
def test_make_synthetic_bal_byte_identical(kw):
    a, b = j_make(**kw), make_synthetic_bal(**kw)
    for f in ("cameras_gt", "points_gt", "cameras0", "points0", "obs",
              "cam_idx", "pt_idx"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes(), f


def test_pad_edges_and_cam_sorted_match():
    rng = np.random.default_rng(2)
    obs = rng.standard_normal((37, 2))
    ci = np.sort(rng.integers(0, 5, 37)).astype(np.int32)
    pi = rng.integers(0, 20, 37).astype(np.int32)
    for mult in (1, 16, 64):
        for x, y in zip(j_pad_edges(obs, ci, pi, mult),
                        pad_edges(obs, ci, pi, mult)):
            np.testing.assert_array_equal(x, y)
    assert is_cam_sorted(ci) == j_is_cam_sorted(ci) is True
    assert is_cam_sorted(pi) == j_is_cam_sorted(pi)


def test_bal_roundtrip_matches(tmp_path):
    s = make_synthetic_bal(num_cameras=5, num_points=30, seed=4)
    from megba_tpu_torch.io.bal import BALFile

    bal = BALFile(cameras=s.cameras0, points=s.points0, obs=s.obs,
                  cam_idx=s.cam_idx, pt_idx=s.pt_idx)
    path = tmp_path / "p.txt"
    save_bal(path, bal)
    text = path.read_text()
    mine, ref = loads_bal(text), j_loads_bal(text)
    for f in ("cameras", "points", "obs", "cam_idx", "pt_idx"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f))
        np.testing.assert_array_equal(getattr(mine, f), getattr(bal, f))
    import bz2

    bz = tmp_path / "p.txt.bz2"
    bz.write_bytes(bz2.compress(text.encode()))
    for loaded in (load_bal(path), load_bal(bz)):
        np.testing.assert_array_equal(loaded.obs, bal.obs)
        np.testing.assert_array_equal(loaded.cameras, bal.cameras)


def test_bal_rejects_duplicates_and_bad_counts():
    with pytest.raises(ValueError, match="duplicate"):
        loads_bal("1 1 2\n0 0 1 2\n0 0 1 2\n" + "0 " * 9 + "0 0 0")
    with pytest.raises(ValueError, match="token count"):
        loads_bal("1 1 1\n0 0 1 2\n")


def test_fm_helpers_match():
    rng = np.random.default_rng(8)
    n = 50
    A = rng.standard_normal((3, 3, n))
    H = np.einsum("ikn,jkn->ijn", A, A).reshape(9, n) + 3 * np.eye(3).reshape(9, 1)
    x = rng.standard_normal((3, n))
    region = 7.5
    T = torch.from_numpy
    np.testing.assert_allclose(
        tfm.block_inv_fm(T(H)).numpy(), np.asarray(jfm.block_inv_fm(jnp.asarray(H))),
        rtol=1e-12)
    np.testing.assert_allclose(
        tfm.block_matvec_fm(T(H), T(x)).numpy(),
        np.asarray(jfm.block_matvec_fm(jnp.asarray(H), jnp.asarray(x))), rtol=1e-12)
    np.testing.assert_allclose(
        tfm.damp_rows_fm(T(H), torch.tensor(region, dtype=torch.float64)).numpy(),
        np.asarray(jfm.damp_rows_fm(jnp.asarray(H), jnp.asarray(region))), rtol=1e-15)
    Jc, Jp = rng.standard_normal((18, n)), rng.standard_normal((6, n))
    np.testing.assert_allclose(
        tfm.coupling_rows(T(Jc), T(Jp), 2).numpy(),
        np.asarray(jfm.coupling_rows(jnp.asarray(Jc), jnp.asarray(Jp), 2)), rtol=1e-13)
    idx = rng.integers(0, 7, n)
    np.testing.assert_allclose(
        tfm.segsum_fm(T(x), T(idx), 7).numpy(),
        np.asarray(jfm.segsum_fm(jnp.asarray(x), jnp.asarray(idx), 7)), rtol=1e-12)
    np.testing.assert_array_equal(
        tfm.gather_fm(T(H), T(idx)).numpy(),
        np.asarray(jfm.gather_fm(jnp.asarray(H), jnp.asarray(idx))))


@pytest.mark.parametrize("n", [1, 100, 128, 1000, 40_003])
def test_comp_sum_matches_jax_f32(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    exact = float(np.sum(x.astype(np.float64)))
    got = float(comp_sum(torch.from_numpy(x)))
    ref = float(j_comp_sum(jnp.asarray(x)))
    scale = float(np.sum(np.abs(x.astype(np.float64)))) + 1e-30
    assert abs(got - exact) <= 2e-7 * scale
    assert abs(got - ref) <= 2e-7 * scale
    got_d = float(comp_dot(torch.from_numpy(x), torch.from_numpy(y)))
    ref_d = float(j_comp_dot(jnp.asarray(x), jnp.asarray(y)))
    assert abs(got_d - ref_d) <= 2e-7 * (
        float(np.sum(np.abs(x.astype(np.float64) * y))) + 1e-30)


def test_resolve_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.resolve_device(None, tc.ProblemOption())
    assert tc.resolve_device("cpu").type == "cpu"
    assert tc.resolve_device(
        None, tc.ProblemOption(device=tc.Device.CPU)).type == "cpu"


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, megba_tpu_torch as m\n"
        "for i in pkgutil.walk_packages(m.__path__, 'megba_tpu_torch.'):\n"
        "    importlib.import_module(i.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'megba_tpu' or k.startswith('megba_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith('megba_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")

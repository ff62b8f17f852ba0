"""The port's BAL CLIs and planar demo run end to end on the CPU.

Each of the six megba_tpu_torch/examples/BAL_*.py and planar_demo.py
runs as a real subprocess (argv parsing and __main__ included, one
intra-op thread) with `--device cpu`, on the tiny synthetic scene of the
JAX package's tests/test_examples.py (`_TINY_BAL`; the planar demo on its
own scene), and one BAL CLI also on a `--path` file and at world size 2.  Each prints JAX's `solving:` / `Finished:` lines
(or the planar demo's `planar BA: cost` line) and its final cost in full
precision, which is held to the JAX package's `flat_solve` with the same
options on the same scene: float64 at rtol 1e-9, float32 on the cost
alone at rtol 1e-3.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import megba_tpu.common as jc
from megba_tpu.io.bal import BALFile as JBALFile
from megba_tpu.io.bal import save_bal as j_save_bal
from megba_tpu.io.synthetic import make_synthetic_bal as j_make_synthetic_bal
from megba_tpu.models import planar as jplanar
from megba_tpu.ops.residuals import make_residual_jacobian_fn as j_engine
from megba_tpu.solve import flat_solve as j_flat_solve

from megba_tpu_torch.models import planar as tplanar

from test_examples import _TINY_BAL, _final_cost

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

# name -> (dtype, JacobianMode, ComputeKind): examples/README.md's table.
CLIS = {
    "BAL_Double": (np.float64, "AUTODIFF", "EXPLICIT"),
    "BAL_Float": (np.float32, "AUTODIFF", "EXPLICIT"),
    "BAL_Double_analytical": (np.float64, "ANALYTICAL", "EXPLICIT"),
    "BAL_Float_analytical": (np.float32, "ANALYTICAL", "EXPLICIT"),
    "BAL_Double_implicit": (np.float64, "AUTODIFF", "IMPLICIT"),
    "BAL_Double_analytical_implicit": (np.float64, "ANALYTICAL", "IMPLICIT"),
}
_EXACT = re.compile(r"^final cost: (\S+)$", re.MULTILINE)


def _run(script, args, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable,
         os.path.join(_ROOT, "megba_tpu_torch", "examples", script), *args,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=timeout, cwd=_ROOT, env=env)
    assert proc.returncode == 0, (
        f"{script} failed (rc={proc.returncode}):\n{proc.stderr[-2000:]}")
    return proc.stdout


def _exact_cost(out) -> float:
    (text,) = _EXACT.findall(out)
    return float(text)


def _jax_parser():
    """The JAX package's examples/common.py argument parser."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_jax_examples_common", os.path.join(_ROOT, "examples", "common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_arg_parser()


def _cli_args(argv):
    """The CLI's options from its argv, as the JAX package's
    examples/common.py builds them."""
    return _jax_parser().parse_args(argv)


def test_cli_flags_are_jax():
    """The port's flags and defaults are the JAX package's, plus
    --device."""
    from megba_tpu_torch.examples.common import build_arg_parser

    theirs = vars(_jax_parser().parse_args([]))
    ours = vars(build_arg_parser().parse_args([]))
    assert ours.pop("device") is None
    assert ours == theirs


def _jax_cost(name, argv, path=None):
    dtype, jm, ck = CLIS[name]
    args = _cli_args(argv)
    if path is not None:
        from megba_tpu.io.bal import load_bal

        b = load_bal(path, dtype=dtype)
        arrays = (b.cameras, b.points, b.obs, b.cam_idx, b.pt_idx)
    else:
        s = j_make_synthetic_bal(
            num_cameras=args.synthetic_cameras,
            num_points=args.synthetic_points,
            obs_per_point=args.synthetic_obs_per_point, seed=0,
            param_noise=2e-2, pixel_noise=0.5, dtype=dtype)
        arrays = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    option = jc.ProblemOption(
        dtype=dtype, world_size=args.world_size,
        compute_kind=getattr(jc.ComputeKind, ck),
        jacobian_mode=getattr(jc.JacobianMode, jm),
        algo_option=jc.AlgoOption(
            max_iter=args.max_iter, initial_region=args.tau,
            epsilon1=args.epsilon1, epsilon2=args.epsilon2),
        solver_option=jc.SolverOption(
            max_iter=args.solver_max_iter, tol=args.solver_tol,
            refuse_ratio=args.solver_refuse_ratio))
    f = j_engine(mode=getattr(jc.JacobianMode, jm))
    return float(j_flat_solve(f, *arrays, option).cost)


def _hold(name, got, want):
    dtype = CLIS[name][0]
    rtol = 1e-9 if dtype == np.float64 else 1e-3
    np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("name", list(CLIS))
def test_bal_cli_matches_jax(name):
    out = _run(f"{name}.py", _TINY_BAL)
    assert out.startswith("solving: 4 cameras, 40 points")
    dtype, jm, ck = CLIS[name]
    assert (f"dtype={np.dtype(dtype).name} jacobian={jm} compute={ck} "
            "world_size=1") in out
    c0, c1 = _final_cost(out, "Finished")[:2]
    assert c1 <= c0
    assert "iter 0: cost" in out
    _hold(name, _exact_cost(out), _jax_cost(name, _TINY_BAL))


def test_bal_cli_on_a_path(tmp_path):
    s = j_make_synthetic_bal(num_cameras=5, num_points=50, obs_per_point=3,
                             seed=11, param_noise=2e-2, pixel_noise=0.5)
    path = str(tmp_path / "scene.txt")
    j_save_bal(path, JBALFile(cameras=s.cameras0, points=s.points0,
                              obs=s.obs, cam_idx=s.cam_idx, pt_idx=s.pt_idx))
    name = "BAL_Double_analytical_implicit"
    argv = ["--path", path, "--max_iter", "3"]
    out = _run(f"{name}.py", argv)
    assert out.startswith("solving: 5 cameras, 50 points")
    _hold(name, _exact_cost(out), _jax_cost(name, argv, path=path))


def test_bal_cli_world2_on_cpu():
    out = _run("BAL_Float_analytical.py", _TINY_BAL + ["--world_size", "2"])
    assert "world_size=2" in out
    _hold("BAL_Float_analytical", _exact_cost(out),
          _jax_cost("BAL_Float_analytical", _TINY_BAL))


def test_planar_demo_matches_jax():
    """At the demo's own scene (12 cameras, 200 points) and 3 LM
    iterations.  Its PCG (tol 1e-12, no refusal) on a smaller scene runs
    CG past the Schur system's dimension, where two summation orders part
    by ~1e-7 in the cost; here they agree to ~1e-11."""
    out = _run("planar_demo.py", ["--max_iter", "3"])
    c0, c1 = _final_cost(out, "planar BA: cost")[:2]
    assert c1 < c0
    # The JAX solve runs on the port's scene: the two generators' float64
    # projections differ in the last bits.
    s = tplanar.make_synthetic_planar(num_cameras=12, num_points=200,
                                      obs_per_point=5, noise=0.2,
                                      param_noise=3e-2, seed=0)
    f = j_engine(residual_fn=jplanar.residual,
                 mode=jc.JacobianMode.AUTODIFF)
    option = jc.ProblemOption(
        algo_option=jc.AlgoOption(max_iter=3, epsilon1=1e-10,
                                  epsilon2=1e-13),
        solver_option=jc.SolverOption(max_iter=150, tol=1e-12,
                                      refuse_ratio=1e30))
    want = float(j_flat_solve(f, s.cameras0, s.points0, s.obs, s.cam_idx,
                              s.pt_idx, option).cost)
    np.testing.assert_allclose(_exact_cost(out), want, rtol=1e-9)

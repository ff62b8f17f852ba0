"""The port's pose-graph CLIs run end to end on tiny graphs on the CPU.

Each of megba_tpu_torch/examples/pgo_demo.py and PGO_g2o.py runs as a
real subprocess (argv parsing and __main__ included) with `--device
cpu`, as tests/test_examples.py runs the JAX package's, and its
`PGO: cost` line must carry finite costs.
"""

import os
import subprocess
import sys

from test_examples import _final_cost

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _run(script, args, timeout=240):
    proc = subprocess.run(
        [sys.executable,
         os.path.join(_ROOT, "megba_tpu_torch", "examples", script), *args,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=timeout, cwd=_ROOT)
    assert proc.returncode == 0, (
        f"{script} failed (rc={proc.returncode}):\n{proc.stderr[-2000:]}")
    return proc.stdout


def test_torch_pgo_demo_runs():
    out = _run("pgo_demo.py", ["--num_poses", "10", "--loop_closures",
                               "2", "--max_iter", "5", "--priors", "2"])
    c0, c1 = _final_cost(out, "PGO: cost")[:2]
    assert c1 <= c0
    assert "max pose drift (SE3)" in out


def test_torch_pgo_g2o_example_runs(tmp_path):
    out_path = str(tmp_path / "solved.g2o")
    out = _run("PGO_g2o.py", ["--synthetic_poses", "10",
                              "--synthetic_loop_closures", "2",
                              "--max_iter", "5", "--world_size", "2",
                              "--out", out_path])
    c0, c1 = _final_cost(out, "PGO: cost")[:2]
    assert c1 < c0
    assert os.path.exists(out_path)
    from megba_tpu_torch.io.g2o import read_g2o

    assert read_g2o(out_path).poses.shape == (10, 6)

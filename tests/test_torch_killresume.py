"""Preemption safety of the port's chunked driver, with a real process
death.

`scripts/torch_killresume_worker.py` runs a seeded checkpointed solve on
the CPU.  The reference is one uninterrupted run; the second run is
SIGKILLed by the harness (robustness/harness.py) the moment its first
snapshot lands, while its second chunk computes, and then resumed to
completion.  Parameters, counts and the stitched trace must be bitwise
the reference's.  CPU only.
"""

import os
from pathlib import Path

import numpy as np
import torch

from megba_tpu_torch.robustness.harness import (
    python_worker,
    run_to_completion,
    run_until_snapshot_then_kill,
)
from megba_tpu_torch.utils.checkpoint import load_state

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

WORKER = str(Path(__file__).resolve().parents[1] / "scripts"
             / "torch_killresume_worker.py")


def _result(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_sigkill_mid_chunk_resume_is_bitwise_identical(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    ck_a, out_a = str(tmp_path / "a.npz"), str(tmp_path / "a_result.npz")
    run_to_completion(python_worker(WORKER, ck_a, out_a, "--device", "cpu"),
                      env=env)

    ck_b, out_b = str(tmp_path / "b.npz"), str(tmp_path / "b_result.npz")
    argv = python_worker(WORKER, ck_b, out_b, "--device", "cpu")
    rc = run_until_snapshot_then_kill(argv, ck_b, env=env)
    assert rc != 0  # killed, not exited
    assert not os.path.exists(out_b)  # died before finishing
    st = load_state(ck_b)  # the surviving snapshot is valid and complete
    assert int(st["iteration"]) >= 2
    run_to_completion(argv, env=env)

    a, b = _result(out_a), _result(out_b)
    assert set(a) == set(b)
    assert int(a["iterations"]) == 8 and int(a["accepted"]) >= 1
    for key in sorted(a):
        assert a[key].dtype == b[key].dtype, key
        assert np.array_equal(a[key], b[key], equal_nan=True), (
            f"{key} differs between uninterrupted and killed+resumed runs")

#!/usr/bin/env python3
"""Kill-resume worker of the port: one checkpointed BA solve, then dump
the result.

    python scripts/torch_killresume_worker.py CHECKPOINT RESULT \
        [--device cpu|cuda:0] [--scene small|trafalgar]

Runs `megba_tpu_torch.solve_checkpointed` (f64, ANALYTICAL, IMPLICIT,
8 LM iterations in chunks of 2) on a seeded synthetic scene, resuming
from CHECKPOINT if it exists, and writes the solved cameras and points,
the final cost, the counts, the status and the stitched trace to RESULT
(.npz, written atomically).  The scene is fully seeded, so an
interrupted-and-resumed run and an uninterrupted one must write bitwise
equal results: the contract a SIGKILL check holds it to
(megba_tpu_torch/robustness/harness.py).  `small` is 6 cameras and 40
points (the JAX package's worker scene, tests/_killresume_worker.py),
`trafalgar` 257 cameras and 65,132 points (the card's).
"""

import argparse
import os
import sys

# Runnable from any cwd: the repo root is this file's parent's parent.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from megba_tpu_torch import (  # noqa: E402
    AlgoOption,
    JacobianMode,
    ProblemOption,
    SolverOption,
    make_synthetic_bal,
    solve_checkpointed,
)
from megba_tpu_torch.observability.trace import TRACE_FIELDS  # noqa: E402

SCENES = {
    "small": dict(num_cameras=6, num_points=40, obs_per_point=4, seed=7,
                  param_noise=4e-2, pixel_noise=0.3),
    "trafalgar": dict(num_cameras=257, num_points=65_132,
                      obs_per_point=225_911 / 65_132, seed=7,
                      param_noise=1e-2, pixel_noise=0.5),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint")
    ap.add_argument("result")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--scene", choices=sorted(SCENES), default="small")
    a = ap.parse_args()
    s = make_synthetic_bal(dtype=np.float64, **SCENES[a.scene])
    option = ProblemOption(
        jacobian_mode=JacobianMode.ANALYTICAL,
        algo_option=AlgoOption(max_iter=8, epsilon1=1e-12, epsilon2=1e-15),
        solver_option=SolverOption(max_iter=60, tol=1e-12,
                                   refuse_ratio=1e30))
    res = solve_checkpointed(None,
        s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx, option,
        checkpoint_path=a.checkpoint, checkpoint_every=2, device=a.device)
    payload = {
        "cameras": res.cameras.cpu().numpy(),
        "points": res.points.cpu().numpy(),
        "cost": res.cost.cpu().numpy(),
        "iterations": np.asarray(res.iterations),
        "accepted": np.asarray(res.accepted),
        "pcg_iterations": np.asarray(res.pcg_iterations),
        "status": np.asarray(res.status),
    }
    for field in TRACE_FIELDS:
        payload[f"trace_{field}"] = getattr(res.trace, field).numpy()
    tmp = a.result + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, a.result)


if __name__ == "__main__":
    main()

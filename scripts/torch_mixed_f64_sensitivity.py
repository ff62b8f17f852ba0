#!/usr/bin/env python3
"""How far a 1e-15 change of the observations moves the trial costs of a
mixed-precision float64 solve of the PyTorch port.

For each scene, compute kind and configuration, `flat_solve` runs twice
on the CPU (the kernels' plain PyTorch versions): once on the scene and
once with every observation scaled by (1 + 1e-15 * N(0, 1)).  It prints
the relative gap between the two runs' trial costs at each LM iteration,
and the largest.  A configuration whose gaps stay near 1e-15 is
determined by its inputs; one whose gaps grow toward 1e-9 is not, and no
two summation orders of it (the CUDA kernels and their plain versions,
or two packages) can agree at a 1e-9 cost gate.

The configurations are chip_smoke.py's solve options (8 LM iterations,
PCG to 30 iterations or an absolute 1e-10) in full float64 and with
`mixed_precision_pcg`, from the default initial trust region (1e3) and
from 1.

    python scripts/torch_mixed_f64_sensitivity.py [--trafalgar]

`--trafalgar` adds the 257-camera scene of chip_smoke.py's f64 phase
(minutes on the CPU).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import megba_tpu_torch as mt  # noqa: E402

SCENES = {
    "8 cameras, 120 points": dict(num_cameras=8, num_points=120,
                                  obs_per_point=3.5, seed=3),
    "8 cameras, 1303 points": dict(num_cameras=8, num_points=1303,
                                   obs_per_point=225_911 / 65_132, seed=0,
                                   param_noise=1e-2, pixel_noise=0.5),
}
TRAFALGAR = {
    "257 cameras, 65132 points": dict(num_cameras=257, num_points=65_132,
                                      obs_per_point=225_911 / 65_132,
                                      seed=0, param_noise=1e-2,
                                      pixel_noise=0.5),
}
CONFIGS = (("f64", False, 1e3), ("mixed", True, 1e3), ("mixed", True, 1.0))


def option(kind: str, mixed: bool, region: float) -> mt.ProblemOption:
    return mt.ProblemOption(
        dtype=np.float64, compute_kind=mt.ComputeKind[kind],
        jacobian_mode=mt.JacobianMode.ANALYTICAL, mixed_precision_pcg=mixed,
        algo_option=mt.AlgoOption(max_iter=8, epsilon1=1e-12,
                                  epsilon2=1e-15, initial_region=region),
        solver_option=mt.SolverOption(max_iter=30, tol=1e-10,
                                      refuse_ratio=1e30))


def trial_costs(scene, obs, opt) -> np.ndarray:
    res = mt.flat_solve(None,
                        scene.cameras0, scene.points0, obs, scene.cam_idx,
                        scene.pt_idx, opt, device="cpu")
    return res.trace.cost[:res.iterations].numpy()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trafalgar", action="store_true")
    scenes = dict(SCENES, **(TRAFALGAR if ap.parse_args().trafalgar
                             else {}))
    for name, cfg in scenes.items():
        scene = mt.make_synthetic_bal(dtype=np.float64, **cfg)
        rng = np.random.default_rng(0)
        obs = scene.obs * (1 + 1e-15 * rng.standard_normal(scene.obs.shape))
        for kind in ("IMPLICIT", "EXPLICIT"):
            for label, mixed, region in CONFIGS:
                opt = option(kind, mixed, region)
                a = trial_costs(scene, scene.obs, opt)
                b = trial_costs(scene, obs, opt)
                gaps = np.abs(a - b) / np.abs(a) if a.shape == b.shape \
                    else np.full(1, np.inf)
                print(f"{name}, {kind}, {label}, initial region {region:g}: "
                      f"largest gap {gaps.max():.2e}; per LM iteration "
                      + " ".join(f"{g:.1e}" for g in gaps), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

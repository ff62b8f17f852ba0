"""How far the fleet's precision rungs move under a one-ulp change of
their observations, from two initial trust regions (port only, CPU).

Solves the first problems of `make_fleet(1024, (128, 1024), seed=0)`
through `solve_many` on the rung paths of chip_smoke.py's phase 12 at
f32 (fused EXPLICIT mixed, fused IMPLICIT bf16, IMPLICIT bf16; the PCG
of its f32 gate: at most 30 iterations, no refusal, 1e-6 of the RHS
energy) under each LM cap, once on the observations and once on them
moved one ulp up, and prints the largest relative gap of the first trial
costs and of the final costs, from each initial trust region.  A kernel
against its plain version differs by summation order, a change of that
size: the gates need the region and the depth where the gaps stay small.

    python scripts/torch_fleet_rung_sensitivity.py [--problems 32]
        [--region 1000 1] [--lm 4] [--paths NAME ...]
"""

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import megba_tpu_torch as mt  # noqa: E402
import megba_tpu_torch.serving as ts  # noqa: E402
from megba_tpu_torch.common import (  # noqa: E402
    AlgoOption,
    ComputeKind,
    Device,
    ProblemOption,
    SolverOption,
)

PATHS = {
    "fused_explicit_mixed": (ComputeKind.EXPLICIT, True,
                             dict(mixed_precision_pcg=True), {}),
    "fused_implicit_bf16": (ComputeKind.IMPLICIT, True, {}, dict(bf16=True)),
    "implicit_bf16": (ComputeKind.IMPLICIT, False, {}, dict(bf16=True)),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problems", type=int, default=32)
    ap.add_argument("--region", type=float, nargs="+", default=[1e3, 1.0])
    ap.add_argument("--lm", type=int, nargs="+", default=[4])
    ap.add_argument("--paths", nargs="+", default=list(PATHS),
                    choices=list(PATHS))
    args = ap.parse_args()
    n = args.problems
    fleet = mt.io.synthetic.make_fleet(1024, size_range=(128, 1024), seed=0,
                                       dtype=np.float32)[:n]
    probs = [ts.FleetProblem.from_synthetic(s) for s in fleet]
    moved = [dataclasses.replace(p, obs=np.nextafter(
        p.obs, np.float32(np.inf)).astype(np.float32)) for p in probs]
    for region in args.region:
        for lm, name in ((lm, name) for lm in args.lm for name in args.paths):
            kind, fused, top, rung = PATHS[name]
            opt = ProblemOption(
                dtype=np.float32, device=Device.CPU, compute_kind=kind,
                algo_option=AlgoOption(max_iter=lm, initial_region=region),
                solver_option=SolverOption(
                    tol=1e-6, tol_relative=True, max_iter=30,
                    refuse_ratio=1e30, fused_kernels=fused, **rung), **top)
            a, b = ts.solve_many(probs, opt), ts.solve_many(moved, opt)
            first = max(abs(float(x.trace.cost[0]) - float(y.trace.cost[0]))
                        / float(y.trace.cost[0]) for x, y in zip(a, b))
            final = max(abs(float(x.cost) - float(y.cost)) / float(y.cost)
                        for x, y in zip(a, b))
            print(f"region {region:g}, LM cap {lm}, {n} problems, {name}: "
                  f"first trial cost gap "
                  f"{first:.3e}, final cost gap {final:.3e}", flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Run phase 13 of chip_smoke.py (the federation tier) alone on one card.

    python3 scripts/torch_federation_phase.py

from the root of a checkout: builds the kernels (all sources together),
prints the card's name and power limit, solves phase 12's fleet
(`make_fleet(1024, (128, 1024))`, f64, `ProblemOption()`) once through
`solve_many` as the control (its first 64 under fused EXPLICIT too, the
TCP runs' control), then runs `chip_smoke.federation_phase`: the
artifact cold start of two pipe workers, the fleet through the router,
the SIGKILL reroute and the TCP workers behind the chaos proxy.  A quick
check of the federation tier on the card without the script's other
twelve phases.
"""

import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_federation_phase: no CUDA device is available",
              file=sys.stderr)
        return 2
    from megba_tpu_torch import solve_many
    from megba_tpu_torch.ops import kernels

    warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
    warnings.filterwarnings("ignore", message="Sparse invariant checks")
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    kernels.build_all([s for m in cs.kernel_modules()
                       for s in m.KERNEL_SOURCES])
    build_s = time.perf_counter() - t
    cs.log(f"build {build_s:.1f} s")
    smi = cs.nvidia_smi_line()
    cs.log(smi)
    probs = cs.fleet_problems(cs.FLEET_N, np.float64)
    opt = cs.fleet_option(np.float64)
    solve_many(probs[:1], opt, device=cs.DEVICE)  # first use
    torch.cuda.synchronize()
    t = time.perf_counter()
    results = solve_many(probs, opt, device=cs.DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    fused = solve_many(probs[:cs.FED_TCP],
                       cs.fleet_option(np.float64, "fused_explicit"),
                       device=cs.DEVICE)
    t = time.perf_counter()
    cs.federation_phase({"probs": probs, "results": results, "wall": wall,
                         "fused_explicit": fused}, build_s, smi)
    cs.log(f"federation phase alone {time.perf_counter() - t:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

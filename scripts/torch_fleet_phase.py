#!/usr/bin/env python3
"""Run phase 12 of chip_smoke.py (the fleet service) alone on one card.

    python3 scripts/torch_fleet_phase.py

from the root of a checkout: builds the kernels (all sources together),
prints the card's name and power limit, runs `chip_smoke.fleet_phase()`
and prints its kernel rows as one JSON line.  A quick check of the
serving layer, the lane-batched LM on its four coupling paths and the
observability plane on the card without the script's other twelve
phases.
"""

import json
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fleet_phase: no CUDA device is available",
              file=sys.stderr)
        return 2
    from megba_tpu_torch.ops import kernels

    warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
    warnings.filterwarnings("ignore", message="Sparse invariant checks")
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    kernels.build_all([s for m in cs.kernel_modules()
                       for s in m.KERNEL_SOURCES])
    cs.log(f"build {time.perf_counter() - t:.1f} s")
    cs.log(cs.nvidia_smi_line())
    t = time.perf_counter()
    rows = cs.fleet_phase({})
    cs.log(f"fleet phase alone {time.perf_counter() - t:.1f} s")
    cs.log(json.dumps({"kernels": list(rows.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

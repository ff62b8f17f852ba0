#!/usr/bin/env python3
"""Run phase 15 of chip_smoke.py (the multi-process runtime) alone on one card.

    python3 scripts/torch_multiprocess_phase.py

from the root of a checkout: builds the kernels (all sources together),
prints the card's name and power limit, runs phase 7's one-process venice
solves that phase 15.1 is held to (IMPLICIT, then `w2_implicit` with its
per-shard launch tally) and phase 10's world-2 4,096-pose SE(3) f64
graph (15.2's reference), then `chip_smoke.multiprocess_phase`: the
one-process 2-D references of 15.4 / 15.5, the two ranks of 15.1, 15.2,
15.4 and 15.5, and the elastic kill-resume of 15.3.  A quick check of
the multi-process path on the card without the script's other phases.
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
        print("torch_multiprocess_phase: no CUDA device is available",
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
    smi = cs.nvidia_smi_line()
    cs.log(smi)
    venice = cs.make_scene(cs.VENICE, np.float32)
    ref = cs.venice_phase(venice, "implicit", False)[2]
    cs.venice_phase(venice, "w2_implicit", False, ref)
    graphs = {"se3": cs.pgo_graph("se3", cs.PGO_SMALL)}
    args, kw, opt, world = cs.pgo_path_inputs("se3_w2", graphs)
    kern, _ = cs.pgo_run(args, kw, opt, world)
    cs.MP_KEPT.update(pgo=kern, pgo_graph=graphs["se3"])
    trafalgar64 = cs.make_scene(cs.TRAFALGAR, np.float64)
    t = time.perf_counter()
    cs.multiprocess_phase(venice, trafalgar64, smi)
    cs.log(f"phase 15: {time.perf_counter() - t:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time kernel 1 (`jtj_grad_reduce`) of two checkouts on one card, in turns.

    python3 scripts/torch_kernel1_forms.py OTHER_CHECKOUT [--rounds 2]

Runs this checkout's and OTHER_CHECKOUT's `megba_tpu_torch` (each built
from its own sources, each in a process of its own) on the venice graph
(1778 cameras, 993,923 points, ~5.0M edges, seed 0) with seeded random
Jacobian and residual rows, f32 and f64, camera side (2, 9) and point
side (2, 3), in the order other, this, this, other (per round), and prints
one JSON line per run and a summary of the medians.  It compares two
forms of the kernel's sums (e.g. the full d x d block against its upper
triangle) on one card, as two separate calls cannot.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_RUN = r"""
import json, statistics, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from megba_tpu_torch.io.synthetic import make_synthetic_bal
from megba_tpu_torch.ops import segtiles
s = make_synthetic_bal(num_cameras=1778, num_points=993_923,
                       obs_per_point=5_001_946 / 993_923, seed=0,
                       dtype=np.float32)
dev = torch.device("cuda")
_, plans = segtiles.make_dual_plans(s.cam_idx, s.pt_idx, 1778, 993_923, dev)
n = plans.cam.n_slots
g = torch.Generator(device=dev).manual_seed(0)
out = {}
for dtype in (torch.float32, torch.float64):
    for side, plan, d in (("cam", plans.cam, 9), ("pt", plans.pt, 3)):
        J = 0.1 * torch.randn((2 * d, n), generator=g, device=dev, dtype=dtype)
        r = torch.randn((2, n), generator=g, device=dev, dtype=dtype)
        for _ in range(3):
            segtiles.jtj_grad_reduce(J, r, plan)
        times = []
        for _ in range(9):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(10):
                segtiles.jtj_grad_reduce(J, r, plan)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 10)
        out[f"{str(dtype)[6:]}_{side}"] = statistics.median(times)
print(json.dumps(out))
"""


def run(tree: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", _RUN, str(tree)],
                         capture_output=True, text=True, check=True,
                         timeout=900, cwd=tree)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    opts = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    runs = {"other": [], "this": []}
    for _ in range(opts.rounds):
        for label in ("other", "this", "this", "other"):
            ms = run(opts.other.resolve() if label == "other" else ROOT)
            runs[label].append(ms)
            print(json.dumps({"tree": label, "ms": ms}), flush=True)
    summary = {label: {k: statistics.median(r[k] for r in rs)
                       for k in rs[0]} for label, rs in runs.items()}
    print(json.dumps({"median_ms": summary, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

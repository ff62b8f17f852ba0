#!/usr/bin/env python3
"""Hold kernels 4-8 of two checkouts to each other, bitwise, on one card,
and time them in turns.

    python3 scripts/torch_fused_bitwise.py OTHER_CHECKOUT [--rounds 2]

Runs this checkout's and OTHER_CHECKOUT's `megba_tpu_torch` (each built
from its own sources, each in a process of its own) on the venice graph
(1778 cameras, 993,923 points, ~5.0M edges, seed 0) at BAL's shapes:
kernels 8 and 7 in both directions and kernel 6 in every precision arm
they have, and kernels 4 and 5 on both sides at f32 and f64, on the same
seeded random rows, tables and vectors, in the order other, this, this,
other (per round).  Prints the card, then one line per output: bitwise
equal or not, and the CUDA-event median ms of each tree's launches (7
runs of 10 back-to-back launches a process, the median over its
processes).  Exits non-zero if any output differs: a change to how the
kernels are built (a shape list, a template parameter) must leave BAL's
outputs bitwise what they were.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

# The head of a timing process (argv: checkout, result file): the
# checkout's package first on the path, the card, and `event_ms`, the
# CUDA-event median ms a launch over 7 runs of 10 back-to-back launches
# (after 2 unmeasured).  scripts/torch_split_reduce_turns.py runs it too.
PROCESS_HEAD = r"""
import sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
dev = torch.device("cuda")

def event_ms(fn):
    for _ in range(2):
        fn()
    times = []
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(10):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 10)
    return sorted(times)[3]
"""

_RUN = PROCESS_HEAD + r"""
from megba_tpu_torch.io.synthetic import make_synthetic_bal
from megba_tpu_torch.ops import fused, segtiles
s = make_synthetic_bal(num_cameras=1778, num_points=993_923,
                       obs_per_point=5_001_946 / 993_923, seed=0,
                       dtype=np.float32)
_, plans = segtiles.make_dual_plans(s.cam_idx, s.pt_idx, 1778, 993_923, dev)
plans = fused.with_fused_plans(plans)
n = plans.cam.n_slots
g = torch.Generator(device=dev).manual_seed(0)

def randn(*shape, dtype=torch.float64):
    return torch.randn(shape, generator=g, device=dev, dtype=dtype)

W, Jc, Jp = 0.1 * randn(27, n), 0.1 * randn(18, n), 0.1 * randn(6, n)
x_cam, x_pt = randn(9, 1778), randn(3, 993_923)
A = randn(1778, 9, 9)
Hrows = fused.block_diag_rows(A @ A.transpose(1, 2))
arms = {"f32": (torch.float32, torch.float32, False),
        "f64": (torch.float64, torch.float64, False),
        "mixed": (torch.bfloat16, torch.float32, False),
        "mixed64": (torch.bfloat16, torch.float64, False),
        "bf16": (torch.bfloat16, torch.float32, True)}
calls = {}
for arm, (rt, vt, ops) in arms.items():
    def rows(t):
        return t.to(rt).contiguous()
    xc, xp = x_cam.to(vt), x_pt.to(vt)
    a8 = (rows(plans.to_pt(W)), xc, plans.fused_to_pt, True, ops)
    b8 = (rows(W), xp, plans.fused_to_cam, False, ops)
    a7 = (rows(plans.to_pt(Jc)), rows(plans.to_pt(Jp)), xc,
          plans.fused_to_pt, ops)
    b7 = (rows(plans.to_cam(Jp)), rows(Jc), xp, plans.fused_to_cam, ops)
    calls[f"8 cam_to_pt {arm}"] = (fused.fused_coupling_apply, a8)
    calls[f"8 pt_to_cam {arm}"] = (fused.fused_coupling_apply, b8)
    calls[f"7 cam_to_pt {arm}"] = (fused.fused_coupling_apply_implicit, a7)
    calls[f"7 pt_to_cam {arm}"] = (fused.fused_coupling_apply_implicit, b7)
    if arm != "mixed64":
        calls[f"6 {arm}"] = (fused.fused_block_diag_apply,
                             (rows(Hrows), xc, ops))
for dt in (torch.float32, torch.float64):
    for side, plan, d in (("cam", plans.cam, 9), ("pt", plans.pt, 3)):
        calls[f"4 {side} {dt}"] = (segtiles.seg_reduce,
                                   (randn(d, n, dtype=dt), plan))
        calls[f"5 {side} {dt}"] = (segtiles.seg_expand,
                                   (randn(d, plan.num_segments, dtype=dt),
                                    plan))
out, ms = {}, {}
for key, (fn, args) in calls.items():
    out[key] = fn(*args)
    ms[key] = event_ms(lambda: fn(*args))
torch.cuda.synchronize()
torch.save(({k: v.cpu() for k, v in out.items()}, ms), sys.argv[2])
"""


def run(code: str, tree: Path, dest: Path, *args: str):
    """The result a process running `code` on `tree` saved to `dest`."""
    subprocess.run([sys.executable, "-c", code, str(tree), str(dest), *args],
                   check=True, timeout=900, cwd=tree)
    return torch.load(dest)


def in_turns(code: str, other: Path, rounds: int, args=None) -> dict:
    """{"other": [...], "this": [...]}: the results of `code`'s processes
    on OTHER and on this checkout, run in the order other, this, this,
    other per round; `args` maps a tree's name to its extra arguments."""
    trees = {"other": other.resolve(),
             "this": Path(__file__).resolve().parents[1]}
    runs = {"other": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(rounds):
            for name in ("other", "this", "this", "other"):
                runs[name].append(run(code, trees[name],
                                      Path(tmp) / f"{name}.pt",
                                      *(args or {}).get(name, ())))
    return runs


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({8: torch.int64, 4: torch.int32}[t.element_size()])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    opts = ap.parse_args()
    print(card(), flush=True)
    runs = in_turns(_RUN, opts.other, opts.rounds)  # (outputs, ms) each
    this, other = runs["this"][0][0], runs["other"][0][0]
    differ = []
    for key, t in this.items():
        same = key in other and t.dtype == other[key].dtype and torch.equal(
            bits(t), bits(other[key]))
        med = {name: statistics.median(ms[key] for _, ms in rs)
               for name, rs in runs.items()}
        print(f"{key}: {tuple(t.shape)} "
              f"{'bitwise equal' if same else 'DIFFERS'}; this "
              f"{med['this']:.4f} ms, other {med['other']:.4f} ms "
              f"({med['this'] / med['other'] - 1:+.1%})")
        if not same:
            differ.append(key)
    print(f"{len(this) - len(differ)} of {len(this)} outputs bitwise equal")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())

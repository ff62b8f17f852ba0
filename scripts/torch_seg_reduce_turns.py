#!/usr/bin/env python3
"""Time kernel 4 (`seg_reduce`) against another checkout's, in turns on
one card.

    python3 scripts/torch_seg_reduce_turns.py --other CHECKOUT [--rounds 1]

Sides (seeded random rows, f32 and f64): venice's camera (F = 9) and
point (F = 3) sides (1778 cameras, 993,923 points, ~5.0M edges, seed 0);
the union of the fleet's largest bucket (`make_fleet(1024, (128, 1024),
seed=0)`, its lanes stacked as `algo/lanes.py` stacks them) on its
camera (9) and point (3) sides; the point side of
`io.synthetic.heavy_tailed_graph(1778, 170000)` (Zipf tracks, 3); 64
long cameras of 5,000-40,000 edges (`long_camera_idx`, 9); and the pose
prior's point side, one segment of 200,000 slots (3).

`seg_reduce` of OTHER's checkout and of this one on the same sides, each
tree in processes of its own in the order other, this, this, other
(`--rounds` rounds; scripts/torch_fused_bitwise.py's `in_turns`): each
tree's CUDA-event median and torch.profiler device time a launch, and
whether the outputs are bitwise equal.

Prints the card's name and power limit first and last.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

import torch

from torch_fused_bitwise import PROCESS_HEAD, bits, card, in_turns

_SIDES = PROCESS_HEAD + r"""
from megba_tpu_torch.io.synthetic import (heavy_tailed_graph,
                                          long_camera_idx,
                                          make_synthetic_bal)
from megba_tpu_torch.ops import segtiles
from torch.profiler import ProfilerActivity, profile

def side_plan(idx, num_segments):
    hplan = segtiles.build_seg_plan(idx, num_segments)
    return segtiles.device_plan(hplan, np.zeros_like(hplan.perm), dev)

def fleet_union():
    from megba_tpu_torch import FleetProblem
    from megba_tpu_torch.io.synthetic import make_fleet
    from megba_tpu_torch.serving import BucketLadder, classify, pad_to_class
    probs = [FleetProblem.from_synthetic(s) for s in
             make_fleet(1024, size_range=(128, 1024), seed=0,
                        dtype=np.float64)]
    ladder, groups = BucketLadder(), {}
    for p in probs:
        groups.setdefault(classify(*p.dims(), np.float64, ladder),
                          []).append(p)
    shape, members = max(groups.items(), key=lambda kv: ladder.bucket_lanes(
        len(kv[1])) * kv[0].n_edge)
    lanes = ladder.bucket_lanes(len(members))
    padded = [pad_to_class(p.cameras, p.points, p.obs, p.cam_idx, p.pt_idx,
                           shape) for p in members]
    padded += [padded[0]] * (lanes - len(padded))
    ci = np.concatenate([pp.cam_idx + k * shape.n_cam
                         for k, pp in enumerate(padded)])
    pi = np.concatenate([pp.pt_idx + k * shape.n_pt
                         for k, pp in enumerate(padded)])
    return segtiles.make_dual_plans(ci, pi, lanes * shape.n_cam,
                                    lanes * shape.n_pt, dev)[1]

s = make_synthetic_bal(num_cameras=1778, num_points=993_923,
                       obs_per_point=5_001_946 / 993_923, seed=0,
                       dtype=np.float32)
_, venice = segtiles.make_dual_plans(s.cam_idx, s.pt_idx, 1778, 993_923,
                                     dev)
del s
fleet = fleet_union()
_, hp = heavy_tailed_graph(1778, 170_000, seed=0)
sides = {
    "venice cam": (venice.cam, 9), "venice pt": (venice.pt, 3),
    "fleet cam": (fleet.cam, 9), "fleet pt": (fleet.pt, 3),
    "heavy-tailed pt": (side_plan(np.sort(hp), 170_000), 3),
    "long cam": (side_plan(long_camera_idx(64), 64), 9),
    "prior pt": (side_plan(np.zeros(200_000, np.int64), 1), 3),
}
g = torch.Generator(device=dev).manual_seed(0)
calls = {}
for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
    for name, (plan, F) in sides.items():
        data = torch.randn((F, plan.n_slots), generator=g, device=dev,
                           dtype=dt)
        calls[f"{name} {tag}"] = (data, plan)

def device_ms(fn, calls=100):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # The trace's device events, as chip_smoke.py's device_time_by_name.
    ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
             if getattr(e.device_type(), "name", "") == "CUDA")
    return ns / calls / 1e6
"""

# One process of `--other`: this tree's or OTHER's `seg_reduce` on each
# side (argv: checkout, result file).
_TREE = _SIDES + r"""
out, ms, dev_ms = {}, {}, {}
for key, (data, plan) in calls.items():
    out[key] = segtiles.seg_reduce(data, plan)
    ms[key] = event_ms(lambda: segtiles.seg_reduce(data, plan))
    dev_ms[key] = device_ms(lambda: segtiles.seg_reduce(data, plan))
torch.cuda.synchronize()
torch.save(({k: v.cpu() for k, v in out.items()}, (ms, dev_ms)),
           sys.argv[2])
"""

def trees(other: Path, rounds: int) -> None:
    """OTHER's seg_reduce against this tree's, in turns."""
    runs = in_turns(_TREE, other, rounds)
    this, that = runs["this"][0][0], runs["other"][0][0]
    for key, t in this.items():
        same = key in that and t.dtype == that[key].dtype and torch.equal(
            bits(t), bits(that[key]))
        med = {name: tuple(statistics.median(timing[i][key]
                                             for _, timing in rs)
                           for i in (0, 1))
               for name, rs in runs.items()}
        (ms, dv), (oms, odv) = med["this"], med["other"]
        print(f"trees {key}: this {ms:.4f} ms (device {dv:.4f}), other "
              f"{oms:.4f} ms (device {odv:.4f}), {ms / oms - 1:+.1%} by "
              f"events, {dv / odv - 1:+.1%} by device; "
              f"{'bitwise equal' if same else 'not bitwise equal'}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=1)
    opts = ap.parse_args()
    print(card(), flush=True)
    trees(opts.other, opts.rounds)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

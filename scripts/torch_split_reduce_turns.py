#!/usr/bin/env python3
"""Time kernels 1-3 of two checkouts in turns on one card, and hold their
outputs to each other and to the float64 plain versions.

    python3 scripts/torch_split_reduce_turns.py OTHER_CHECKOUT [--rounds 2]
        [--split CHUNK:ABOVE ...]

Runs this checkout's and OTHER_CHECKOUT's `megba_tpu_torch` (each built
from its own sources, each in a process of its own) in the order other,
this, this, other (per round; scripts/torch_fused_bitwise.py's
`in_turns`) on the same seeded random rows:

- venice's BAL shapes (1778 cameras, 993,923 points, ~5.0M edges, seed
  0): `jtj_grad_reduce` (f32, f64), `coupling_expand` and
  `coupling_reduce` (f32, f64, mixed, mixed64, bf16) on the camera side
  (2, 9) and the point side (2, 3);
- the pose prior's point side, (6, 3): one segment of 200,000 slots,
  kernels 1-3 at f32 and f64; and its pose side, (6, 6): 100,000
  segments of two slots, summed a thread per segment;
- kernels 1 and 3 at f32 on the camera side of
  `io.synthetic.heavy_tailed_graph(1778, 170000)`;
- kernels 1 (f32, f64) and 3 (f32, f64, mixed) on two camera sides
  (2, 9) of this checkout's `io.synthetic.long_camera_idx` (seed 0,
  given to both trees): 64 and 1024 cameras of 5,000-40,000 edges (1.07M
  and 17.7M slots).

Each `--split CHUNK:ABOVE` also times this checkout's kernels 1 and 3
(f32, f64, mixed) on venice's camera side, the pose prior's point side
and the long camera sides with the chunk table built at that setting (`segtiles.SPLIT_CHUNK`, `SPLIT_ABOVE` set
while the table is built), beside OTHER's time.

Near the launch floor (the pose prior's and heavy-tailed sides, and the
64 long cameras) each call is also timed by torch.profiler's device time
a launch and by its host time a call (perf_counter over 200 calls that
do not wait for the card): there a CUDA-event time of back-to-back
launches is the longer of the two.  This checkout's first process also
profiles (cProfile) 2000 host calls of kernels 1 and 3 on the pose
prior's point side at f32 and prints each wrapper's costliest steps.

Prints the card, then one line per output: bitwise equal or not across
the trees, each tree's CUDA-event median ms (7 runs of 10 launches a
process, the median over its processes) and, for kernels 1 and 3, each
tree's largest |kernel - plain| over the plain version's sums of the
terms' magnitudes, the plain version evaluated in float64 on the same
inputs (chip_smoke.py's measure of a sum order's error).  Exits non-zero
if a kernel 2 output, or a kernel 1 or 3 output of a point side summed a
thread per segment, is not bitwise the other tree's.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from torch_fused_bitwise import PROCESS_HEAD, bits, card, in_turns

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from megba_tpu_torch.io.synthetic import long_camera_idx  # noqa: E402

_RUN = PROCESS_HEAD + r"""
import cProfile, dataclasses, io, pstats, time
from megba_tpu_torch.io.synthetic import heavy_tailed_graph, make_synthetic_bal
from megba_tpu_torch.ops import segtiles
from torch.profiler import ProfilerActivity, profile

s = make_synthetic_bal(num_cameras=1778, num_points=993_923,
                       obs_per_point=5_001_946 / 993_923, seed=0,
                       dtype=np.float32)
_, plans = segtiles.make_dual_plans(s.cam_idx, s.pt_idx, 1778, 993_923, dev)
del s
hc, hp = heavy_tailed_graph(1778, 170_000, seed=0)
_, hplans = segtiles.make_dual_plans(hc, hp, 1778, 170_000, dev)

def side_plan(idx, num_segments):
    host = segtiles.build_seg_plan(idx, num_segments)
    return segtiles.device_plan(host, np.zeros_like(host.perm), dev)

prior = side_plan(np.zeros(200_000, np.int32), 1)
poses = side_plan(np.arange(200_000, dtype=np.int32) // 2, 100_000)
long64 = side_plan(np.load(sys.argv[3]), 64)
long1024 = side_plan(np.load(sys.argv[4]), 1024)
g = torch.Generator(device=dev).manual_seed(0)

def randn(*shape, scale=1.0):
    return scale * torch.randn(shape, generator=g, device=dev,
                               dtype=torch.float64)

arms = {"f32": (torch.float32, torch.float32, False),
        "f64": (torch.float64, torch.float64, False),
        "mixed": (torch.bfloat16, torch.float32, False),
        "mixed64": (torch.bfloat16, torch.float64, False),
        "bf16": (torch.bfloat16, torch.float32, True)}
sides = [("cam", plans.cam, 2, 9, list(arms)),
         ("pt", plans.pt, 2, 3, list(arms)),
         ("prior_pt", prior, 6, 3, ["f32", "f64"]),
         ("prior_cam", poses, 6, 6, ["f32", "f64"]),
         ("heavy_cam", hplans.cam, 2, 9, ["f32"]),
         ("long64", long64, 2, 9, ["f32", "f64", "mixed"]),
         ("long1024", long1024, 2, 9, ["f32", "f64", "mixed"])]
near_floor = ("prior_pt", "prior_cam", "heavy_cam", "long64")
# This checkout's other chunk tables (argv[5:], CHUNK:ABOVE each).
variants = [tuple(int(v) for v in a.split(":")) for a in sys.argv[5:]]

def variant_plan(plan, chunk, above):
    saved = segtiles.SPLIT_CHUNK, segtiles.SPLIT_ABOVE
    segtiles.SPLIT_CHUNK, segtiles.SPLIT_ABOVE = chunk, above
    try:
        split = segtiles.split_table(plan.seg_ptr.cpu().numpy(), dev)
    finally:
        segtiles.SPLIT_CHUNK, segtiles.SPLIT_ABOVE = saved
    return dataclasses.replace(plan, split=split)

calls = {}  # key -> (kernel, args, kwargs, plain version or None)
for side, plan, od, d, side_arms in sides:
    n, ns = plan.n_slots, plan.num_segments
    J, r, u = randn(od * d, n, scale=0.1), randn(od, n), randn(od, n)
    table = randn(d, ns)
    tagged = [("", plan)]
    if side in ("cam", "prior_pt", "long64", "long1024"):
        tagged += [(f" @{c}:{a}", variant_plan(plan, c, a))
                   for c, a in variants]
    for arm in side_arms:
        rt, vt, ops = arms[arm]
        Ja, ra, ua, ta = J.to(rt), r.to(vt), u.to(vt), table.to(vt)
        kw = dict(bf16_operands=ops)
        for tag, p in tagged:
            if tag and arm not in ("f32", "f64", "mixed"):
                continue
            if rt == vt:
                calls[f"1 {side} {arm}{tag}"] = (
                    segtiles.jtj_grad_reduce, (Ja, ra, p), {},
                    segtiles.jtj_grad_reduce_plain)
            calls[f"3 {side} {arm}{tag}"] = (
                segtiles.coupling_reduce, (Ja, ua, p, d), kw,
                segtiles.coupling_reduce_plain)
        if side in ("cam", "pt", "prior_pt", "prior_cam"):
            calls[f"2 {side} {arm}"] = (
                segtiles.coupling_expand, (ta, Ja, plan, d), kw, None)
    del J, r, u, table

def flat(x):
    return torch.cat(x) if isinstance(x, tuple) else x

def f64(args, absolute=False):
    out = []
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            a = a.to(torch.float64) if a.dtype == torch.float32 else a
            a = a.abs() if absolute else a
        out.append(a)
    return tuple(out)

def device_ms(fn, calls=50):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages() if e.device_type.name == "CUDA")
    return us / calls / 1e3

def host_ms(fn, calls=200):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / calls * 1e3

def host_profile(fn, calls=2000):
    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    text = io.StringIO()
    stats = pstats.Stats(prof, stream=text)
    stats.sort_stats("tottime").print_stats(8)
    return text.getvalue()

out, ms, rel, dev_ms, hst_ms, profiles = {}, {}, {}, {}, {}, {}
for key, (fn, args, kw, plain) in calls.items():
    out[key] = flat(fn(*args, **kw))
    if plain is not None:
        ref = flat(plain(*f64(args), **kw))
        scale = flat(plain(*f64(args, True), **kw)).abs()
        err = (out[key].to(torch.float64) - ref).abs()
        rel[key] = float((err / scale.clamp_min(1e-300)).max())
        del ref, scale, err
    call = lambda: fn(*args, **kw)
    ms[key] = event_ms(call)
    if key.split()[1] in near_floor:
        dev_ms[key] = device_ms(call)
        hst_ms[key] = host_ms(call)
    if key in ("1 prior_pt f32", "3 prior_pt f32"):
        profiles[key] = host_profile(call)
torch.cuda.synchronize()
per_thread = {side: plan.per_thread for side, plan, *_ in sides}
torch.save(({k: v.cpu() for k, v in out.items()}, ms, rel, dev_ms, hst_ms,
            profiles, per_thread), sys.argv[2])
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--split", nargs="*", default=[],
                    metavar="CHUNK:ABOVE")
    opts = ap.parse_args()
    print(card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ids = []  # the long camera sides, made here and read by both trees
        for nc in (64, 1024):
            ids.append(str(Path(tmp) / f"long{nc}.npy"))
            np.save(ids[-1], long_camera_idx(nc))
        runs = in_turns(_RUN, opts.other, opts.rounds,
                        {"this": ids + opts.split, "other": ids})
    this_out, _, this_rel, _, _, profiles, per_thread = runs["this"][0]
    other_out, _, other_rel, *_ = runs["other"][0]

    def median(name, key, field):  # field 1: event ms, 3: device, 4: host
        got = [r[field][key] for r in runs[name] if key in r[field]]
        return statistics.median(got) if got else None

    must_match, differ = 0, []
    for key, t in this_out.items():
        kernel, side = key.split()[:2]
        base = key.split(" @")[0]
        ev = {"this": median("this", key, 1),
              "other": median("other", base, 1)}
        line = f"{key}: {tuple(t.shape)} "
        if base == key:
            same = t.dtype == other_out[key].dtype and torch.equal(
                bits(t), bits(other_out[key]))
            line += "bitwise equal" if same else "differs"
            if kernel == "2" or per_thread[side]:
                must_match += 1
                if not same:
                    differ.append(key)
        else:
            line += "(this checkout only, against other's default plan)"
        line += (f"; this {ev['this']:.4f} ms, other {ev['other']:.4f} ms "
                 f"({ev['this'] / ev['other'] - 1:+.1%})")
        if key in this_rel:
            line += (f"; max |err| / abs sum vs f64 plain: this "
                     f"{this_rel[key]:.3e}")
            if base in other_rel:
                line += f", other {other_rel[base]:.3e}"
        if median("this", key, 3) is not None:
            line += (f"; a call: device (torch.profiler) this "
                     f"{median('this', key, 3):.5f}, other "
                     f"{median('other', base, 3):.5f} ms; host this "
                     f"{median('this', key, 4):.5f}, other "
                     f"{median('other', base, 4):.5f} ms")
        print(line, flush=True)
    for key, text in profiles.items():
        print(f"host profile of 2000 calls, this checkout, {key}:")
        print(text.strip(), flush=True)
    print(f"{must_match - len(differ)} of {must_match} outputs that must "
          "stay bitwise (kernel 2, thread-per-segment sides) are equal")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())

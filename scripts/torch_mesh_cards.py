#!/usr/bin/env python3
"""The PyTorch port's multi-device solve with its shards on separate
cards, against the same shards on one card and against world 1.

chip_smoke.py runs every mesh path with all its shards on `cuda:0`: that
shows the sharded algorithm and the kernels, but moves no byte between
cards.  This script needs N >= 2 visible cards and puts shard k on
`cuda:k`:

1. f64, the trafalgar-sized scene of chip_smoke.py: the 1-D mesh at
   world N (IMPLICIT, and TWO_LEVEL on its grid twin) and, when N = 4,
   the 2 x 2 mesh (IMPLICIT unfused and fused, EXPLICIT fused).  Each
   runs with its shards on N cards and on one card: the two must be
   bitwise equal (trace, cameras, points: the same kernels sum the same
   terms in the same order, and the collectives only copy), and within
   rtol 1e-9 of the world-1 solve's trial costs with equal counts.
2. f32, venice (1778 cameras, 993,923 points, ~5.0M observations): the
   1-D IMPLICIT and, when N = 4, the 2 x 2 IMPLICIT fused path, each on
   N cards and on one card, alternating (cards, one, one, cards, ...)
   for `--pairs` pairs, with the wall of each solve (host clock ending in
   `torch.cuda.synchronize()` on every card) and its final cost, which
   must be bitwise equal on both layouts.

    python scripts/torch_mesh_cards.py [--pairs 3]

It prints one line per solve, the cards' names and power limits, and as
its last line one JSON object with the walls.  Without two cards it
exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import megba_tpu_torch as mt  # noqa: E402

F64_COST_RTOL = 1e-9
TRAFALGAR = dict(num_cameras=257, num_points=65_132,
                 obs_per_point=225_911 / 65_132)
VENICE = dict(num_cameras=1778, num_points=993_923,
              obs_per_point=5_001_946 / 993_923)


def log(*args) -> None:
    print(*args, flush=True)


def scene(cfg: dict, dtype, **kw):
    return mt.make_synthetic_bal(seed=0, param_noise=1e-2, pixel_noise=0.5,
                                 dtype=dtype, **cfg, **kw)


def option(dtype, kind="IMPLICIT", fused=False, world=1, mesh_2d=False,
           precond="JACOBI") -> mt.ProblemOption:
    """chip_smoke.py's solve options: 8 LM iterations, PCG to 30
    iterations or an absolute 1e-10."""
    return mt.ProblemOption(
        dtype=dtype, compute_kind=mt.ComputeKind[kind], world_size=world,
        jacobian_mode=mt.JacobianMode.ANALYTICAL,
        algo_option=mt.AlgoOption(max_iter=8, epsilon1=1e-12,
                                  epsilon2=1e-15),
        solver_option=mt.SolverOption(
            max_iter=30, tol=1e-10, refuse_ratio=1e30, fused_kernels=fused,
            mesh_2d=mesh_2d, cam_blocks=2 if mesh_2d else 0,
            precond=mt.PrecondKind[precond]))


def solve(s, opt, devices):
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    t = time.perf_counter()
    res = mt.flat_solve(None,
                        s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
                        opt, device=devices)
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    return res, time.perf_counter() - t


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.is_floating_point():
        it = {8: torch.int64, 4: torch.int32}[a.element_size()]
        return torch.equal(a.view(it), b.view(it))
    return torch.equal(a, b)


def f64_phase(n: int) -> None:
    paths = [("w%d_implicit" % n, dict(world=n), False),
             ("w%d_two_level" % n, dict(world=n, precond="TWO_LEVEL"), True)]
    if n == 4:
        paths += [("2x2_implicit", dict(world=4, mesh_2d=True), False),
                  ("2x2_implicit_fused", dict(world=4, mesh_2d=True,
                                              fused=True), False),
                  ("2x2_explicit_fused", dict(world=4, mesh_2d=True,
                                              fused=True,
                                              kind="EXPLICIT"), False)]
    plain = scene(TRAFALGAR, np.float64)
    grid = scene(TRAFALGAR, np.float64, locality="grid")
    cards = [torch.device("cuda", k) for k in range(n)]
    for name, kw, coarse in paths:
        s = grid if coarse else plain
        opt = option(np.float64, **kw)
        one_opt = dataclasses.replace(
            opt, world_size=1, solver_option=dataclasses.replace(
                opt.solver_option, mesh_2d=False, cam_blocks=0))
        spread, _ = solve(s, opt, cards)
        stacked, _ = solve(s, opt, [cards[0]] * n)
        one, _ = solve(s, one_opt, cards[0])
        differ = [f.name for f in dataclasses.fields(spread.trace)
                  if not bitwise_equal(getattr(spread.trace, f.name),
                                       getattr(stacked.trace, f.name))]
        if differ or not (bitwise_equal(spread.cameras, stacked.cameras)
                          and bitwise_equal(spread.points, stacked.points)):
            raise AssertionError(f"f64 {name}: {n} cards and one card "
                                 f"differ (trace fields {differ})")
        k = spread.iterations
        tally = (k, spread.accepted, spread.pcg_iterations, spread.status)
        if tally != (one.iterations, one.accepted, one.pcg_iterations,
                     one.status):
            raise AssertionError(f"f64 {name}: counts differ from world 1")
        c, c1 = spread.trace.cost[:k].numpy(), one.trace.cost[:k].numpy()
        rel = float(np.max(np.abs(c - c1) / np.abs(c1)))
        if not rel <= F64_COST_RTOL:
            raise AssertionError(f"f64 {name}: {rel:.3e} from world 1")
        log(f"f64 {name}: {n} cards bitwise equal to one card; {rel:.3e} "
            f"from world 1 (limit {F64_COST_RTOL:g}); {k} LM iterations, "
            f"{spread.pcg_iterations} PCG; result on "
            f"{spread.cameras.device}")


def venice_phase(n: int, pairs: int) -> dict:
    s = scene(VENICE, np.float32)
    cards = [torch.device("cuda", k) for k in range(n)]
    paths = [("w%d_implicit" % n, option(np.float32, world=n))]
    if n == 4:
        paths.append(("2x2_implicit_fused", option(
            np.float32, world=4, mesh_2d=True, fused=True)))
    walls = {}
    one, t1 = solve(s, option(np.float32), cards[0])
    log(f"venice world 1 implicit: {t1:.3f} s, final cost "
        f"{float(one.cost):.8e}")
    for name, opt in paths:
        solve(s, opt, cards)  # warm-up: each card's first launches
        got = {"cards": [], "one": []}
        costs = {}
        for i in range(pairs):
            order = ("cards", "one") if i % 2 == 0 else ("one", "cards")
            for layout in order:
                devs = cards if layout == "cards" else [cards[0]] * n
                res, wall = solve(s, opt, devs)
                got[layout].append(wall)
                costs.setdefault(layout, res.cost.cpu())
                if not bitwise_equal(res.cost, costs[layout]):
                    raise AssertionError(f"venice {name}: repeats differ")
        if not bitwise_equal(costs["cards"], costs["one"]):
            raise AssertionError(f"venice {name}: {n} cards and one card "
                                 "give other final costs")
        walls[name] = {k: v for k, v in got.items()}
        log(f"venice {name}: {n} cards {statistics.median(got['cards']):.3f}"
            f" s, one card {statistics.median(got['one']):.3f} s (medians "
            f"of {pairs}; all {got}); final cost {float(costs['one']):.8e} "
            f"on both, {abs(float(costs['one']) - float(one.cost)) / float(one.cost):.3e} "
            "from world 1")
    return walls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=3)
    opts = ap.parse_args()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"torch_mesh_cards: needs two or more cards, {n} visible",
              file=sys.stderr)
        return 2
    n = 4 if n >= 4 else 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    f64_phase(n)
    walls = venice_phase(n, opts.pairs)
    log(smi)
    log(json.dumps({"cards": n, "walls_s": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

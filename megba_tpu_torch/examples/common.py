"""Shared CLI runner of the port's BAL examples.

Flag names and defaults are the JAX package's `examples/common.py`, which
follow the reference examples (BAL_Double.cpp:50-58 and the README run
recipe README.md:56-58): --path, --world_size, --max_iter, --solver_tol,
--solver_refuse_ratio, --solver_max_iter, --tau, --epsilon1, --epsilon2.
With no --path, a synthetic BAL-like scene is generated; --synthetic_*
control its size.  `--device` (as in the port's PGO examples) picks the
device: cuda, the default, or cpu; with --world_size N every shard goes
on it.  A CLI prints the JAX package's `solving:` and `Finished:` lines,
the solver's verbose lines between them, and a last line with the final
cost in full precision (`%.17g`).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", type=str, default="", help="BAL problem file")
    ap.add_argument("--world_size", type=int, default=1)
    ap.add_argument("--max_iter", type=int, default=20)
    ap.add_argument("--solver_tol", type=float, default=1e-1)
    ap.add_argument("--solver_refuse_ratio", type=float, default=1.0)
    ap.add_argument("--solver_max_iter", type=int, default=100)
    ap.add_argument("--tau", type=float, default=1e3,
                    help="initial trust region")
    ap.add_argument("--epsilon1", type=float, default=1.0)
    ap.add_argument("--epsilon2", type=float, default=1e-10)
    ap.add_argument("--synthetic_cameras", type=int, default=50)
    ap.add_argument("--synthetic_points", type=int, default=2000)
    ap.add_argument("--synthetic_obs_per_point", type=int, default=6)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu; with --world_size N "
                         "every shard goes on this device")
    return ap


def example_option(dtype, jacobian_mode, compute_kind, args):
    """The ProblemOption a BAL CLI solves with, from its parsed flags."""
    from megba_tpu_torch.common import (AlgoOption, ProblemOption,
                                        SolverOption)

    return ProblemOption(
        dtype=dtype,
        world_size=args.world_size,
        compute_kind=compute_kind,
        jacobian_mode=jacobian_mode,
        algo_option=AlgoOption(
            max_iter=args.max_iter, initial_region=args.tau,
            epsilon1=args.epsilon1, epsilon2=args.epsilon2),
        solver_option=SolverOption(
            max_iter=args.solver_max_iter, tol=args.solver_tol,
            refuse_ratio=args.solver_refuse_ratio),
    )


def example_device(args):
    """The `device` argument of the CLI's solve: None (the card), the
    named device, or that device once a shard."""
    if args.device is not None and args.world_size > 1:
        return [args.device] * args.world_size
    return args.device


def run_example(dtype, jacobian_mode, compute_kind, argv=None) -> float:
    """Parse `argv`, load or generate the scene, solve it verbosely with
    `flat_solve` and return the final cost."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
    from megba_tpu_torch.io.bal import load_bal
    from megba_tpu_torch.io.synthetic import make_synthetic_bal
    from megba_tpu_torch.ops.residuals import make_residual_jacobian_fn
    from megba_tpu_torch.solve import flat_solve

    args = build_arg_parser().parse_args(argv)

    if args.path:
        bal = load_bal(args.path, dtype=dtype)
        cameras, points = bal.cameras, bal.points
        obs, cam_idx, pt_idx = bal.obs, bal.cam_idx, bal.pt_idx
    else:
        s = make_synthetic_bal(
            num_cameras=args.synthetic_cameras,
            num_points=args.synthetic_points,
            obs_per_point=args.synthetic_obs_per_point,
            seed=0, param_noise=2e-2, pixel_noise=0.5, dtype=dtype)
        cameras, points = s.cameras0, s.points0
        obs, cam_idx, pt_idx = s.obs, s.cam_idx, s.pt_idx

    option = example_option(dtype, jacobian_mode, compute_kind, args)
    f = make_residual_jacobian_fn(mode=jacobian_mode)

    print(
        f"solving: {cameras.shape[0]} cameras, {points.shape[0]} points, "
        f"{obs.shape[0]} observations | dtype={np.dtype(dtype).name} "
        f"jacobian={jacobian_mode.name} compute={compute_kind.name} "
        f"world_size={args.world_size}")

    t0 = time.perf_counter()
    result = flat_solve(f, cameras, points, obs, cam_idx, pt_idx, option,
                        verbose=True, device=example_device(args))
    cost = float(result.cost)
    elapsed = time.perf_counter() - t0
    print(
        f"Finished: cost {float(result.initial_cost):.6e} -> {cost:.6e} "
        f"(log10 {np.log10(max(cost, 1e-300)):.3f}), "
        f"{int(result.iterations)} iterations ({int(result.accepted)} "
        f"accepted), {elapsed * 1000:.1f} ms total")
    print(f"final cost: {cost:.17g}")
    return cost

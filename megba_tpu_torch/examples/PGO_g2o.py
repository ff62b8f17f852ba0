"""Solve a .g2o pose-graph file (SE3:QUAT, SE2 or SIM3:QUAT) end to end.

Reads a file, solves it with the port's pose-graph driver
(megba_tpu_torch/models/pgo.py) on the card unless `--device cpu` is
given, and optionally writes the optimised graph back out.  The flags
and defaults are those of the JAX package's `examples/PGO_g2o.py`.

    python megba_tpu_torch/examples/PGO_g2o.py --path sphere2500.g2o \
        --out solved.g2o [--device cpu]

Without --path, a synthetic loop-closure graph is written to a temporary
file first and then read through the same file route.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np


def main(argv=None) -> float:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
    from megba_tpu_torch.common import (AlgoOption, ProblemOption,
                                        RobustKind, SolverOption)
    from megba_tpu_torch.io.g2o import (G2OGraph, read_g2o, solve_g2o,
                                        write_g2o)
    from megba_tpu_torch.models.pgo import make_synthetic_pose_graph
    from megba_tpu_torch.utils.timing import monotonic_s

    ap = argparse.ArgumentParser()
    ap.add_argument("--path", type=str, default="", help=".g2o input file")
    ap.add_argument("--out", type=str, default="",
                    help="write optimized graph here (.g2o)")
    ap.add_argument("--max_iter", type=int, default=30)
    ap.add_argument("--solver_tol", type=float, default=1e-12)
    ap.add_argument("--solver_max_iter", type=int, default=120)
    ap.add_argument("--tau", type=float, default=1e3)
    ap.add_argument("--epsilon1", type=float, default=1e-10)
    ap.add_argument("--epsilon2", type=float, default=1e-14)
    ap.add_argument("--synthetic_poses", type=int, default=64)
    ap.add_argument("--synthetic_loop_closures", type=int, default=10)
    ap.add_argument("--world_size", type=int, default=1,
                    help="shard the edge axis over this many devices")
    ap.add_argument("--robust", choices=["none", "huber", "cauchy"],
                    default="none",
                    help="IRLS robust loss against bad loop closures")
    ap.add_argument("--robust_delta", type=float, default=1.0)
    ap.add_argument("--init", choices=["file", "spanning_tree"],
                    default="file",
                    help="spanning_tree: bootstrap poses from the "
                         "measurements instead of the file's estimates")
    ap.add_argument("--prior_ids", type=str, default="",
                    help="comma-separated g2o vertex ids to anchor at "
                         "their file estimates via unary prior factors "
                         "(soft anchors; see --prior_weight)")
    ap.add_argument("--prior_weight", type=float, default=1e4,
                    help="sqrt-information scale of each prior (W = w*I)")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu; with --world_size N "
                         "every shard goes on this device")
    args = ap.parse_args(argv)

    path = args.path
    tmp = None
    if not path:
        g = make_synthetic_pose_graph(
            num_poses=args.synthetic_poses,
            loop_closures=args.synthetic_loop_closures)
        n = g.poses0.shape[0]
        fixed = np.zeros(n, bool)
        fixed[0] = True
        graph = G2OGraph(
            poses=g.poses0, edge_i=g.edge_i, edge_j=g.edge_j, meas=g.meas,
            info=np.tile(np.eye(6), (len(g.edge_i), 1, 1)), fixed=fixed,
            ids=np.arange(n, dtype=np.int64))
        tmp = tempfile.NamedTemporaryFile(
            mode="w", suffix=".g2o", delete=False)
        write_g2o(tmp, graph)
        tmp.close()
        path = tmp.name
        print(f"synthetic graph -> {path}")

    try:
        t0 = monotonic_s()
        graph = read_g2o(path)
        t_parse = monotonic_s() - t0
        kind = ("SIM3" if graph.sim3 else
                "SE2 (lifted)" if graph.se2 else "SE3")
        print(f"{path}: {len(graph.ids)} poses, {len(graph.edge_i)} edges "
              f"[{kind}], parsed in {t_parse:.2f}s")

        option = ProblemOption(
            dtype=np.float32,
            world_size=args.world_size,
            robust_kind=RobustKind[args.robust.upper()],
            robust_delta=args.robust_delta,
            algo_option=AlgoOption(max_iter=args.max_iter,
                                   initial_region=args.tau,
                                   epsilon1=args.epsilon1,
                                   epsilon2=args.epsilon2),
            solver_option=SolverOption(max_iter=args.solver_max_iter,
                                       tol=args.solver_tol,
                                       refuse_ratio=1e30),
        )
        device = args.device
        if device is not None and args.world_size > 1:
            device = [device] * args.world_size
        prior_ids = ([int(v) for v in args.prior_ids.split(",") if v]
                     if args.prior_ids else None)
        t0 = monotonic_s()
        graph, res = solve_g2o(graph, option, verbose=True,
                               init=args.init, prior_ids=prior_ids,
                               prior_weight=args.prior_weight,
                               device=device)
        print(f"solve: {monotonic_s() - t0:.2f}s")

        if args.out:
            write_g2o(args.out, graph,
                      poses=res.poses.detach().cpu().numpy())
            print(f"optimized graph -> {args.out}")
    finally:
        if tmp is not None:
            os.unlink(tmp.name)
    return float(res.cost)


if __name__ == "__main__":
    main()

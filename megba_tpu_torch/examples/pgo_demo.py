"""SE(3) pose-graph optimisation demo (between-factors, loop closures).

Builds a drifted circular trajectory with loop closures and pulls it
back onto the ground truth with `megba_tpu_torch.models.pgo.solve_pgo`,
on the card unless `--device cpu` is given.  The flags and defaults are
those of the JAX package's `examples/pgo_demo.py`.

    python megba_tpu_torch/examples/pgo_demo.py --num_poses 64 \
        --loop_closures 10 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def se3_drift(poses, poses_gt) -> float:
    """Chart-independent SE(3) distance to the ground truth, the largest
    over the poses: rotation geodesic angle + translation norm (raw
    angle-axis differences can read 2 pi for one rotation on two
    branches)."""
    import torch

    from megba_tpu_torch.ops import geo

    p = torch.as_tensor(np.asarray(poses, np.float64)).T
    gt = torch.as_tensor(np.asarray(poses_gt, np.float64)).T
    R_p = geo.angle_axis_to_rotation_matrix(p[:3])
    R_g = geo.angle_axis_to_rotation_matrix(gt[:3])
    ang = geo.rotation_matrix_to_angle_axis(
        geo.mm(R_p.transpose(0, 1), R_g)).norm(dim=0)
    trans = (p[3:] - gt[3:]).norm(dim=0)
    return float((ang + trans).max())


def main(argv=None) -> float:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
    from megba_tpu_torch.common import (AlgoOption, ProblemOption,
                                        SolverOption)
    from megba_tpu_torch.models.pgo import (make_synthetic_pose_graph,
                                            solve_pgo, spanning_tree_init,
                                            with_priors)

    ap = argparse.ArgumentParser()
    ap.add_argument("--num_poses", type=int, default=64)
    ap.add_argument("--loop_closures", type=int, default=10)
    ap.add_argument("--drift_noise", type=float, default=0.05)
    ap.add_argument("--meas_noise", type=float, default=0.0)
    ap.add_argument("--max_iter", type=int, default=30)
    ap.add_argument("--priors", type=int, default=0,
                    help="anchor the first N poses at ground truth via "
                         "unary prior factors (with_priors) instead of "
                         "the default fixed-pose gauge")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    g = make_synthetic_pose_graph(
        num_poses=args.num_poses, loop_closures=args.loop_closures,
        drift_noise=args.drift_noise, meas_noise=args.meas_noise)
    option = ProblemOption(
        dtype=np.float32,
        algo_option=AlgoOption(max_iter=args.max_iter, epsilon1=1e-10,
                               epsilon2=1e-14),
        solver_option=SolverOption(max_iter=120, tol=1e-12,
                                   refuse_ratio=1e30),
    )
    start = g.poses0
    if args.priors > 0:
        k = min(args.priors, args.num_poses)
        poses0, ei, ej, meas, fixed, si = with_priors(
            g.poses0, g.edge_i, g.edge_j, g.meas,
            prior_idx=np.arange(k), prior_poses=g.poses_gt[:k],
            prior_sqrt_info=np.broadcast_to(np.eye(6) * 10.0, (k, 6, 6)))
        # The prior anchors root the measurement bootstrap; with
        # noise-free odometry it alone lands on the ground truth and LM
        # only polishes.
        poses0 = spanning_tree_init(poses0, ei, ej, meas, fixed)
        start = poses0[:args.num_poses]
        res = solve_pgo(poses0, ei, ej, meas, option, sqrt_info=si,
                        fixed=fixed, verbose=True, device=args.device)
        res = res._replace(poses=res.poses[:args.num_poses])
    else:
        res = solve_pgo(g.poses0, g.edge_i, g.edge_j, g.meas, option,
                        verbose=True, device=args.device)

    solved = res.poses.detach().cpu().numpy()
    if args.priors > 0:
        raw = se3_drift(g.poses0, g.poses_gt)
        print(f"max pose drift (SE3): raw {raw:.4f} -> prior-rooted bootstrap "
              f"{se3_drift(start, g.poses_gt):.6f} -> solved "
              f"{se3_drift(solved, g.poses_gt):.6f}")
    else:
        print(f"max pose drift (SE3): {se3_drift(g.poses0, g.poses_gt):.4f}"
              f" -> {se3_drift(solved, g.poses_gt):.6f}")
    return float(res.cost)


if __name__ == "__main__":
    main()

"""Planar (2D) bundle adjustment demo — a second model family.

Shows the dimension-generic solver on SE(2)+focal cameras and 2D points
(megba_tpu_torch/models/planar.py): float64, AUTODIFF Jacobians,
IMPLICIT Schur, with the flags and defaults of the JAX package's
`examples/planar_demo.py`, on the card unless `--device cpu`:

    python megba_tpu_torch/examples/planar_demo.py [--device cpu]

It prints the verbose solve, `planar BA: cost ...` and a last line with
the final cost in full precision (`%.17g`).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def planar_option(max_iter: int):
    """The demo's ProblemOption (ProblemOption()'s float64, AUTODIFF,
    IMPLICIT) with its LM and PCG settings."""
    from megba_tpu_torch.common import (AlgoOption, ProblemOption,
                                        SolverOption)

    return ProblemOption(
        algo_option=AlgoOption(max_iter=max_iter, epsilon1=1e-10,
                               epsilon2=1e-13),
        solver_option=SolverOption(max_iter=150, tol=1e-12,
                                   refuse_ratio=1e30))


def main(num_cameras=12, num_points=200, obs_per_point=5,
         max_iter=20, argv=None) -> float:
    from megba_tpu_torch.common import JacobianMode
    from megba_tpu_torch.models import planar
    from megba_tpu_torch.ops.residuals import make_residual_jacobian_fn
    from megba_tpu_torch.solve import flat_solve

    ap = argparse.ArgumentParser()
    ap.add_argument("--num_cameras", type=int, default=num_cameras)
    ap.add_argument("--num_points", type=int, default=num_points)
    ap.add_argument("--obs_per_point", type=int, default=obs_per_point)
    ap.add_argument("--max_iter", type=int, default=max_iter)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    s = planar.make_synthetic_planar(
        num_cameras=args.num_cameras, num_points=args.num_points,
        obs_per_point=args.obs_per_point, noise=0.2, param_noise=3e-2,
        seed=0)
    f = make_residual_jacobian_fn(residual_fn=planar.residual,
                                  mode=JacobianMode.AUTODIFF)
    res = flat_solve(
        s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
        planar_option(args.max_iter), verbose=True, device=args.device,
        residual_jac_fn=f)
    print(
        f"planar BA: cost {float(res.initial_cost):.4e} -> "
        f"{float(res.cost):.6e} in {int(res.iterations)} iterations")
    print(f"final cost: {float(res.cost):.17g}")
    return float(res.cost)


if __name__ == "__main__":
    main()

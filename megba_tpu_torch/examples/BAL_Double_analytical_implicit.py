"""Parity entry point for the reference's BAL_Double_analytical_implicit example (reference
examples/BAL_Double_analytical_implicit.cpp): float64, analytical Jacobians, implicit Hessian.  The port's twin of the JAX
package's examples/BAL_Double_analytical_implicit.py, on the card unless `--device cpu`:

    python megba_tpu_torch/examples/BAL_Double_analytical_implicit.py --path problem.txt \
        [--max_iter 20] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402

from megba_tpu_torch.common import ComputeKind, JacobianMode  # noqa: E402
from megba_tpu_torch.examples.common import run_example  # noqa: E402


def main(argv=None) -> float:
    return run_example(np.float64, JacobianMode.ANALYTICAL, ComputeKind.IMPLICIT,
                       argv)


if __name__ == "__main__":
    main()

"""megba_tpu_torch — the PyTorch/CUDA port of megba_tpu.

Bundle adjustment by Levenberg-Marquardt with an implicit Schur-complement
PCG, running on an NVIDIA GPU through hand-written CUDA kernels
(`csrc/`), with plain PyTorch versions of each kernel for the CPU.  It
imports torch and numpy, never jax, and nothing of `megba_tpu`, whose
solver it reproduces (the tests hold the two against each other).

Entry points (`flat_solve`, `solve_bal`) run on CUDA unless asked for the
CPU with `device="cpu"`.  Jacobians come from reverse- or forward-mode
`torch.func` or the closed form (`make_residual_jacobian_fn`), with
optional Huber / Cauchy losses (`rho_and_weight`, `robustify`);
`Jet` / `seed_jets` are JetVector-style forward-mode dual numbers.
`RobustOption(guards=True)` contains faults, and `flat_solve(...,
fault_plan=...)` seeds them (`FaultPlan`, `make_nan_burst`,
`make_point_indefinite_burst`).  `ProblemOption(world_size=N)` solves
over N shards (`parallel/mesh.py`), the 1-D edge-sharded mesh or the 2-D
camera x edge mesh (`SolverOption(mesh_2d=True)`), given N devices that
may repeat one (`flat_solve(..., device=["cuda:0"] * N)`).
"""

from megba_tpu_torch.common import (
    AlgoKind,
    AlgoOption,
    ComputeKind,
    Device,
    EdgeOrder,
    JacobianMode,
    LinearSystemKind,
    PrecondKind,
    PreconditionerKind,
    ProblemOption,
    RobustKind,
    RobustOption,
    SolverKind,
    SolverOption,
    SolveStatus,
    status_name,
)
from megba_tpu_torch.io.bal import BALFile, load_bal, loads_bal, save_bal
from megba_tpu_torch.io.synthetic import make_synthetic_bal
from megba_tpu_torch.ops.jet import Jet, seed_jets
from megba_tpu_torch.ops.residuals import (
    bal_residual,
    build_residual_jacobian_fn,
    make_residual_fn,
    make_residual_jacobian_fn,
)
from megba_tpu_torch.ops.robust import rho_and_weight, robustify
from megba_tpu_torch.robustness.faults import (
    FaultPlan,
    make_nan_burst,
    make_point_indefinite_burst,
)
from megba_tpu_torch.solve import flat_solve, solve_bal

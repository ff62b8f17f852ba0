"""megba_tpu_torch — the PyTorch/CUDA port of megba_tpu.

Bundle adjustment by Levenberg-Marquardt with an implicit Schur-complement
PCG, running on an NVIDIA GPU through hand-written CUDA kernels
(`csrc/`), with plain PyTorch versions of each kernel for the CPU.  It
imports torch and numpy, never jax, and nothing of `megba_tpu`, whose
solver it reproduces (the tests hold the two against each other).

Entry points (`flat_solve`, `solve_bal`) run on CUDA unless asked for the
CPU with `device="cpu"`.
"""

from megba_tpu_torch.common import (
    AlgoKind,
    AlgoOption,
    ComputeKind,
    Device,
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
from megba_tpu_torch.solve import flat_solve, solve_bal

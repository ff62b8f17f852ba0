"""The Levenberg-Marquardt outer loop (lm.py) and its preemption-safe
chunked drivers (checkpointed.py)."""

from megba_tpu_torch.algo.checkpointed import (
    solve_checkpointed,
    solve_pgo_checkpointed,
)
from megba_tpu_torch.algo.lm import LMResult, lm_solve

__all__ = ["LMResult", "lm_solve", "solve_checkpointed",
           "solve_pgo_checkpointed"]

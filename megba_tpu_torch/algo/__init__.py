"""The Levenberg-Marquardt outer loop (lm.py), its preemption-safe
chunked drivers (checkpointed.py) and the lane-batched loop of the fleet
service (lanes.py)."""

from megba_tpu_torch.algo.checkpointed import (
    solve_checkpointed,
    solve_pgo_checkpointed,
)
from megba_tpu_torch.algo.lanes import LaneSolve, lane_lm_solve
from megba_tpu_torch.algo.lm import LMResult, lm_solve

__all__ = ["LMResult", "LaneSolve", "lane_lm_solve", "lm_solve",
           "solve_checkpointed", "solve_pgo_checkpointed"]

"""Host utilities: the phase timer (timing.py) and atomic, checksummed
solver snapshots (checkpoint.py)."""

from megba_tpu_torch.utils.checkpoint import (
    SCHEMA_VERSION,
    load_state,
    save_state,
)
from megba_tpu_torch.utils.timing import (
    PhaseTimer,
    monotonic_s,
    set_phase_hook,
    wall_unix,
)

__all__ = [
    "PhaseTimer",
    "SCHEMA_VERSION",
    "load_state",
    "monotonic_s",
    "save_state",
    "set_phase_hook",
    "wall_unix",
]

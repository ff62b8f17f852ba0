"""Host utilities: the phase timer and the profiler context (timing.py),
atomic, checksummed solver snapshots (checkpoint.py), the debug helpers
(debug.py) and the verbose-curve parser (curves.py)."""

from megba_tpu_torch.utils.checkpoint import (
    SCHEMA_VERSION,
    load_state,
    save_state,
)
from megba_tpu_torch.utils.debug import (
    assert_all_finite,
    describe_array,
    print_blocks,
)
from megba_tpu_torch.utils.timing import (
    PhaseTimer,
    monotonic_s,
    set_phase_hook,
    trace_profile,
    wall_unix,
)

__all__ = [
    "PhaseTimer",
    "SCHEMA_VERSION",
    "assert_all_finite",
    "describe_array",
    "load_state",
    "monotonic_s",
    "print_blocks",
    "save_state",
    "set_phase_hook",
    "trace_profile",
    "wall_unix",
]

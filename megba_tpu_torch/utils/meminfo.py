"""Device memory counters for telemetry (the JAX package's
`utils/meminfo.device_memory_stats`)."""

from __future__ import annotations

from typing import Optional

import torch


def device_memory_stats(device=None) -> Optional[dict]:
    """The caching allocator's counters of one CUDA device under the JAX
    package's names: `bytes_in_use` and `peak_bytes_in_use` (allocated
    bytes now and at peak), `bytes_reserved` (held by the allocator),
    `num_allocs` and `bytes_limit` (the card's memory); None on the CPU
    or without a card.  It reads counters and syncs nothing, so a
    telemetry report can call it once a solve."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    try:
        stats = torch.cuda.memory_stats(device)
    except (RuntimeError, AssertionError):
        return None
    if not stats:
        return None
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "num_allocs": int(stats.get("allocation.all.allocated", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(
            device).total_memory),
    }

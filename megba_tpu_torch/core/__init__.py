"""Feature-major layout helpers, the data model and host-side edge-array
helpers."""

from megba_tpu_torch.core.types import BALData, BAState

__all__ = ["BALData", "BAState"]

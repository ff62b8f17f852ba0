"""Multi-device solve: the device mesh, the collectives over it and the
multi-process runtime (`multihost`)."""

from megba_tpu_torch.parallel.mesh import (
    EDGE_AXIS,
    distributed_lm_solve,
    make_mesh,
    shard_edge_arrays,
)
from megba_tpu_torch.parallel.multihost import initialize_multihost

__all__ = [
    "EDGE_AXIS",
    "distributed_lm_solve",
    "initialize_multihost",
    "make_mesh",
    "shard_edge_arrays",
]

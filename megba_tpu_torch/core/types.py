"""The problem's data model and host-side edge-array helpers.

Counterpart of `megba_tpu/core/types.py`: `BALData` (a vectorised
problem: parameter blocks, edges and their weights) and `BAState` (the
parameters the LM loop carries), as plain dataclasses of tensors or
arrays, and the numpy edge helpers, copied so the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class BALData:
    """A vectorised BA problem (JAX types.py:25), edge-major.

    cameras [Nc, cd] and points [Np, pd] parameter blocks (BAL: 9 and 3);
    obs [nE, od] per-edge measurements; cam_idx / pt_idx [nE] the
    vertices of each edge; mask [nE] 1 for a real edge, 0 for padding;
    sqrt_info [nE, od, od] square-root information matrices (None: the
    identity); cam_fixed / pt_fixed [Nc] / [Np] bool, True = frozen.
    """

    cameras: Any
    points: Any
    obs: Any
    cam_idx: Any
    pt_idx: Any
    mask: Any
    sqrt_info: Optional[Any] = None
    cam_fixed: Optional[Any] = None
    pt_fixed: Optional[Any] = None

    @property
    def num_cameras(self) -> int:
        return self.cameras.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_edge(self) -> int:
        return self.obs.shape[0]

    @property
    def camera_dim(self) -> int:
        return self.cameras.shape[1]

    @property
    def point_dim(self) -> int:
        return self.points.shape[1]


@dataclasses.dataclass
class BAState:
    """The parameters the LM loop carries (JAX types.py:79): an accept
    selects which state goes on."""

    cameras: Any
    points: Any


def is_cam_sorted(cam_idx: np.ndarray) -> bool:
    """True when edges are ordered by nondecreasing camera index."""
    return bool(np.all(np.diff(cam_idx) >= 0))


def pad_edges(
    obs: np.ndarray,
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    multiple: int,
    dtype: Any = np.float64,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad the edge axis to a multiple of `multiple` with masked-out edges.

    Padding edges repeat the LAST edge's vertex indices with weight 0, so
    gathers stay in bounds, segment sums get nothing from them, and a
    camera-sorted order stays sorted.  Returns (obs, cam_idx, pt_idx, mask).
    """
    n = obs.shape[0]
    n_pad = (-n) % multiple
    mask = np.ones(n + n_pad, dtype=dtype)
    if n_pad:
        mask[n:] = 0.0
        obs = np.concatenate([obs, np.zeros((n_pad,) + obs.shape[1:], obs.dtype)])
        cam_idx = np.concatenate([cam_idx, np.full(n_pad, cam_idx[-1] if n else 0, cam_idx.dtype)])
        pt_idx = np.concatenate([pt_idx, np.full(n_pad, pt_idx[-1] if n else 0, pt_idx.dtype)])
    return obs, cam_idx, pt_idx, mask

"""Host-side edge-array helpers (numpy), copied from the JAX package so
the port imports nothing of it."""

from __future__ import annotations

from typing import Any

import numpy as np


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

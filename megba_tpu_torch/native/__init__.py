"""Host graph statistics of a BAL problem.

Counterpart of `megba_tpu/native/__init__.py`'s `degree_stats`, its
NumPy path (megba_tpu/native/__init__.py:160-172), which its C library
computes the same way.  The C BAL parser and the counting edge sort are
not ported.
"""

from __future__ import annotations

import numpy as np

from megba_tpu_torch.core.types import is_cam_sorted


def degree_stats(cam_idx: np.ndarray, pt_idx: np.ndarray, num_cameras: int,
                 num_points: int):
    """Per-vertex degrees and (max_cam_degree, max_pt_degree,
    hpl_nnz_blocks): the camera and point degree counts ([num_cameras]
    and [num_points] int64) and, when the edges are camera-sorted, the
    number of distinct (camera, point) pairs (the Hpl blocks of an
    EXPLICIT system), else -1.  `solve_bal(verbose=True)` prints them."""
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    cam_counts = np.bincount(cam_idx, minlength=num_cameras).astype(np.int64)
    pt_counts = np.bincount(pt_idx, minlength=num_points).astype(np.int64)
    nnz = (int(np.unique(cam_idx.astype(np.int64) * num_points
                         + pt_idx.astype(np.int64)).size)
           if is_cam_sorted(cam_idx) else -1)
    return cam_counts, pt_counts, (int(cam_counts.max(initial=0)),
                                   int(pt_counts.max(initial=0)), nnz)

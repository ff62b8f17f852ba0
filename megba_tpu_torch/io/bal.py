"""BAL (Bundle Adjustment in the Large) dataset IO, in numpy.

The port's own copy of `megba_tpu/io/bal.py` (it imports nothing of the
JAX package and uses no native helper).

Text format (one whitespace-separated token stream — the format the
reference's examples parse line-by-line, examples/BAL_Double.cpp:74-139):

    num_cameras num_points num_observations
    cam_idx pt_idx u v                # x num_observations
    <camera parameter>                # x num_cameras x 9
    <point coordinate>                # x num_points x 3

Cameras are 9-dof: angle-axis(3), translation(3), f, k1, k2.

The file is tokenised with a single `np.fromfile(sep)` call instead of
per-line parsing.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Union

import numpy as np


@dataclasses.dataclass
class BALFile:
    """Parsed BAL problem."""

    cameras: np.ndarray  # [Nc, 9]
    points: np.ndarray  # [Np, 3]
    obs: np.ndarray  # [nE, 2]
    cam_idx: np.ndarray  # [nE] int32
    pt_idx: np.ndarray  # [nE] int32

    @property
    def num_cameras(self) -> int:
        return self.cameras.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_observations(self) -> int:
        return self.obs.shape[0]


def load_bal(path: Union[str, os.PathLike], dtype=np.float64) -> BALFile:
    """Parse a BAL text file (.txt, or the .bz2 the BAL site distributes).

    The whole token stream is read with one numpy call; a .bz2 archive is
    decompressed in memory, so nothing is written beside the archive.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(f"BAL file not found: {path}")
    if str(path).lower().endswith(".bz2"):
        import bz2

        with bz2.open(path, "rb") as f:
            tokens = np.array(f.read().split(), dtype=np.float64)
    else:
        with open(path, "rb") as f:
            tokens = np.fromfile(f, sep=" ")
    return _assemble(tokens, dtype, where=str(path))


def loads_bal(text: str, dtype=np.float64) -> BALFile:
    """Parse BAL content from a string (tests)."""
    tokens = np.array(text.split(), dtype=np.float64)
    return _assemble(tokens, dtype, where="<string>")


def validate_problem(cameras: np.ndarray, points: np.ndarray,
                     obs: np.ndarray, cam_idx: np.ndarray,
                     pt_idx: np.ndarray, *, where: str,
                     unique_edges: bool = True) -> None:
    """Reject semantically-poisoned problems with actionable context.

    Non-finite values and out-of-range indices are refused; so are
    duplicate (cam, pt) edges, which would double-count a factor.  The
    BAL parser and the synthetic generator both route through it.
    """
    cam_idx = np.asarray(cam_idx).reshape(-1)
    pt_idx = np.asarray(pt_idx).reshape(-1)
    n_cam, n_pt = int(cameras.shape[0]), int(points.shape[0])
    n_obs = int(cam_idx.shape[0])
    if n_obs and (int(cam_idx.max()) >= n_cam or int(pt_idx.max()) >= n_pt
                  or int(cam_idx.min()) < 0 or int(pt_idx.min()) < 0):
        raise ValueError(
            f"BAL semantic error in {where}: observation indices out of "
            f"range for {n_cam} cameras / {n_pt} points")
    bad = ~np.isfinite(obs).all(axis=1)
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(
            f"BAL semantic error in {where}: observation {i} "
            f"(cam {int(cam_idx[i])}, pt {int(pt_idx[i])}) has "
            f"non-finite pixel coordinates {np.asarray(obs)[i].tolist()}")
    bad = ~np.isfinite(cameras).all(axis=1)
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(
            f"BAL semantic error in {where}: camera {i} has non-finite "
            f"parameters {np.asarray(cameras)[i].tolist()}")
    bad = ~np.isfinite(points).all(axis=1)
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(
            f"BAL semantic error in {where}: point {i} has non-finite "
            f"coordinates {np.asarray(points)[i].tolist()}")
    # Duplicate refusal is FACTOR semantics, not array hygiene: BAL
    # edges are unique by construction, but a rig factor repeats a
    # (body, point) pair once per physical camera and a prior factor
    # may repeat a constraint — such families pass unique_edges=False
    # (factors.FactorSpec.unique_edges) and skip only this check.
    if n_obs and unique_edges:
        key = (cam_idx.astype(np.int64) * np.int64(n_pt)
               + pt_idx.astype(np.int64))
        uniq, first, counts = np.unique(key, return_index=True,
                                        return_counts=True)
        if (counts > 1).any():
            d = int(first[np.argmax(counts > 1)])
            dupes = np.nonzero(key == key[d])[0]
            raise ValueError(
                f"BAL semantic error in {where}: duplicate observation of "
                f"(cam {int(cam_idx[d])}, pt {int(pt_idx[d])}) at "
                f"observation indices {dupes.tolist()} — BAL edges must be "
                "unique (a repeated row double-counts the factor)")


def _validate(bal: BALFile, where: str) -> None:
    """BALFile adapter over the shared array-based gate."""
    validate_problem(bal.cameras, bal.points, bal.obs, bal.cam_idx,
                     bal.pt_idx, where=where)


def _assemble(tokens: np.ndarray, dtype, where: str = "<tokens>") -> BALFile:
    if tokens.size < 3:
        raise ValueError("not a BAL file: missing header")
    n_cam, n_pt, n_obs = (int(t) for t in tokens[:3])
    expect = 3 + 4 * n_obs + 9 * n_cam + 3 * n_pt
    if tokens.size != expect:
        raise ValueError(
            f"BAL token count mismatch: header promises {expect}, file has {tokens.size}"
        )
    ob = tokens[3 : 3 + 4 * n_obs].reshape(n_obs, 4)
    if not np.isfinite(ob[:, :2]).all():
        i = int(np.argmax(~np.isfinite(ob[:, :2]).all(axis=1)))
        raise ValueError(
            f"BAL semantic error in {where}: observation {i} has a "
            "non-finite camera/point index")
    cam_idx = ob[:, 0].astype(np.int32)
    pt_idx = ob[:, 1].astype(np.int32)
    obs = ob[:, 2:4].astype(dtype)
    if n_obs and (cam_idx.max() >= n_cam or pt_idx.max() >= n_pt or cam_idx.min() < 0 or pt_idx.min() < 0):
        raise ValueError("BAL observation indices out of range")
    off = 3 + 4 * n_obs
    cameras = tokens[off : off + 9 * n_cam].reshape(n_cam, 9).astype(dtype)
    off += 9 * n_cam
    points = tokens[off : off + 3 * n_pt].reshape(n_pt, 3).astype(dtype)
    bal = BALFile(cameras=cameras, points=points, obs=obs, cam_idx=cam_idx, pt_idx=pt_idx)
    _validate(bal, where=where)
    return bal


def save_bal(path: Union[str, os.PathLike], bal: BALFile) -> None:
    """Write a BAL text file (round-trips with load_bal)."""
    with open(path, "w") as f:
        f.write(f"{bal.num_cameras} {bal.num_points} {bal.num_observations}\n")
        for c, p, (u, v) in zip(bal.cam_idx, bal.pt_idx, bal.obs):
            f.write(f"{int(c)} {int(p)} {u:.17g} {v:.17g}\n")
        for cam in bal.cameras:
            f.write("\n".join(f"{x:.17g}" for x in cam) + "\n")
        for pt in bal.points:
            f.write("\n".join(f"{x:.17g}" for x in pt) + "\n")

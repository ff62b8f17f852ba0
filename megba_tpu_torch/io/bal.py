"""BAL (Bundle Adjustment in the Large) dataset IO, in numpy.

The port's own copy of `megba_tpu/io/bal.py` (it imports nothing of the
JAX package).

Text format (one whitespace-separated token stream — the format the
reference's examples parse line-by-line, examples/BAL_Double.cpp:74-139):

    num_cameras num_points num_observations
    cam_idx pt_idx u v                # x num_observations
    <camera parameter>                # x num_cameras x 9
    <point coordinate>                # x num_points x 3

Cameras are 9-dof: angle-axis(3), translation(3), f, k1, k2.

`load_bal` parses with the port's native C++ parser
(megba_tpu_torch.native.parse_bal_native, built with g++ at first use)
and falls back to tokenising the whole file with a single
`np.fromfile(sep)` call, which also has the last word on a malformed
file.  A .bz2 archive is expanded to a temporary text file first, so the
native parser applies to archives too.
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


def _is_ram_backed(directory: str) -> bool:
    """True when `directory` sits on tmpfs/ramfs (Linux; False elsewhere).

    shutil.disk_usage on tmpfs reports a RAM cap as 'free' space, so a
    size check alone would route large decompressions into memory.
    """
    try:
        best_fs, best_len = "", -1
        # surrogateescape: the kernel passes non-UTF-8 mountpoint bytes
        # through raw; they must not raise out of a path heuristic.
        with open("/proc/mounts", errors="surrogateescape") as f:
            real = os.fsencode(os.path.realpath(directory))
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                # /proc/mounts octal-escapes exactly \040 \011 \012 \134
                # (space, tab, newline, backslash); decode those at the
                # byte level so non-ASCII mountpoints compare correctly.
                mnt = os.fsencode(parts[1])
                for esc, raw in ((rb"\040", b" "), (rb"\011", b"\t"),
                                 (rb"\012", b"\n"), (rb"\134", b"\\")):
                    mnt = mnt.replace(esc, raw)
                fstype = parts[2]
                # >= : of duplicate mountpoint entries the LAST one listed
                # is the effective (over)mount.
                if (real == mnt or real.startswith(mnt.rstrip(b"/") + b"/")) \
                        and len(mnt) >= best_len:
                    best_fs, best_len = fstype, len(mnt)
        return best_fs in ("tmpfs", "ramfs")
    except (OSError, ValueError):
        return False


def _load_bz2(path: Union[str, os.PathLike], dtype) -> BALFile:
    """Expand a .bz2 archive to a temporary text file once and parse that
    (JAX io/bal.py:90-129).  The system temp dir is taken when it is
    disk-backed and has room for the expanded text (~5x the archive):
    expanding beside the archive can fill a shared dataset mount when
    several jobs load at once.  A RAM-backed (tmpfs) temp dir is skipped,
    since the expansion would take memory the parse itself needs, and so
    is a full one; then the archive's directory comes first."""
    import bz2
    import shutil
    import tempfile

    need = 5 * os.path.getsize(path) + (64 << 20)
    tmp = tempfile.gettempdir()
    try:
        tmp_ok = (shutil.disk_usage(tmp).free >= need
                  and not _is_ram_backed(tmp))
    except OSError:
        tmp_ok = False
    archive_dir = os.path.dirname(os.path.abspath(path))
    candidates = (None, archive_dir) if tmp_ok else (archive_dir, None)
    last_err = None
    for tmp_dir in candidates:
        try:
            fd, tmp = tempfile.mkstemp(suffix=".txt", dir=tmp_dir)
        except OSError as e:
            last_err = e
            continue
        try:
            with os.fdopen(fd, "wb") as dst, bz2.open(path, "rb") as srcf:
                shutil.copyfileobj(srcf, dst, length=1 << 24)
            return load_bal(tmp, dtype)
        except OSError as e:
            last_err = e
            continue
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    raise last_err


def load_bal(path: Union[str, os.PathLike], dtype=np.float64) -> BALFile:
    """Parse a BAL text file (.txt, or the .bz2 the BAL site distributes).

    The native parser runs first; its arrays pass the same semantic gate
    (`validate_problem`) as the NumPy tokenizer's.  A file the native
    parser refuses for its syntax goes to the NumPy tokenizer, which
    raises the user-facing error if the file is truly malformed; a
    semantic refusal (non-finite values, out-of-range indices, duplicate
    edges) is raised as it is.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(f"BAL file not found: {path}")
    if str(path).lower().endswith(".bz2"):
        return _load_bz2(path, dtype)

    from megba_tpu_torch.native import parse_bal_native

    try:
        parsed = parse_bal_native(str(path), dtype)
        if parsed is not None:
            _validate(parsed, where=str(path))
            return parsed
    except ValueError as exc:
        if _is_semantic_error(exc):
            raise

    with open(path, "rb") as f:
        tokens = np.fromfile(f, sep=" ")
    return _assemble(tokens, dtype, where=str(path))


def loads_bal(text: str, dtype=np.float64) -> BALFile:
    """Parse BAL content from a string (tests)."""
    tokens = np.array(text.split(), dtype=np.float64)
    return _assemble(tokens, dtype, where="<string>")


def _is_semantic_error(exc: BaseException) -> bool:
    """True for _validate's own rejections (they must not be retried
    through the NumPy tokenizer, which would just re-raise them)."""
    return str(exc).startswith("BAL semantic error")


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


# Rows of one formatted write in `save_bal`.
_SAVE_ROWS = 1 << 16


def _write_rows(f, fmt: str, cols) -> None:
    """Write `fmt % row` for each row of the columns `cols` (equal-length
    lists), a block of `_SAVE_ROWS` rows a write."""
    n = len(cols[0])
    for s in range(0, n, _SAVE_ROWS):
        block = [c[s:s + _SAVE_ROWS] for c in cols]
        vals = [v for row in zip(*block) for v in row]
        f.write((fmt * len(block[0])) % tuple(vals))


def save_bal(path: Union[str, os.PathLike], bal: BALFile) -> None:
    """Write a BAL text file (round-trips with load_bal): every value in
    `%.17g` (exact for float64), one observation a line, then one camera
    or point value a line."""
    obs = np.asarray(bal.obs, np.float64)
    with open(path, "w") as f:
        f.write(f"{bal.num_cameras} {bal.num_points} {bal.num_observations}\n")
        _write_rows(f, "%d %d %.17g %.17g\n",
                    [np.asarray(bal.cam_idx).tolist(),
                     np.asarray(bal.pt_idx).tolist(),
                     obs[:, 0].tolist(), obs[:, 1].tolist()])
        for a in (bal.cameras, bal.points):
            _write_rows(f, "%.17g\n",
                        [np.asarray(a, np.float64).reshape(-1).tolist()])

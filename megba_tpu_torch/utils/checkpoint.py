"""Checkpoint / resume to disk: atomic, checksummed .npz snapshots.

Counterpart of `megba_tpu/utils/checkpoint.py`, with its on-disk format:
the same keys (`cameras`, `points`, `region`, `cost`, `iteration`,
`world_size`, `process_index`, `extra_*`, `__schema__`,
`__checksum__`), the same blake2b digest over the same arrays and the
same schema rules, so a snapshot written by either package loads in the
other.  Tensors on any device are copied to the host once each.

Preemption safety is end to end:

- **Atomic writes**: the payload goes to a same-directory temp file, is
  fsync'd (data durable before the rename commits it), then
  `os.replace`d over the target: a SIGKILL at any byte leaves either the
  complete old snapshot or the complete new one, never a torn file.
- **Content checksum + schema version**: `load_state` recomputes the
  digest and compares, so a corrupted or truncated snapshot raises a
  ValueError instead of feeding garbage state into a resume.  Snapshots
  written before the checksum existed load as they are.

Schema v3 is the world header (`world_size`, `process_index`): the
distribution a snapshot was written under.  `load_state(...,
expect_world_size=...)` warns, never fails, on a mismatch: parameters
are replicated, hence world-agnostic.  v2 and legacy checksum-free
snapshots load unchanged.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import warnings
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

# Bumped when the on-disk layout changes incompatibly; load_state
# refuses snapshots from a NEWER schema.  v3 = world/topology header
# fields (additive; v2 and legacy snapshots still load).
SCHEMA_VERSION = 3

_CHECKSUM_KEY = "__checksum__"
_SCHEMA_KEY = "__schema__"


def _host(a) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array: one
    device-to-host copy for a tensor on a card."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _digest(payload: Dict[str, np.ndarray]) -> np.ndarray:
    """blake2b over every array's (name, dtype, shape, bytes), key-sorted
    — deterministic regardless of insertion order; returns uint8[16]."""
    h = hashlib.blake2b(digest_size=16)
    for key in sorted(payload):
        if key == _CHECKSUM_KEY:
            continue
        a = np.ascontiguousarray(np.asarray(payload[key]))
        h.update(key.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return np.frombuffer(h.digest(), np.uint8).copy()


def save_state(path: str, cameras, points, *, region: float = None,
               cost: float = None, iteration: int = None,
               world_size: int = None, process_index: int = None,
               extra: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Atomically snapshot solver state to `path` (.npz, checksummed).

    `cameras`, `points` and the `extra` values may be tensors on any
    device or numpy arrays.  `world_size` / `process_index` are the
    schema-v3 world header."""
    payload = {
        "cameras": _host(cameras),
        "points": _host(points),
    }
    if region is not None:
        payload["region"] = _host(region)
    if cost is not None:
        payload["cost"] = _host(cost)
    if iteration is not None:
        payload["iteration"] = _host(iteration)
    if world_size is not None:
        payload["world_size"] = np.asarray(int(world_size))
    if process_index is not None:
        payload["process_index"] = np.asarray(int(process_index))
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = _host(v)
    payload[_SCHEMA_KEY] = np.asarray(SCHEMA_VERSION)
    payload[_CHECKSUM_KEY] = _digest(payload)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())  # data durable before the rename is
        os.replace(tmp, path)
    finally:
        # A crash between the write and the rename must not leak temp
        # files next to the (still intact) previous snapshot.
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_state(path: str,
               expect_world_size: Optional[int] = None
               ) -> Dict[str, np.ndarray]:
    """Load + validate a snapshot; a dict of numpy arrays with cameras /
    points (+ the header and extras).

    Raises ValueError when the file is truncated or not an npz, or when
    the stored content checksum does not match the arrays; a missing
    file raises FileNotFoundError.  A snapshot of a newer schema is
    refused.  `expect_world_size`: the world size the resuming solve
    runs at; a v3 snapshot recorded at another one warns.
    """
    try:
        with np.load(path) as z:
            state = {k: z[k] for k in z.files}
    except FileNotFoundError:
        # A missing file is "no snapshot", not corruption.
        raise
    except (zipfile.BadZipFile, EOFError, OSError, ValueError) as exc:
        raise ValueError(
            f"checkpoint {path!r} is corrupt or truncated "
            f"({type(exc).__name__}: {exc}); delete it and restart, or "
            "point checkpoint_path at an intact snapshot") from exc
    schema = state.pop(_SCHEMA_KEY, None)
    if schema is not None and int(schema) > SCHEMA_VERSION:
        raise ValueError(
            f"checkpoint {path!r} was written by a newer schema "
            f"(v{int(schema)} > supported v{SCHEMA_VERSION}); upgrade "
            "before resuming")
    checksum = state.pop(_CHECKSUM_KEY, None)
    if checksum is not None:
        full = dict(state)
        if schema is not None:
            full[_SCHEMA_KEY] = schema
        if not np.array_equal(np.asarray(checksum), _digest(full)):
            raise ValueError(
                f"checkpoint {path!r} failed its content checksum — the "
                "snapshot is corrupt; refusing to resume from garbage "
                "state (delete it and restart)")
    if expect_world_size is not None and "world_size" in state:
        saved_ws = int(state["world_size"])
        if saved_ws != int(expect_world_size):
            warnings.warn(
                f"checkpoint {path!r} was written at world_size "
                f"{saved_ws} but this solve runs at world_size "
                f"{int(expect_world_size)}; resuming anyway (elastic "
                "shrink/grow resume — parameters are replicated and "
                "world-agnostic, the edge partition is re-derived)",
                stacklevel=2)
    return state

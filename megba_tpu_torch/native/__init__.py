"""Native (C++) host runtime: the BAL parser and the graph index builder.

The port's own copy of `megba_tpu/native/`: `bal_parser.cpp` (one scan of
the BAL text with std::from_chars) and `index_builder.cpp` (the stable
counting sort of edges by a vertex id, per-vertex degrees and the Hpl
block count, equal shard bounds), bound with ctypes, with the JAX
package's signatures, return types and error texts.

The shared library is built at first use with g++ (`-O3 -std=c++17
-shared -fPIC`, no `-march=native`: the library may be shared by hosts
of different CPUs) into `build/megba_tpu_torch/` beside the package,
where the CUDA kernel libraries go (ops/kernels.BUILD_DIR), under a name
that carries a digest of the two sources, so an edited source never
loads a stale build.  The build writes a temporary name and then
`os.replace`s it, so concurrent first users never load a half-written
library.  A host without g++ (or whose build fails) gets the NumPy paths,
which give equal arrays; `available()` says which one a process runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from megba_tpu_torch.core.types import is_cam_sorted
from megba_tpu_torch.utils.timing import monotonic_s

_DIR = Path(__file__).resolve().parent
SOURCES = ("bal_parser.cpp", "index_builder.cpp")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
# What this process did to get the library: its path, whether it ran g++
# and for how long (chip_smoke.py prints it).
BUILD_INFO: dict = {}


def library_path() -> Path:
    """Where the library of the current sources lives (built or not)."""
    from megba_tpu_torch.ops.kernels import BUILD_DIR

    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((_DIR / name).read_bytes())
    return BUILD_DIR / f"libmegba_native-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(so.name + f".tmp.{os.getpid()}")
    cmd = (["g++", *GXX_FLAGS, "-o", str(tmp)]
           + [str(_DIR / s) for s in SOURCES])
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        so = library_path()
        BUILD_INFO.update(path=str(so), built=False, seconds=0.0)
        if not so.exists():
            t = monotonic_s()
            ok = _build(so)
            BUILD_INFO.update(built=ok, seconds=monotonic_s() - t)
            if not ok:
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _build_failed = True
            return None

        i64, i32, f64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_double
        p = ctypes.POINTER
        lib.megba_bal_header.argtypes = [ctypes.c_char_p, p(i64), p(i64),
                                         p(i64)]
        lib.megba_bal_header.restype = ctypes.c_int
        lib.megba_bal_parse.argtypes = [
            ctypes.c_char_p, i64, i64, i64, p(f64), p(i32), p(i32), p(f64),
            p(f64),
        ]
        lib.megba_bal_parse.restype = ctypes.c_int
        lib.megba_sort_edges.argtypes = [p(i32), i64, i64, p(i64)]
        lib.megba_sort_edges.restype = ctypes.c_int
        lib.megba_degree_stats.argtypes = [
            p(i32), p(i32), i64, i64, i64, p(i64), p(i64), p(i64),
        ]
        lib.megba_degree_stats.restype = ctypes.c_int
        lib.megba_partition_bounds.argtypes = [i64, i64, p(i64)]
        lib.megba_partition_bounds.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is loaded (building it if needed):
    False means this process runs the NumPy paths."""
    return get_lib() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def parse_bal_native(path: str, dtype=np.float64):
    """Parse a BAL file with the native parser; None if lib unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n_cam = ctypes.c_int64()
    n_pt = ctypes.c_int64()
    n_obs = ctypes.c_int64()
    rc = lib.megba_bal_header(path.encode(), ctypes.byref(n_cam),
                              ctypes.byref(n_pt), ctypes.byref(n_obs))
    if rc != 0:
        raise ValueError(f"BAL header parse failed ({rc}): {path}")
    nc, npt, no = n_cam.value, n_pt.value, n_obs.value
    obs = np.empty((no, 2), np.float64)
    cam_idx = np.empty(no, np.int32)
    pt_idx = np.empty(no, np.int32)
    cameras = np.empty((nc, 9), np.float64)
    points = np.empty((npt, 3), np.float64)
    rc = lib.megba_bal_parse(
        path.encode(), nc, npt, no,
        _ptr(obs, ctypes.c_double), _ptr(cam_idx, ctypes.c_int32),
        _ptr(pt_idx, ctypes.c_int32), _ptr(cameras, ctypes.c_double),
        _ptr(points, ctypes.c_double))
    if rc != 0:
        raise ValueError(f"BAL parse failed (code {rc}): {path}")
    from megba_tpu_torch.io.bal import BALFile

    return BALFile(
        cameras=cameras.astype(dtype, copy=False),
        points=points.astype(dtype, copy=False),
        obs=obs.astype(dtype, copy=False),
        cam_idx=cam_idx, pt_idx=pt_idx)


def sort_edges_by_camera(cam_idx: np.ndarray, num_cameras: int) -> np.ndarray:
    """Stable permutation sorting edges by camera (or by any vertex id in
    [0, num_cameras)): a native counting sort when available, else
    np.argsort(kind='stable'); the two are equal."""
    lib = get_lib()
    n = cam_idx.shape[0]
    if lib is None:
        return np.argsort(cam_idx, kind="stable").astype(np.int64)
    cam_idx = np.ascontiguousarray(cam_idx, np.int32)
    perm = np.empty(n, np.int64)
    rc = lib.megba_sort_edges(_ptr(cam_idx, ctypes.c_int32), n, num_cameras,
                              _ptr(perm, ctypes.c_int64))
    if rc != 0:
        raise ValueError(f"sort_edges failed (code {rc})")
    return perm


def degree_stats(cam_idx: np.ndarray, pt_idx: np.ndarray, num_cameras: int,
                 num_points: int):
    """Per-vertex degrees and (max_cam_degree, max_pt_degree,
    hpl_nnz_blocks): the camera and point degree counts ([num_cameras]
    and [num_points] int64) and, when the edges are camera-sorted, the
    number of distinct (camera, point) pairs (the Hpl blocks of an
    EXPLICIT system), else -1.  `solve_bal(verbose=True)` prints them.
    Native when the library is loaded, else NumPy (the same values)."""
    lib = get_lib()
    if lib is None:
        cam_idx = np.asarray(cam_idx)
        pt_idx = np.asarray(pt_idx)
        cam_counts = np.bincount(cam_idx,
                                 minlength=num_cameras).astype(np.int64)
        pt_counts = np.bincount(pt_idx, minlength=num_points).astype(np.int64)
        nnz = (int(np.unique(cam_idx.astype(np.int64) * num_points
                             + pt_idx.astype(np.int64)).size)
               if is_cam_sorted(cam_idx) else -1)
        return cam_counts, pt_counts, (int(cam_counts.max(initial=0)),
                                       int(pt_counts.max(initial=0)), nnz)
    cam_idx = np.ascontiguousarray(cam_idx, np.int32).reshape(-1)
    pt_idx = np.ascontiguousarray(pt_idx, np.int32).reshape(-1)
    if pt_idx.shape != cam_idx.shape:
        raise ValueError(f"degree_stats: {cam_idx.shape[0]} camera and "
                         f"{pt_idx.shape[0]} point indices")
    cam_counts = np.empty(num_cameras, np.int64)
    pt_counts = np.empty(num_points, np.int64)
    stats = np.empty(3, np.int64)
    rc = lib.megba_degree_stats(
        _ptr(cam_idx, ctypes.c_int32), _ptr(pt_idx, ctypes.c_int32),
        cam_idx.shape[0], num_cameras, num_points,
        _ptr(cam_counts, ctypes.c_int64), _ptr(pt_counts, ctypes.c_int64),
        _ptr(stats, ctypes.c_int64))
    if rc != 0:
        raise ValueError(f"degree_stats failed (code {rc})")
    return cam_counts, pt_counts, tuple(int(s) for s in stats)


def partition_bounds(n_edge: int, world_size: int) -> np.ndarray:
    """Equal contiguous shard bounds (padded) for the edge axis."""
    lib = get_lib()
    if lib is None:
        padded = -(-n_edge // world_size) * world_size
        per = padded // world_size
        return np.arange(world_size + 1, dtype=np.int64) * per
    out = np.empty(world_size + 1, np.int64)
    rc = lib.megba_partition_bounds(n_edge, world_size,
                                    _ptr(out, ctypes.c_int64))
    if rc != 0:
        raise ValueError("partition_bounds failed")
    return out

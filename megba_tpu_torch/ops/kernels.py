"""Build and load the port's hand-written CUDA kernels.

Each source `megba_tpu_torch/csrc/<name>.cu` is compiled with `nvcc` for
`sm_90a` into a shared library with a plain C interface and loaded with
ctypes.  The build happens at first use, from the sources in the
checkout, into `build/megba_tpu_torch/` beside the package (listed in
`.gitignore`).  That directory is meant for a checkout of the repository
only: an installed package would build into its install prefix.  The
library name carries a digest of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source never loads a stale
build.

A source that includes no PyTorch header compiles in seconds, where one
built through `torch.utils.cpp_extension.load` takes minutes; each
launcher returns `cudaGetLastError()` and the Python wrapper raises on a
non-zero code (the check `C10_CUDA_KERNEL_LAUNCH_CHECK` would make).  A
launcher first peeks at the error state and returns an error pending
from an earlier launch negated, without launching, so the wrapper names
it as not its own.

Nothing here runs at import time: this module is imported on machines
without `nvcc` or a card, where only the plain PyTorch versions run.
A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "megba_tpu_torch"

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# Compiler output (registers, shared memory, spills per kernel) of each
# build, kept for chip_smoke.py to print.
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "megba_tpu_torch: no CUDA toolkit found (nvcc is needed to "
            "build the kernels in megba_tpu_torch/csrc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.blake2b(digest_size=8)
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp_path, lib_path) or
    None when the library is already built."""
    lib = _lib_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish_build(name: str, started) -> None:
    proc, tmp, lib = started
    out, _ = proc.communicate()
    BUILD_LOGS[name] = out
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"megba_tpu_torch: nvcc failed to build csrc/{name}.cu "
            f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing


def build_all(names: Iterable[str]) -> None:
    """Build every named source, all nvcc processes started together."""
    with _LOCK:
        started = {n: _start_build(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish_build(n, s)


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (once) and load csrc/<name>.cu; `signatures` maps each C
    function to (restype, [argtypes])."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        started = _start_build(name)
        if started is not None:
            _finish_build(name, started)
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (restype, argtypes) in signatures.items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LIBS[name] = lib
        return lib


def raise_on(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise on a launcher's return code (0 = launched)."""
    if code < 0:  # left by an earlier launch; this kernel did not run
        msg = lib.megba_error_string(-code).decode()
        raise RuntimeError(f"{name}: not launched, a CUDA error from an "
                           f"earlier launch is pending ({-code}: {msg})")
    if code != 0:
        msg = lib.megba_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({code}: {msg})")


def current_stream(dev) -> int:
    """The handle of PyTorch's current stream on CUDA device `dev`, the
    stream every launcher enqueues on."""
    import torch

    return torch.cuda.current_stream(dev).cuda_stream

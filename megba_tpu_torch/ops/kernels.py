"""Build and load the port's hand-written CUDA kernels.

Each source `megba_tpu_torch/csrc/<name>.cu` is compiled with `nvcc` for
`sm_90a` into a shared library with a plain C interface and loaded with
ctypes.  The build happens at first use, from the sources in the
checkout, into `build/megba_tpu_torch/` beside the package (listed in
`.gitignore`).  That directory is meant for a checkout of the repository
only: an installed package would build into its install prefix.  The
library name carries a digest of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source never loads a stale
build.  A library may be built with preprocessor definitions of its own
(`load_library(..., defines=)`): a library of one other block shape of
csrc/segtiles.cu or csrc/fused.cu, built at first use, is one.  The
shapes each source is built for are X-macro lists in csrc/*.cuh, which
the wrappers read with `listed_shapes`.

A source that includes no PyTorch header compiles in seconds, where one
built through `torch.utils.cpp_extension.load` takes minutes; each
launcher returns `cudaGetLastError()` and the Python wrapper raises on a
non-zero code (the check `C10_CUDA_KERNEL_LAUNCH_CHECK` would make).  A
launcher first peeks at the error state and returns an error pending
from an earlier launch negated, without launching, so the wrapper names
it as not its own.

The precision arms of the coupling kernels (`csrc/precision.cuh`) are
named here once: `ARMS` maps (row dtype, vector dtype, bf16_operands)
to the arm code the C entry points take, and `check_arm` validates a
call's operands against it.

`nvcc_builds()` counts the builds this process has started: what a
cold replica pays before its first solve (the federation worker reports
it where the JAX package reports retraces).  A replica warmed from an
artifact store (serving/artifacts.py) pays none: `install_library`
puts a library's bytes under its digest name in `BUILD_DIR` (temporary
file, then `os.replace`, since two processes may install one library at
once), and `recording_libraries` names the libraries a piece of code
loads, for an exporter to store.

Nothing here runs at import time: this module is imported on machines
without `nvcc` or a card, where only the plain PyTorch versions run.
A failed build raises; nothing falls back.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "megba_tpu_torch"

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_LOCK = threading.Lock()
_LIBS: Dict[Tuple[str, tuple], ctypes.CDLL] = {}
# Compiler output (registers, shared memory, spills per kernel) of each
# build, kept for chip_smoke.py to print.
BUILD_LOGS: Dict[str, str] = {}
_NVCC_BUILDS = 0  # guarded by _LOCK: nvcc processes this process started
_RECORDERS: List[list] = []  # guarded by _LOCK: recording_libraries lists


def listed_shapes(header: str, macro: str) -> Tuple[Tuple[int, ...], ...]:
    """The integer arguments of each `macro(...)` line of the X-macro
    header csrc/<header> (lines whose arguments are all integers), in
    order: the one list a CUDA dispatch expands and its wrapper reads."""
    text = (CSRC_DIR / header).read_text()
    return tuple(tuple(int(v) for v in args.split(","))
                 for args in re.findall(rf"^{macro}\(([\d,\s]+)\)", text,
                                        re.MULTILINE))


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "megba_tpu_torch: no CUDA toolkit found (nvcc is needed to "
            "build the kernels in megba_tpu_torch/csrc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _define_flags(defines: tuple) -> list:
    return [f"-D{k}={v}" for k, v in defines]


def sources_digest() -> str:
    """A digest of every kernel source and shared header (csrc/*.cu,
    csrc/*.cuh): two processes whose digests differ may build different
    kernels."""
    h = hashlib.blake2b(digest_size=8)
    for path in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()


def library_path(name: str, defines: tuple = ()) -> Path:
    """Where the library of csrc/<name>.cu with `defines` ((name, value)
    pairs, sorted) lives: its digest name in `BUILD_DIR`."""
    defines = tuple(defines)
    h = hashlib.blake2b(digest_size=8)
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(_define_flags(defines))).encode())
    tag = "".join(f"_{v}" for _, v in defines)
    return BUILD_DIR / f"lib{name}{tag}-{h.hexdigest()}.so"


def _start_build(name: str, defines: tuple = ()):
    """Start nvcc for one source; returns (process, tmp_path, lib_path) or
    None when the library is already built."""
    lib = library_path(name, defines)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *_define_flags(defines), "-o",
           str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    global _NVCC_BUILDS
    _NVCC_BUILDS += 1
    return proc, tmp, lib


def _finish_build(name: str, started) -> None:
    proc, tmp, lib = started
    out, _ = proc.communicate()
    BUILD_LOGS[lib.name] = out
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"megba_tpu_torch: nvcc failed to build csrc/{name}.cu into "
            f"{lib.name} (exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing


def build_all(names: Iterable[str]) -> None:
    """Build every named source, all nvcc processes started together."""
    with _LOCK:
        started = {n: _start_build(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish_build(n, s)


def nvcc_builds() -> int:
    """How many nvcc builds this process has started."""
    with _LOCK:
        return _NVCC_BUILDS


def install_library(name: str, defines: tuple, data: bytes) -> Path:
    """Put a built library's bytes under its digest name in `BUILD_DIR`
    (a temporary file of this process, then `os.replace`: a concurrent
    installer or loader sees the whole file or none)."""
    lib = library_path(name, tuple(defines))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=lib.name + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@contextlib.contextmanager
def recording_libraries():
    """Yield a list that collects the (name, defines) key of every
    library `load_library` hands out inside the block (built, loaded or
    already loaded), in first-use order."""
    seen: list = []
    with _LOCK:
        _RECORDERS.append(seen)
    try:
        yield seen
    finally:
        with _LOCK:
            _RECORDERS.remove(seen)


def load_library(name: str, signatures: dict,
                 defines: Optional[Dict[str, int]] = None) -> ctypes.CDLL:
    """Build (once) and load csrc/<name>.cu, with the preprocessor
    `defines` if given (a library of its own); `signatures` maps each C
    function to (restype, [argtypes])."""
    key = (name, tuple(sorted((defines or {}).items())))
    with _LOCK:
        for seen in _RECORDERS:
            if key not in seen:
                seen.append(key)
        lib = _LIBS.get(key)
        if lib is not None:
            return lib
        started = _start_build(*key)
        if started is not None:
            _finish_build(name, started)
        lib = ctypes.CDLL(str(library_path(*key)))
        for fn, (restype, argtypes) in signatures.items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LIBS[key] = lib
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


def count_launch(kernel, arm: str, shape: Optional[tuple] = None) -> None:
    """Count one launch of a kernel wrapper: its total (`launches`), that
    of the arm it launched (`arm_launches`) and, for a kernel built per
    shape, that of the shape (`shape_launches`)."""
    kernel.launches += 1
    kernel.arm_launches[arm] = kernel.arm_launches.get(arm, 0) + 1
    if shape is not None:
        kernel.shape_launches[shape] = kernel.shape_launches.get(shape,
                                                                 0) + 1


def shape_counts(kernels) -> dict:
    """Launches per kernel and shape, as {"name(a,b,...)": count}."""
    return {f"{k.__name__}({','.join(str(int(v)) for v in shape)})": n
            for k in kernels for shape, n in sorted(k.shape_launches.items())}


def reset_counts(kernels) -> None:
    for k in kernels:
        k.launches = 0
        k.arm_launches = {}
        k.shape_launches = {}


def dtype_arm(dtype: torch.dtype) -> str:
    """The arm name of a kernel that takes one float dtype."""
    return "f64" if dtype == torch.float64 else "f32"


def current_stream(dev) -> int:
    """The handle of PyTorch's current stream on CUDA device `dev`, the
    stream every launcher enqueues on."""
    return torch.cuda.current_stream(dev).cuda_stream


# Arm codes of csrc/precision.cuh: (row dtype, vector dtype, bf16_operands)
# -> (code, name).  The vector (a gathered table, or u) sets the
# accumulator and output dtype.
ARMS = {
    (torch.float32, torch.float32, False): (0, "f32"),
    (torch.float64, torch.float64, False): (1, "f64"),
    (torch.bfloat16, torch.float32, False): (2, "mixed"),
    (torch.bfloat16, torch.float32, True): (3, "bf16"),
    (torch.bfloat16, torch.float64, False): (4, "mixed64"),
}
ALL_ARMS = frozenset(name for _, name in ARMS.values())


def check_arm(name: str, vector: torch.Tensor, bf16_operands: bool,
              arms=ALL_ARMS, **rows: torch.Tensor) -> tuple:
    """Validate a kernel's operands on either device: one device,
    contiguous, and a (row dtype, vector dtype, bf16_operands) triple of
    `ARMS` whose arm is in `arms`: rows of the vector's float32 or
    float64 dtype, or bfloat16 rows beside a float32 or float64 vector
    (`bf16_operands` needs bfloat16 rows and a float32 vector).  Returns
    (arm code, arm name)."""
    dev = vector.device
    for k, t in (("vector", vector), *rows.items()):
        if t.device != dev:
            raise ValueError(f"{name}: {k} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    dtypes = {t.dtype for t in rows.values()}
    arm = (ARMS.get((dtypes.pop(), vector.dtype, bool(bf16_operands)))
           if len(dtypes) == 1 else None)
    if arm is None or arm[1] not in arms:
        got = ", ".join(f"{k} {t.dtype}" for k, t in
                        (("vector", vector), *rows.items()))
        raise TypeError(
            f"{name}: dtype {got} with bf16_operands={bool(bf16_operands)}; "
            "the rows must share the vector's float32 or float64 dtype, or "
            "be bfloat16 beside a float32 or float64 vector (bf16_operands "
            f"needs bfloat16 rows and a float32 vector; arms built: "
            f"{', '.join(sorted(arms))})")
    return arm

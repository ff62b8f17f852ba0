"""Artifact store: a bucket's built kernel libraries, for cold start
without nvcc.

Counterpart of `megba_tpu/serving/artifacts.py`.  The JAX package stores
a serialized XLA executable per bucket program.  The port has no
compiled program: its bucket program is a callable (serving/
compile_pool.py), and what a fresh replica pays before its first solve
is building that bucket's kernel libraries with nvcc
(`algo.lanes.prepare_kernels`: kernels 1-3 at (od, cd) and (od, pd),
kernel 6 at cd, kernel 4 where the option launches it, kernel 7 or 8
under `fused_kernels`).  So an artifact holds the built `.so` bytes of
exactly the libraries `prepare_kernels` loads for the bucket's widths
and option, each under its digest name (`ops.kernels.library_path`).
Loading one installs the libraries into `ops.kernels.BUILD_DIR`
(`install_library`: temporary file, then `os.replace`), after which the
bucket's `prepare` finds them built and runs no nvcc.  On the CPU a
bucket needs no library, and its artifact holds an empty set.

Store layout: one file per (bucket, option fingerprint, device type)
under a root directory, named by a digest of the key so a warming
replica finds it without an index:

    <root>/<shape>_l<lanes>_<digest16>.megbaexe

File format, the JAX package's: an 8-byte magic, a 16-byte blake2b
digest of the body, then the pickled document {"schema", "meta",
"libraries"}.  `load` checks magic and digest before unpickling, then
the recorded environment (`current_environment`: the torch version, the
CUDA runtime, the device's name and compute capability, the nvcc flags,
the kernel sources' digest) and the digest names the current sources
give the stored libraries.  Every failure — a missing file, a truncated
or corrupt body, a schema or environment mismatch, a library the
loader refuses — returns None, with an `ArtifactWarning` for all but
the plain miss: the caller builds instead (and refreshes the artifact),
never loads a stale library.  The environment is not part of the file
name, so a stale artifact is found, diagnosed and refreshed in place.

The JAX module's jaxlib hazards (`_prime_native_kernels`, the portable
compile scope) have no counterpart here: a shared library carries its
own code and loads in any process of the same environment.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pickle
import tempfile
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

_MAGIC = b"MEGBAEXE"
ARTIFACT_SCHEMA = "megba_tpu_torch.fleet_artifact/v1"
_DIGEST_SIZE = 16

# How a stored library is opened to check it loads (tests replace it to
# store fake bytes).
_open_library = ctypes.CDLL


class ArtifactWarning(UserWarning):
    """An artifact could not be used; the caller builds instead."""


@dataclasses.dataclass(frozen=True)
class ArtifactKey:
    """Identity of one bucket's artifact: the option fingerprint
    (`compile_pool.option_fingerprint`), the shape class, lanes, block
    widths, the faulted program flag and the device type it runs on."""

    option_fingerprint: str
    shape: str  # ShapeClass str form (c#_p#_e#_dtype)
    lanes: int
    cd: int
    pd: int
    od: int
    faulted: bool = False
    device: str = "cuda"

    def digest(self) -> str:
        h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
        h.update(repr(dataclasses.astuple(self)).encode())
        return h.hexdigest()

    def filename(self) -> str:
        return f"{self.shape}_l{self.lanes}_{self.digest()}.megbaexe"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def current_environment() -> Dict[str, str]:
    """What a stored library is only valid under, and what the
    federation handshake fingerprints: the torch version, the CUDA
    runtime it was built for, the first card's name and compute
    capability ("cpu" / "none" without a card), the nvcc flags and the
    kernel sources' digest."""
    import torch

    from megba_tpu_torch.ops import kernels

    if torch.cuda.is_available():
        device = torch.cuda.get_device_name(0)
        capability = "%d.%d" % torch.cuda.get_device_capability(0)
    else:
        device, capability = "cpu", "none"
    return {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "device": device,
        "capability": capability,
        "nvcc_flags": " ".join(kernels.NVCC_FLAGS),
        "sources": kernels.sources_digest(),
    }


def _library_names(libraries: Sequence[Tuple[str, tuple]]) -> str:
    """The digest file names the current sources give `libraries`."""
    from megba_tpu_torch.ops import kernels

    return ",".join(kernels.library_path(name, tuple(defines)).name
                    for name, defines in libraries)


def _as_keys(entries) -> List[Tuple[str, tuple]]:
    return [(str(n), tuple((str(k), int(v)) for k, v in d))
            for n, d in entries]


class ArtifactStore:
    """On-disk store of bucket artifacts.

    `save` writes atomically (a temporary file of its own, then a
    rename), so concurrent exporters converge on a complete file and
    `load` reads a complete file or nothing.  The store keeps no state
    in memory: one directory serves an exporting service and any number
    of warming replicas.
    """

    def __init__(self, root: str) -> None:
        self.root = str(root)

    def path_for(self, key: ArtifactKey) -> str:
        return os.path.join(self.root, key.filename())

    # -- export ----------------------------------------------------------
    def save(self, key: ArtifactKey,
             libraries: Sequence[Tuple[str, tuple]]) -> str:
        """Store the built libraries `libraries` ((name, defines) keys,
        as `ops.kernels.recording_libraries` yields them) under `key`."""
        from megba_tpu_torch.ops import kernels

        libs = _as_keys(libraries)
        env = dict(current_environment(), libraries=_library_names(libs))
        doc = {
            "schema": ARTIFACT_SCHEMA,
            "meta": {"key": key.to_dict(), "env": env},
            "libraries": [
                {"name": name, "defines": [list(d) for d in defines],
                 "file": kernels.library_path(name, defines).name,
                 "data": kernels.library_path(name, defines).read_bytes()}
                for name, defines in libs],
        }
        body = pickle.dumps(doc)
        digest = hashlib.blake2b(body, digest_size=_DIGEST_SIZE).digest()
        os.makedirs(self.root, exist_ok=True)
        path = self.path_for(key)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(_MAGIC)
                fh.write(digest)
                fh.write(body)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path

    # -- import ----------------------------------------------------------
    def _read_doc(self, path: str) -> Optional[Dict[str, Any]]:
        """The verified document, or None (warned) on any corruption."""
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError:
            return None  # not present: a plain miss, no warning
        head = len(_MAGIC) + _DIGEST_SIZE
        if len(blob) <= head or blob[: len(_MAGIC)] != _MAGIC:
            warnings.warn(
                f"{path}: not a fleet artifact (bad magic or truncated "
                "header); falling back to compile", ArtifactWarning,
                stacklevel=3)
            return None
        digest = blob[len(_MAGIC):head]
        body = blob[head:]
        if hashlib.blake2b(body, digest_size=_DIGEST_SIZE).digest() != digest:
            warnings.warn(
                f"{path}: artifact checksum mismatch (corrupt or "
                "truncated); falling back to compile", ArtifactWarning,
                stacklevel=3)
            return None
        try:
            doc = pickle.loads(body)
        except Exception as exc:
            warnings.warn(
                f"{path}: artifact body failed to unpickle ({exc!r}); "
                "falling back to compile", ArtifactWarning, stacklevel=3)
            return None
        if not isinstance(doc, dict) or doc.get("schema") != ARTIFACT_SCHEMA:
            warnings.warn(
                f"{path}: unknown artifact schema "
                f"{doc.get('schema') if isinstance(doc, dict) else doc!r}; "
                "falling back to compile", ArtifactWarning, stacklevel=3)
            return None
        return doc

    def load(self, key: ArtifactKey) -> Optional[List[str]]:
        """Install `key`'s libraries into `ops.kernels.BUILD_DIR` and
        return their paths (an empty list for a CPU bucket), or None with
        an `ArtifactWarning` naming why (corruption, an environment
        mismatch, a library the loader refuses): the caller builds
        instead, and a later `save` refreshes the stale file in place."""
        from megba_tpu_torch.ops import kernels

        path = self.path_for(key)
        doc = self._read_doc(path)
        if doc is None:
            return None
        entries = doc.get("libraries") or []
        libs = _as_keys((e["name"], e["defines"]) for e in entries)
        recorded = (doc.get("meta") or {}).get("env") or {}
        env = dict(current_environment(), libraries=_library_names(libs))
        mismatched = [
            f"{name}={recorded.get(name)!r} (running {env[name]!r})"
            for name in env if recorded.get(name) != env[name]]
        if mismatched:
            warnings.warn(
                f"{path}: artifact was exported under a different "
                f"environment — {', '.join(mismatched)}; falling back to "
                "compile-and-refresh", ArtifactWarning, stacklevel=2)
            return None
        installed: List[str] = []
        placed: List[str] = []
        try:
            for (name, defines), entry in zip(libs, entries):
                lib = kernels.library_path(name, defines)
                if not lib.exists():
                    kernels.install_library(name, defines, entry["data"])
                    placed.append(str(lib))
                _open_library(str(lib))
                installed.append(str(lib))
        except Exception as exc:
            for p in placed:  # a refused library must not shadow a build
                try:
                    os.unlink(p)
                except OSError:
                    pass
            warnings.warn(
                f"{path}: the loader refused a stored library ({exc!r}); "
                "falling back to compile", ArtifactWarning, stacklevel=2)
            return None
        return installed

    # -- introspection ---------------------------------------------------
    def entries(self) -> List[str]:
        """Artifact file names currently in the store (sorted)."""
        try:
            return sorted(n for n in os.listdir(self.root)
                          if n.endswith(".megbaexe"))
        except OSError:
            return []

    def content_digest(self, key: ArtifactKey) -> Optional[str]:
        """blake2b hexdigest of the artifact's body: a re-export of the
        same libraries under the same environment is byte-identical."""
        try:
            with open(self.path_for(key), "rb") as fh:
                blob = fh.read()
        except OSError:
            return None
        head = len(_MAGIC) + _DIGEST_SIZE
        if len(blob) <= head:
            return None
        return hashlib.blake2b(
            blob[head:], digest_size=_DIGEST_SIZE).hexdigest()

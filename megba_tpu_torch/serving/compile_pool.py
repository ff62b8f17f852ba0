"""Compile pool: the bucket programs of a fleet service.

Counterpart of `megba_tpu/serving/compile_pool.py`.  PyTorch has no
executable to compile, so a bucket "program" is a callable that runs the
lane-batched LM (algo/lanes.py) on a bucket's stacked operands, and
building it does the one-time work its key fixes: resolving the engine
and building, at first use, the kernel libraries of the bucket's block
widths (`algo.lanes.prepare_kernels`: kernels 1-3 at (od, cd) and
(od, pd), kernel 6 at cd, and kernel 7 or 8 under `fused_kernels`).

- `batched_solve_program(engine, option, faulted)` is the callable of a
  configuration, memoised (`utils.memo.normalized_lru_cache`) and
  stripped of the observability knobs, so every spelling of one call
  returns one object.
- `CompilePool.program(...)` hands the batcher the callable of one
  (shape class, lanes, dims) bucket and counts a pool hit when the
  bucket was warmed or dispatched before, a miss otherwise.
- `CompilePool.warm(...)` builds buckets ahead of traffic from manifest
  entries; `save_manifest` / `warm_from_manifest(strict=)` persist the
  observed buckets as JSON in the JAX package's format (`shape`,
  `lanes`, `cd`, `pd`, `od`, `factor`, `faulted`, `option_config`), and
  `ManifestMismatch` names the option fields that drifted.

- `CompilePool(artifacts=...)` takes an `ArtifactStore` (serving/
  artifacts.py) or its root path: `warm`, `warm_from_manifest` and a
  `program` miss try the store before building (a load installs the
  bucket's built kernel libraries, so the build runs no nvcc), and
  `export_artifacts` fills it.  `FleetStats.artifact_loads` /
  `artifact_compiles` and the timer's `artifact_load` / `warm_compile`
  phases split a cold start as in the JAX package.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

from megba_tpu_torch.serving.artifacts import ArtifactKey, ArtifactStore
from megba_tpu_torch.serving.shape_class import ShapeClass
from megba_tpu_torch.utils.memo import normalized_lru_cache

MANIFEST_SCHEMA = "megba_tpu.fleet_manifest/v1"


class ManifestMismatch(ValueError):
    """A warm-up manifest was recorded under another option configuration
    and the caller asked for `strict=` refusal.  `fields` names the
    mismatched fields (dotted paths into the ProblemOption tree)."""

    def __init__(self, path: str, fields: List[str]) -> None:
        self.path = path
        self.fields = list(fields)
        super().__init__(
            f"{path}: manifest was recorded under a different option "
            f"configuration (mismatched: {', '.join(self.fields)}); "
            "refusing to warm under strict=True — re-export the manifest "
            "for this configuration or drop strict to recompile")


def _flatten_config(d: Any, prefix: str = "") -> Dict[str, Any]:
    """Dotted-path flattening of a config_to_dict tree."""
    out: Dict[str, Any] = {}
    if isinstance(d, dict):
        for k, v in d.items():
            out.update(_flatten_config(v, f"{prefix}{k}."))
    else:
        out[prefix[:-1]] = d
    return out


def _sans_telemetry(option):
    """The option without its observability knobs (programs, pool keys
    and manifests do not depend on them)."""
    if (getattr(option, "telemetry", None) is not None
            or getattr(option, "metrics", False)):
        from megba_tpu_torch.common import strip_observability

        return strip_observability(option)
    return option


def _config_mismatches(recorded: Dict[str, Any],
                       current: Dict[str, Any]) -> List[str]:
    from megba_tpu_torch.common import OBSERVABILITY_FIELDS

    a, b = _flatten_config(recorded), _flatten_config(current)
    return sorted(k for k in set(a) | set(b)
                  if k not in OBSERVABILITY_FIELDS and a.get(k) != b.get(k))


def option_fingerprint(option) -> str:
    """A stable digest of an option's configuration (the manifest's
    `option` field; the JAX package records its retrace static key
    there, so the two packages' manifests match on shapes, not on this
    field)."""
    from megba_tpu_torch.observability.report import config_to_dict

    doc = json.dumps(config_to_dict(_sans_telemetry(option)), sort_keys=True)
    return "megba_tpu_torch:" + hashlib.sha256(doc.encode()).hexdigest()[:32]


# pool key -> bucket program, for every bucket warmed or dispatched in
# this process (shared by every pool instance, as the JAX package's AOT
# store is).
_BUILT: Dict[Tuple, Any] = {}
_FROM_ARTIFACT: set = set()  # keys of _BUILT that an artifact installed
_LOCK = threading.Lock()


class BucketProgram:
    """The program of one configuration: `program(*operands,
    initial_region, initial_v[, fault_plan])` runs `algo.lanes.
    lane_lm_solve` on a bucket's lane stacks (serving/batcher.py's
    `_stack_bucket` layout) and returns its `LaneSolve`."""

    def __init__(self, engine, option, faulted: bool) -> None:
        self.engine, self.option, self.faulted = engine, option, faulted

    def prepare(self, cd: int, pd: int, od: int, device=None) -> None:
        from megba_tpu_torch.algo.lanes import check_lane_option, prepare_kernels
        from megba_tpu_torch.common import resolve_device

        check_lane_option(self.option)
        prepare_kernels(cd, pd, od, resolve_device(device, self.option),
                        self.option)

    def __call__(self, cameras, points, obs, cam_idx, pt_idx, mask,
                 cam_fixed, pt_fixed, initial_region, initial_v,
                 fault_plan=None, device=None):
        from megba_tpu_torch.algo.lanes import lane_lm_solve

        if self.faulted != (fault_plan is not None):
            raise ValueError(
                f"bucket program built with faulted={self.faulted} called "
                f"{'with' if fault_plan is not None else 'without'} a "
                "fault plan")
        return lane_lm_solve(
            self.engine, self.option, cameras, points, obs, cam_idx, pt_idx,
            mask, cam_fixed, pt_fixed, initial_region=initial_region,
            initial_v=initial_v, fault_plan=fault_plan, device=device)


def _build_batched_solve(residual_jac_fn, option, faulted=False):
    return BucketProgram(residual_jac_fn, option, faulted)


_cached_batched_solve = normalized_lru_cache(maxsize=64)(
    _build_batched_solve)


def batched_solve_program(residual_jac_fn, option, faulted=False):
    """The bucket program of (engine, option, faulted): one object for
    every spelling of the call, the observability knobs stripped."""
    return _cached_batched_solve(residual_jac_fn, _sans_telemetry(option),
                                 bool(faulted))


def pool_key(engine, option, shape: ShapeClass, lanes: int, cd: int,
             pd: int, od: int, faulted: bool = False) -> Tuple:
    return (engine, option, shape, int(lanes), int(cd), int(pd), int(od),
            bool(faulted))


class CompilePool:
    """Bucket-program registry and warm-up for one fleet service.

    `stats` (serving.stats.FleetStats) counts a hit or miss per
    `program()` request: a hit rode a bucket already built (warmed, or
    dispatched before) in this process.
    """

    def __init__(self, stats=None, artifacts=None, timer=None) -> None:
        self._stats = stats
        self._seen: Dict[Tuple, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        # An ArtifactStore (or its root path) of built kernel libraries:
        # warm() / program() try it before building; export_artifacts
        # fills it.
        if isinstance(artifacts, (str, os.PathLike)):
            artifacts = ArtifactStore(str(artifacts))
        self.artifacts: Optional[ArtifactStore] = artifacts
        # utils.timing.PhaseTimer: artifact loads and builds land as the
        # `artifact_load` / `warm_compile` phases.
        self._timer = timer

    def _phase(self, name: str):
        return (self._timer.phase(name) if self._timer is not None
                else contextlib.nullcontext())

    @staticmethod
    def _artifact_key(option, shape: ShapeClass, lanes: int, cd: int,
                      pd: int, od: int, faulted: bool,
                      device) -> ArtifactKey:
        from megba_tpu_torch.common import resolve_device

        return ArtifactKey(
            option_fingerprint=option_fingerprint(option), shape=str(shape),
            lanes=int(lanes), cd=int(cd), pd=int(pd), od=int(od),
            faulted=bool(faulted),
            device=resolve_device(device, option).type)

    def _try_artifact(self, key: Tuple, program, cd: int, pd: int, od: int,
                      device) -> bool:
        """Install the store's libraries of bucket `key` and prepare its
        program from them (no nvcc); False when the store has no usable
        artifact."""
        if self.artifacts is None:
            return False
        option, shape, lanes, faulted = key[1], key[2], key[3], key[7]
        akey = self._artifact_key(option, shape, lanes, cd, pd, od, faulted,
                                  device)
        with self._phase("artifact_load"):
            if self.artifacts.load(akey) is None:
                return False
            program.prepare(cd, pd, od, device)
        with _LOCK:
            _BUILT.setdefault(key, program)
            _FROM_ARTIFACT.add(key)
        if self._stats is not None:
            self._stats.record_artifact(True)
        return True

    @staticmethod
    def _entry_engine(entry: Dict[str, Any], engine, option):
        """A manifest entry recorded with a `factor` warms that family's
        engine; a factor-less entry the caller's."""
        factor = entry.get("factor")
        if not factor:
            return engine
        from megba_tpu_torch.factors import engine_for

        return engine_for(factor, option.jacobian_mode)

    # -- dispatch path ---------------------------------------------------
    def program(self, engine, option, shape: ShapeClass, lanes: int,
                cd: int, pd: int, od: int, faulted: bool = False,
                factor: Optional[str] = None, device=None):
        """The callable of one bucket on `device` (None: the option's).
        `factor` is recorded on the manifest entry so
        `warm_from_manifest` resolves the bucket's own engine; it does not
        key the program (the engine does)."""
        option = _sans_telemetry(option)
        key = pool_key(engine, option, shape, lanes, cd, pd, od, faulted)
        self._note(key, shape, lanes, cd, pd, od, faulted, factor)
        with _LOCK:
            built = _BUILT.get(key)
        program = batched_solve_program(engine, option, faulted)
        if built is None and self._try_artifact(key, program, cd, pd, od,
                                                device):
            # A bucket this pool never warmed may be in the store: loading
            # it builds nothing, so the request counts as a pool hit.
            built = program
        if self._stats is not None:
            self._stats.record_pool(built is not None)
        if built is not None:
            return built
        program.prepare(cd, pd, od, device)

        def run(*args, **kwargs):
            out = program(*args, **kwargs)
            # The bucket counts as built once a dispatch has returned: a
            # failed first dispatch leaves warm() able to build it.
            with _LOCK:
                _BUILT.setdefault(key, program)
            return out

        return run

    # -- warm-up ---------------------------------------------------------
    def warm(self, engine, option, entries: Sequence[Dict[str, Any]],
             device=None) -> int:
        """Build the given buckets (manifest-entry dicts: {"shape": {...},
        "lanes": n, "cd", "pd", "od", ["factor"], ["faulted"]}) for
        `device` (None: the option's); returns how many were built.
        Buckets already built are skipped.  With a store attached each
        bucket first tries its artifact; a miss (or a stale or corrupt
        artifact, which warns) builds, and the built libraries are saved
        back so the store heals itself."""
        option = _sans_telemetry(option)
        built = 0
        for e in entries:
            shape = ShapeClass.from_dict(e["shape"])
            lanes = int(e["lanes"])
            cd, pd, od = (int(e.get("cd", 9)), int(e.get("pd", 3)),
                          int(e.get("od", 2)))
            faulted = bool(e.get("faulted", False))
            entry_engine = self._entry_engine(e, engine, option)
            key = pool_key(entry_engine, option, shape, lanes, cd, pd, od,
                           faulted)
            self._note(key, shape, lanes, cd, pd, od, faulted,
                       e.get("factor"))
            with _LOCK:
                if key in _BUILT:
                    continue
            program = batched_solve_program(entry_engine, option, faulted)
            if self._try_artifact(key, program, cd, pd, od, device):
                built += 1
                continue
            from megba_tpu_torch.ops import kernels

            with self._phase("warm_compile"), \
                    kernels.recording_libraries() as libs:
                program.prepare(cd, pd, od, device)
            with _LOCK:
                _BUILT.setdefault(key, program)
            if self.artifacts is not None:
                # The artifact counters describe the store's cold-start
                # split: a store-less warm records none.
                if self._stats is not None:
                    self._stats.record_artifact(False)
                try:
                    self.artifacts.save(
                        self._artifact_key(option, shape, lanes, cd, pd, od,
                                           faulted, device), libs)
                except Exception as exc:  # a read-only or full store
                    from megba_tpu_torch.serving.artifacts import (
                        ArtifactWarning,
                    )

                    warnings.warn(
                        f"could not refresh artifact for {shape} "
                        f"(lanes={lanes}): {exc!r}; the bucket is built "
                        "in-process, the store keeps its stale entry",
                        ArtifactWarning, stacklevel=2)
            built += 1
        return built

    def export_artifacts(self, engine, option, compile_missing: bool = True,
                         device=None) -> int:
        """Store the built libraries of every bucket this pool has seen
        for `option` on `device` (None: the option's); returns how many
        artifacts were written.  Buckets the store installed are skipped
        (it holds them already); a bucket not built in this process is
        built here first unless `compile_missing` is False.  The
        exporting service pairs this with `save_manifest`: the manifest
        names the working set, the artifacts make warming it free of
        nvcc."""
        if self.artifacts is None:
            raise ValueError("CompilePool has no ArtifactStore attached")
        from megba_tpu_torch.ops import kernels

        option = _sans_telemetry(option)
        written = 0
        for e in self.entries():
            shape = ShapeClass.from_dict(e["shape"])
            lanes = int(e["lanes"])
            cd, pd, od = (int(e.get("cd", 9)), int(e.get("pd", 3)),
                          int(e.get("od", 2)))
            faulted = bool(e.get("faulted", False))
            entry_engine = self._entry_engine(e, engine, option)
            key = pool_key(entry_engine, option, shape, lanes, cd, pd, od,
                           faulted)
            with _LOCK:
                from_artifact = key in _FROM_ARTIFACT
                built = key in _BUILT
            if from_artifact or not (built or compile_missing):
                continue
            program = batched_solve_program(entry_engine, option, faulted)
            with kernels.recording_libraries() as libs:
                program.prepare(cd, pd, od, device)
            with _LOCK:
                _BUILT.setdefault(key, program)
            self.artifacts.save(
                self._artifact_key(option, shape, lanes, cd, pd, od,
                                   faulted, device), libs)
            written += 1
        return written

    # -- manifests -------------------------------------------------------
    def _note(self, key: Tuple, shape: ShapeClass, lanes: int, cd: int,
              pd: int, od: int, faulted: bool = False,
              factor: Optional[str] = None) -> None:
        entry = {"shape": shape.to_dict(), "lanes": int(lanes),
                 "cd": int(cd), "pd": int(pd), "od": int(od)}
        if faulted:
            entry["faulted"] = True
        if factor:
            entry["factor"] = str(factor)
        with self._lock:
            self._seen.setdefault(key, entry)

    def entries(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(v) for v in self._seen.values()]

    def save_manifest(self, path: str, option=None) -> None:
        """Persist every bucket this pool has seen (atomic write), with
        the option's structured `option_config` so a mismatch on load can
        name the fields that drifted."""
        option_config = None
        if option is not None:
            option = _sans_telemetry(option)
            from megba_tpu_torch.observability.report import config_to_dict

            option_config = config_to_dict(option)
        doc = {
            "schema": MANIFEST_SCHEMA,
            "option": None if option is None else option_fingerprint(option),
            "option_config": option_config,
            "entries": self.entries(),
        }
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)

    def warm_from_manifest(self, path: str, engine, option,
                           strict: bool = False, device=None) -> int:
        """Load a manifest and warm its buckets for `option`.  A manifest
        recorded under another option configuration warns and warms the
        shapes for `option` anyway, or with `strict=True` raises
        `ManifestMismatch` naming the drifted fields.  The comparison is
        on the structured `option_config` (the `option` digest differs
        between the two packages)."""
        with open(path) as fh:
            doc = json.load(fh)
        if doc.get("schema") != MANIFEST_SCHEMA:
            raise ValueError(
                f"{path}: not a fleet warmup manifest "
                f"(schema={doc.get('schema')!r})")
        from megba_tpu_torch.observability.report import config_to_dict

        recorded_config = doc.get("option_config")
        if recorded_config is not None:
            fields = _config_mismatches(recorded_config,
                                        config_to_dict(option))
        elif (doc.get("option") is not None
              and doc["option"] != option_fingerprint(option)):
            fields = ["<option fingerprint; manifest predates "
                      "structured option_config>"]
        else:
            fields = []
        if fields:
            if strict:
                raise ManifestMismatch(path, fields)
            warnings.warn(
                f"{path}: manifest was recorded under a different option "
                f"configuration (mismatched: {', '.join(fields)}); "
                "warming its shape classes for the current options",
                stacklevel=2)
        return self.warm(engine, option, doc.get("entries", ()), device)


def reset_process_cache() -> None:
    """Forget every bucket built in this process (a fresh replica's pool
    state), for tests and benchmarks."""
    with _LOCK:
        _BUILT.clear()
        _FROM_ARTIFACT.clear()

"""SolveReport: a structured, machine-readable record of one solve.

Counterpart of `megba_tpu/observability/report.py`, schema v2 with the
same JSON keys, so the summarize tool of either package reads the
reports of the other.  One JSON line per solve: the problem's shape, the
whole `ProblemOption`, the device topology, the `PhaseTimer` phases, the
device memory counters (CUDA only), the final scalars and the trace.

The sink is opt-in JSONL: `ProblemOption(telemetry=<path>)` or the
`MEGBA_TELEMETRY` environment variable (the knob wins) appends one line
per `flat_solve` call, and one per problem for `solve_many` and
`FleetQueue` (with the `fleet` block: bucket, lane, batch latency, the
service's counters).  `python -m megba_tpu_torch.observability.summarize`
renders them.  With telemetry off this module is never imported.

`trace_id` / `span_id` are the active span's context when `MEGBA_TRACE`
is armed (observability/spans.py), else None.  The port has no
federation worker yet: `worker` is always None.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

SCHEMA = "megba_tpu.solve_report/v2"


def _status_name(code) -> str:
    from megba_tpu_torch.common import status_name

    return status_name(code)


def config_to_dict(option) -> Dict[str, Any]:
    """An option dataclass tree as plain JSON types: enums by name,
    dtypes by numpy name, nested options as nested dicts."""
    def conv(v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {f.name: conv(getattr(v, f.name))
                    for f in dataclasses.fields(v)}
        if isinstance(v, enum.Enum):
            return v.name
        if isinstance(v, (np.integer, np.floating, np.bool_)):
            return v.item()
        if isinstance(v, (np.dtype, type)):
            return np.dtype(v).name
        return v

    return conv(option)


def backend_topology(device=None) -> Dict[str, Any]:
    """The platform and devices of this run, under the JAX package's
    keys: backend "gpu" with the card's name when `device` (default: the
    current CUDA device when there is one) is a CUDA device, else "cpu";
    one process."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        kinds = sorted({torch.cuda.get_device_name(i) for i in range(count)})
        backend = "gpu"
    else:
        count, kinds, backend = 1, ["cpu"], "cpu"
    return {
        "backend": backend,
        "device_count": count,
        "local_device_count": count,
        "device_kinds": kinds,
        "process_index": 0,
        "process_count": 1,
    }


@dataclasses.dataclass
class SolveReport:
    """One solve's telemetry record; `to_json` / `from_json` round-trip.
    The fields are the JAX package's: `program_audit`, `elastic`,
    `federation` and `tiles` stay None here."""

    problem: Dict[str, Any]
    config: Dict[str, Any]
    backend: Dict[str, Any]
    phases: Dict[str, Any]
    result: Dict[str, Any]
    trace: Optional[Dict[str, list]] = None
    memory: Optional[Dict[str, Any]] = None
    program_audit: Optional[Dict[str, Any]] = None
    fleet: Optional[Dict[str, Any]] = None
    elastic: Optional[Dict[str, Any]] = None
    federation: Optional[Dict[str, Any]] = None
    health: Optional[Dict[str, Any]] = None
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    worker: Optional[str] = None
    tiles: Optional[Dict[str, Any]] = None
    schema: str = SCHEMA
    created_unix: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "SolveReport":
        d = json.loads(line)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _decode_fallback_totals(trace, iterations: int
                            ) -> Optional[Dict[str, Any]]:
    """The trace's enum-coded precond_fallback codes summed per level:
    'block' (SCHUR_DIAG blocks fallen back), 'coarse' (iterations with a
    degraded coarse level) and, when one degraded, 'coarse_levels'."""
    if trace is None or getattr(trace, "precond_fallback", None) is None:
        return None
    from megba_tpu_torch.solver.precond import (
        decode_precond_fallback,
        decode_precond_fallback_levels,
    )

    block = coarse = 0
    per_level: list = []
    codes = torch.as_tensor(trace.precond_fallback).cpu().tolist()
    for code in codes[:iterations]:
        block += decode_precond_fallback(code)["block"]
        levels = decode_precond_fallback_levels(code)
        if any(levels):
            coarse += 1
        for i, flag in enumerate(levels):
            while len(per_level) <= i:
                per_level.append(0)
            per_level[i] += int(flag)
    out: Dict[str, Any] = {"block": int(block), "coarse": int(coarse)}
    if any(per_level):
        out["coarse_levels"] = per_level
    return out


def build_report(option, result, phases: Dict[str, Any],
                 problem: Dict[str, Any],
                 fleet: Optional[Dict[str, Any]] = None,
                 health: Optional[Dict[str, Any]] = None,
                 device=None) -> SolveReport:
    """Assemble a SolveReport from a finished solve (`result` an
    `LMResult`); reads its scalars and trace to the host."""
    from megba_tpu_torch import observability as _obs
    from megba_tpu_torch.observability.trace import trace_to_dict
    from megba_tpu_torch.utils.meminfo import device_memory_stats

    iterations = int(result.iterations)
    trace = getattr(result, "trace", None)
    status = getattr(result, "status", None)
    recoveries = getattr(result, "recoveries", None)
    result_block = {
        "initial_cost": float(result.initial_cost),
        "final_cost": float(result.cost),
        "iterations": iterations,
        "accepted": int(result.accepted),
        "pcg_iterations": int(result.pcg_iterations),
        "region": float(result.region),
        "stopped": bool(result.stopped),
        "status": None if status is None else int(status),
        "status_name": None if status is None else _status_name(status),
        "recoveries": None if recoveries is None else int(recoveries),
        "precond_fallback": _decode_fallback_totals(trace, iterations),
    }
    recorder = _obs.span_recorder()
    span_ctx = None if recorder is None else recorder.context()
    return SolveReport(
        problem=problem,
        config=config_to_dict(option),
        backend=backend_topology(device),
        phases=phases,
        result=result_block,
        trace=None if trace is None else trace_to_dict(trace, iterations),
        memory=device_memory_stats(device),
        fleet=fleet,
        health=health,
        trace_id=None if span_ctx is None else span_ctx["trace_id"],
        span_id=None if span_ctx is None else span_ctx["span_id"],
        created_unix=time.time(),
    )


def append_report(report: SolveReport, path: str) -> None:
    """Append one report as a JSONL line (creates parent directories)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "a") as fh:
        fh.write(report.to_json() + "\n")

"""The port's program auditor: a launch, collective and host-read census
of the canonical solves, against a committed budget.

Counterpart of `megba_tpu/analysis/program_audit.py`, which AOT-lowers
the JAX package's canonical programs and audits their HLO; it also takes
the roles of JAX's `hlo.py`, `budget.py` and `audit.py`.  The port
compiles no program, so it runs each canonical spec (JAX's names and
small sizes, program_audit.py:831-1030) as a real solve and counts, per
LM iteration and per PCG iteration:

- host reads of device values: `item`, `tolist`, `__bool__`,
  `__float__`, `__int__`, `__index__`, `numpy` and `cpu` (a
  device-to-host copy), seen through a `torch.overrides.TorchFunctionMode`
  — the same calls on the CPU and on a card, where each one
  synchronises the host with the device;
- collectives by kind (`psum`, `psum_groups`, `psum_scatter`,
  `all_gather`, `ppermute`: parallel/collectives.py, the outermost call);
- kernel-wrapper calls by arm (`kernel:<wrapper>:<arm>`), counted where
  the wrapper launches its kernel on a card or runs its plain version on
  the CPU.

The solver's loops mark every LM and PCG iteration (analysis/census.py),
and everything between two marks belongs to the iteration the first
opened: a PCG iteration carries its body and the loop test after it, an
LM iteration everything else of its step, the PCG set-up included.  Each
count's per-iteration value is the MODE over the spec's iterations, so
the figures do not depend on how many iterations a run took, and a card
run gives the CPU's figures.  A card run also counts the synchronisations
`torch.cuda.set_sync_debug_mode` reports (`syncs`, not budgeted), and
the ops and calling lines of the LM iterations' ones (`lm_sync_sites`).

The budget (`audit_budget.json` beside this module) holds each spec's
per-iteration figures and JAX's declared `pcg_psums` beside the port's
sums per PCG iteration (`psum` + `psum_groups`, the all-reduces), with
the reason where the two differ.  CLI:

    python -m megba_tpu_torch.analysis.program_audit --check
    python -m megba_tpu_torch.analysis.program_audit --update
    python -m megba_tpu_torch.analysis.program_audit --device cuda:0 --check

Exit 0 when every spec matches the budget, 1 on a mismatch, 2 on a
usage error.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from megba_tpu_torch.analysis import census

BUDGET_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "audit_budget.json")

# Tensor methods that read a device value on the host.
HOST_READS = frozenset({"item", "tolist", "__bool__", "__float__",
                        "__int__", "__index__", "numpy", "cpu"})

# JAX's canonical spec that the port does not run, and why.
PORT_SKIPPED = {
    "ba_tiled_f32": "the port has one lowering: JAX's use_tiled (the TPU "
                    "tile plans) was left out on purpose (ROADMAP Queue 1)",
}

# The kinds that are an all-reduce (JAX's pcg_psums counts all-reduces).
SUM_KINDS = ("psum", "psum_groups")


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One canonical solve: JAX's name and declared all-reduces per PCG
    iteration, and `run(device)`, the solve on `device` (its world on
    that one device's shards)."""

    name: str
    pcg_psums: int
    run: Callable[[str], object]


# ------------------------------------------------------------ problems


def _ba_problem(multilevel: bool = False):
    from megba_tpu_torch.io.synthetic import make_synthetic_bal

    if multilevel:
        return make_synthetic_bal(
            num_cameras=12, num_points=60, obs_per_point=3, seed=0,
            param_noise=4e-2, pixel_noise=0.3, dtype=np.float32,
            locality="ring")
    return make_synthetic_bal(
        num_cameras=4, num_points=24, obs_per_point=3, seed=0,
        param_noise=4e-2, pixel_noise=0.3, dtype=np.float32)


def _ba_option():
    from megba_tpu_torch.common import AlgoOption, ProblemOption, SolverOption

    return ProblemOption(
        dtype=np.float32,
        algo_option=AlgoOption(max_iter=3),
        solver_option=SolverOption(max_iter=8, tol=1e-8))


def _devices(device: str, world: int):
    return device if world == 1 else [device] * world


def _run_ba(device: str, world: int = 1, forcing: bool = False,
            guarded: bool = False, twolevel: bool = False,
            multilevel: bool = False, mesh2d: bool = False,
            bf16: bool = False):
    from megba_tpu_torch.common import (
        JacobianMode,
        PrecondKind,
        RobustOption,
        SolverOption,
    )
    from megba_tpu_torch.ops.residuals import make_residual_jacobian_fn
    from megba_tpu_torch.solve import flat_solve

    s = _ba_problem(multilevel)
    option = dataclasses.replace(_ba_option(), world_size=world)
    so = option.solver_option
    if mesh2d:
        so = dataclasses.replace(so, mesh_2d=True, cam_blocks=2)
    if forcing:
        so = SolverOption(max_iter=8, tol=1e-1, forcing=True,
                          warm_start=True)
    if twolevel:
        so = dataclasses.replace(so, precond=PrecondKind.TWO_LEVEL)
    if multilevel:
        so = dataclasses.replace(so, precond=PrecondKind.MULTILEVEL,
                                 coarsen_factor=2.0, max_levels=3)
    if bf16:
        so = dataclasses.replace(so, bf16=True, bf16_collectives=True)
    option = dataclasses.replace(option, solver_option=so)
    if guarded:
        option = dataclasses.replace(option,
                                     robust_option=RobustOption(guards=True))
    f = make_residual_jacobian_fn(mode=JacobianMode.AUTODIFF)
    return flat_solve(f, s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx,
                      option, device=_devices(device, world))


def _run_batched(device: str, lanes: int = 4):
    """The lane-batched bucket program: `lanes` problems of the canonical
    shape in one bucket (serving/batcher.solve_many)."""
    from megba_tpu_torch.io.synthetic import make_synthetic_bal
    from megba_tpu_torch.serving.batcher import FleetProblem, solve_many

    probs = []
    for seed in range(lanes):
        s = make_synthetic_bal(num_cameras=4, num_points=24,
                               obs_per_point=3, seed=seed,
                               param_noise=4e-2, pixel_noise=0.3,
                               dtype=np.float32)
        probs.append(FleetProblem(s.cameras0, s.points0, s.obs, s.cam_idx,
                                  s.pt_idx, name=f"lane{seed}"))
    return solve_many(probs, _ba_option(), device=device)


def _run_factor(device: str, factor: str, dtype=np.float32):
    from megba_tpu_torch.solve import flat_solve

    if factor == "rig":
        from megba_tpu_torch.factors.rig import make_synthetic_rig

        s = make_synthetic_rig(num_bodies=4, num_points=24, seed=0,
                               dtype=dtype)
    elif factor == "pinhole_radial":
        from megba_tpu_torch.factors.radial import make_synthetic_radial

        s = make_synthetic_radial(num_cameras=4, num_points=24, seed=0,
                                  dtype=dtype)
    else:
        from megba_tpu_torch.factors.priors import make_synthetic_priors

        s = make_synthetic_priors(num_poses=8, seed=0, dtype=dtype)
    option = dataclasses.replace(_ba_option(), dtype=dtype)
    return flat_solve(None, s.cameras0, s.points0, s.obs, s.cam_idx,
                      s.pt_idx, option, factor=factor, device=device)


def _pgo_option(world: int):
    from megba_tpu_torch.common import AlgoOption, ProblemOption, SolverOption

    return ProblemOption(
        dtype=np.float64, world_size=world,
        algo_option=AlgoOption(max_iter=3),
        solver_option=SolverOption(max_iter=8, tol=1e-10))


def _run_pgo(device: str, world: int = 1, sim3: bool = False):
    from megba_tpu_torch.models.pgo import solve_pgo

    if sim3:
        from megba_tpu_torch.factors.sim3 import make_synthetic_sim3_graph

        g = make_synthetic_sim3_graph(num_poses=16, loop_closures=4, seed=1)
        return solve_pgo(g.poses0, g.edge_i, g.edge_j, g.meas,
                         _pgo_option(world), factor="sim3_between",
                         device=_devices(device, world))
    from megba_tpu_torch.models.pgo import make_synthetic_pose_graph

    g = make_synthetic_pose_graph(num_poses=16, loop_closures=4, seed=1)
    return solve_pgo(g.poses0, g.edge_i, g.edge_j, g.meas,
                     _pgo_option(world), device=_devices(device, world))


def program_specs() -> Dict[str, ProgramSpec]:
    """name -> spec for every canonical spec the port runs (JAX's names;
    `PORT_SKIPPED` lists the one it does not)."""
    def ba(name, world, psums, **kw):
        return ProgramSpec(name, psums, lambda d: _run_ba(d, world, **kw))

    specs = [
        ba("ba_single_f32", 1, 0),
        ba("ba_sharded_w2_f32", 2, 2),
        ba("ba_forcing_w2_f32", 2, 2, forcing=True),
        ba("ba_guarded_w2_f32", 2, 2, guarded=True),
        ba("ba_twolevel_w2_f32", 2, 2, twolevel=True),
        ba("ba_multilevel_w2_f32", 2, 2, multilevel=True),
        ba("ba_2d_w4_f32", 4, 2, mesh2d=True),
        ba("ba_bf16_w2_f32", 2, 2, bf16=True),
        ba("ba_bf16_2d_w4_f32", 4, 2, mesh2d=True, bf16=True),
        ProgramSpec("ba_batched_b4_f32", 0, _run_batched),
        ProgramSpec("ba_rig_single_f32", 0,
                    lambda d: _run_factor(d, "rig")),
        ProgramSpec("ba_radial_single_f32", 0,
                    lambda d: _run_factor(d, "pinhole_radial")),
        ProgramSpec("prior_single_f64", 0,
                    lambda d: _run_factor(d, "pose_prior", np.float64)),
        ProgramSpec("pgo_sim3_single_f64", 0,
                    lambda d: _run_pgo(d, 1, sim3=True)),
        ProgramSpec("pgo_single_f64", 0, lambda d: _run_pgo(d, 1)),
        ProgramSpec("pgo_sharded_w2_f64", 1, lambda d: _run_pgo(d, 2)),
    ]
    return {s.name: s for s in specs}


# -------------------------------------------------------------- census


class _ReadMode(TorchFunctionMode):
    """Counts the host reads into the census's running counter."""

    def __init__(self, owner: "Census"):
        super().__init__()
        self.owner = owner

    def __torch_function__(self, func, types, args=(), kwargs=None):
        owner = self.owner
        name = getattr(func, "__name__", None)
        if name in HOST_READS:
            owner.running["host_reads"] += 1
        seen = len(owner._warnings)
        out = func(*args, **(kwargs or {}))
        if len(owner._warnings) > seen and owner._state is owner._lm_state:
            owner.sync_sites[f"{name} at {_caller()}"] += (
                len(owner._warnings) - seen)
        return out


def _caller() -> str:
    """file:line of the innermost frame of the port outside this
    package (the line that called a synchronising op)."""
    here = os.path.dirname(os.path.abspath(__file__))
    f = sys._getframe(2)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if "megba_tpu_torch" in path and not path.startswith(here):
            return f"{os.path.relpath(path)}:{f.f_lineno}"
        f = f.f_back
    return "?"


class Census:
    """Open around one solve: attributes every count to the LM or PCG
    iteration it falls in (analysis/census.py's marks)."""

    def __init__(self, sync_debug: bool = False):
        self.sync_debug = sync_debug
        self.running: collections.Counter = collections.Counter()
        self.lm: List[collections.Counter] = []
        self.pcg: List[collections.Counter] = []
        self.setup: collections.Counter = collections.Counter()
        self._state = self.setup
        self._lm_state = None
        self._warnings: list = []
        # The LM iterations' synchronisations by op and calling line.
        self.sync_sites: collections.Counter = collections.Counter()

    def _close_span(self) -> None:
        if self.sync_debug:
            self.running["syncs"] += len(self._warnings)
            self._warnings.clear()
        self._state.update(self.running)
        self.running = collections.Counter()

    def _hook(self, what: str, detail: str) -> None:
        if what == "collective":
            self.running[f"coll:{detail}"] += 1
        elif what == "kernel":
            self.running[f"kernel:{detail}"] += 1
        elif what == "mark":
            self._close_span()
            if detail == "lm":
                self._lm_state = collections.Counter()
                self.lm.append(self._lm_state)
                self._state = self._lm_state
            elif detail == "pcg":
                self._state = collections.Counter()
                self.pcg.append(self._state)
            elif detail == "pcg_done":
                self._state = (self.setup if self._lm_state is None
                               else self._lm_state)
            elif detail == "lm_done":
                self._lm_state = None
                self._state = self.setup

    def __enter__(self) -> "Census":
        self._mode = _ReadMode(self)
        census.set_hook(self._hook)
        if self.sync_debug:
            self._catch = warnings.catch_warnings(record=True)
            self._warnings = self._catch.__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._mode.__exit__(*exc)
        if self.sync_debug:
            torch.cuda.set_sync_debug_mode("default")
        self._close_span()
        if self.sync_debug:
            self._catch.__exit__(*exc)
        census.set_hook(None)

    def _mode_of(self, iters: List[collections.Counter]) -> Dict[str, int]:
        keys = sorted({k for c in iters for k in c})
        out = {}
        for k in keys:
            vals = collections.Counter(c.get(k, 0) for c in iters)
            top = max(vals.values())
            v = min(x for x, n in vals.items() if n == top)
            if v:
                out[k] = int(v)
        return out

    def record(self) -> dict:
        per_lm = self._mode_of(self.lm)
        per_pcg = self._mode_of(self.pcg)
        syncs = {"per_lm": per_lm.pop("syncs", 0),
                 "per_pcg": per_pcg.pop("syncs", 0)}
        rec = {"lm_iterations": len(self.lm),
               "pcg_iterations": len(self.pcg),
               "per_lm": per_lm, "per_pcg": per_pcg,
               "pcg_sums": sum(per_pcg.get(f"coll:{k}", 0)
                               for k in SUM_KINDS)}
        if self.sync_debug:
            rec["syncs"] = syncs
            rec["lm_sync_sites"] = dict(self.sync_sites.most_common(8))
        return rec


def audit_spec(spec: ProgramSpec, device: str = "cpu") -> dict:
    """Run one spec under the census; returns its record."""
    sync = torch.device(device).type == "cuda"
    c = Census(sync_debug=sync)
    with c:
        spec.run(device)
    rec = c.record()
    rec["jax_pcg_psums"] = spec.pcg_psums
    return rec


def audit_all(names: Optional[List[str]] = None,
              device: str = "cpu") -> Dict[str, dict]:
    specs = program_specs()
    if names:
        unknown = sorted(set(names) - set(specs))
        if unknown:
            raise ValueError(
                f"unknown spec(s) {unknown}; known: {sorted(specs)}")
        specs = {n: specs[n] for n in names}
    return {name: audit_spec(spec, device) for name, spec in specs.items()}


# -------------------------------------------------------------- budget


def load_budget(path: str = BUDGET_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def check_against(records: Dict[str, dict], budget: dict) -> List[str]:
    """The mismatches of `records` against `budget` (empty: all match)."""
    out = []
    specs = budget["specs"]
    for name, rec in records.items():
        want = specs.get(name)
        if want is None:
            out.append(f"{name}: no budget entry")
            continue
        for key in ("per_lm", "per_pcg", "pcg_sums"):
            if rec[key] != want[key]:
                out.append(f"{name}: {key} {rec[key]} != budget "
                           f"{want[key]}")
        if rec["pcg_sums"] != rec["jax_pcg_psums"] and not want.get(
                "pcg_sums_note"):
            out.append(f"{name}: {rec['pcg_sums']} sums per PCG iteration "
                       f"against JAX's {rec['jax_pcg_psums']}, and the "
                       "budget gives no reason")
    return out


def update_budget(records: Dict[str, dict], path: str = BUDGET_PATH) -> None:
    """Rewrite the budget's figures from `records`, keeping each spec's
    note."""
    old = load_budget(path) if os.path.exists(path) else {"specs": {}}
    specs = {}
    for name, rec in sorted(records.items()):
        entry = {k: rec[k] for k in ("per_lm", "per_pcg", "pcg_sums",
                                      "jax_pcg_psums")}
        note = old["specs"].get(name, {}).get("pcg_sums_note")
        if note:
            entry["pcg_sums_note"] = note
        specs[name] = entry
    out = {"_about": old.get("_about", ""), "skipped": PORT_SKIPPED,
           "specs": specs}
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m megba_tpu_torch.analysis.program_audit",
        description="the census of the canonical solves against "
                    "audit_budget.json")
    ap.add_argument("--check", action="store_true",
                    help="compare with the committed budget (default)")
    ap.add_argument("--update", action="store_true",
                    help="rewrite the budget from this run")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--only", action="append", default=None,
                    metavar="SPEC", help="run only this spec (repeatable)")
    ap.add_argument("--json", default=None,
                    help="also write the records to this file")
    args = ap.parse_args(argv)
    if args.check and args.update:
        print("error: --check and --update exclude each other",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    try:
        records = audit_all(args.only, args.device)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    for name, rec in records.items():
        print(f"{name}: lm {rec['lm_iterations']} pcg "
              f"{rec['pcg_iterations']} per_lm {rec['per_lm']} per_pcg "
              f"{rec['per_pcg']}" + (f" syncs {rec['syncs']}"
                                     if "syncs" in rec else ""))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1, sort_keys=True)
    if args.update:
        update_budget(records)
        print(f"updated {BUDGET_PATH}")
        return 0
    bad = check_against(records, load_budget())
    for line in bad:
        print(f"MISMATCH {line}")
    print(f"{len(records)} spec(s), {len(bad)} mismatch(es)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

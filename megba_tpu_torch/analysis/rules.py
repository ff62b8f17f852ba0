"""The lint rules of the port.  Each rule is a generator over a
PackageIndex.

Counterpart of `megba_tpu/analysis/rules.py`, with the rules whose
subject exists in the port.  Rule ids are kebab-case; suppress one
finding with an inline `# megba: allow-<rule>` pragma on the flagged
physical line.

| id | contract it enforces |
|---|---|
| raw-clock | no raw `time.time()` / `time.perf_counter()` outside the clock homes (`utils/timing.py`, `observability/`): use `utils.timing.monotonic_s()` for durations and `utils.timing.wall_unix()` for epoch stamps.  `time.monotonic()` deadline arithmetic and `time.sleep` are clean.  STRICT lane (`serving/transport.py`, `robustness/netfaults.py`): `time.monotonic()` is banned there too — transport deadlines ride `monotonic_s()` exclusively |
| guarded-by | shared mutable attributes of lock-owning classes, declared with `# megba: guarded-by(<lockattr>)` on the assignment (or inferred at >= 80% locked accesses in thread-reachable classes), must not be read/written outside a `with <lock>` block (analysis/concurrency.py); `# megba: allow-unguarded` is the per-line escape hatch |
| lock-order | the package-wide acquires-while-holding digraph must be acyclic; the finding prints the witness path |
| blocking-under-lock | no call from the curated blocking set (`Future.result`, `queue.get`/`join`, socket/pipe `recv*`, `.wait`, `time.sleep` above 0.05 s, the RPC `_recv_frame`) while any lock is held; waiting on a HELD Condition is the sanctioned exception |
| stale-program | every option field READ on the lowering closure (flat_solve / distributed_lm_solve / batched_solve_program / lane_lm_solve / solve_pgo and everything they reach) must be visible to the key surfaces (analysis/identity.py) |
| cache-split | an option field that reaches the key surfaces but is never lowering-read and is not on the observability strip-list fragments every cache; declare intent with a `lowering-relevant(...)` or `key-exempt(...)` pragma on the declaration line |
| key-surface-drift | the strip-list is ONE registry (common.OBSERVABILITY_FIELDS): partial strips, non-conforming strip helpers, hardcoded membership tuples, un-stripped memoised fronts, contradictory pragmas and operand-as-static branches drift a key surface |

The JAX package's six JAX-contract rules (`host-callback`, `np-in-jit`,
`implicit-dtype`, `scalar-promotion`, `weak-literal`, `donated-reuse`)
read `jax` / `jnp` call shapes that the port has none of; ROADMAP.md
(Queue 1, the analysis map) records what stands in for each.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterator, Optional

from megba_tpu_torch.analysis import concurrency
from megba_tpu_torch.analysis.callgraph import (
    ModuleInfo,
    PackageIndex,
    _dotted,
)

ALL_RULES = (
    "raw-clock",
    "guarded-by",
    "lock-order",
    "blocking-under-lock",
    "stale-program",
    "cache-split",
    "key-surface-drift",
)

# Fully-resolved call targets the raw-clock rule bans (time.monotonic,
# time.sleep etc. stay legal — only the two reads that masquerade as
# each other are fenced into the clock homes).
_RAW_CLOCK_TARGETS = {"time.time", "time.perf_counter"}

# Modules on the STRICT clock lane: deadline arithmetic here rides
# `utils.timing.monotonic_s` exclusively, so even `time.monotonic()` is
# banned.
_STRICT_CLOCK_MODULES = ("serving.transport", "robustness.netfaults")
_STRICT_CLOCK_TARGETS = _RAW_CLOCK_TARGETS | {"time.monotonic"}


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def _alias_target(mod: ModuleInfo, dotted: Optional[str]) -> Optional[str]:
    """Resolve the head alias of a dotted chain through the module's
    imports: "np.zeros" -> "numpy.zeros"."""
    if dotted is None:
        return None
    head, *rest = dotted.split(".")
    target = mod.imports.get(head, head)
    return ".".join([target] + rest)


def _is_clock_home(mod: ModuleInfo) -> bool:
    parts = mod.name.split(".")
    return "observability" in parts or mod.name.endswith("utils.timing")


def rule_raw_clock(index: PackageIndex) -> Iterator[Finding]:
    for mod in index.modules.values():
        if _is_clock_home(mod):
            continue
        strict = mod.name.endswith(_STRICT_CLOCK_MODULES)
        targets = _STRICT_CLOCK_TARGETS if strict else _RAW_CLOCK_TARGETS
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            full = _alias_target(mod, dotted)
            if full in targets:
                helper = ("wall_unix()" if full == "time.time"
                          else "monotonic_s()")
                if strict and full == "time.monotonic":
                    yield Finding(
                        mod.path, node.lineno, node.col_offset,
                        "raw-clock",
                        f"raw `{dotted}()` in a strict-clock module "
                        "(transport/netfaults deadline arithmetic): use "
                        "megba_tpu_torch.utils.timing.monotonic_s() — a "
                        "second monotonic epoch here would be compared "
                        "against monotonic_s() deadlines")
                else:
                    yield Finding(
                        mod.path, node.lineno, node.col_offset,
                        "raw-clock",
                        f"raw `{dotted}()` outside the clock homes "
                        "(utils/timing.py, observability/): use "
                        f"megba_tpu_torch.utils.timing.{helper} so "
                        "durations and epoch stamps flow from one seam")


# ------------------------------------------------ concurrency rules
# The analysis lives in analysis/concurrency.py (it yields plain
# (path, line, col, message) tuples so it never needs this module);
# these wrappers stamp the rule ids.


def rule_guarded_by(index: PackageIndex) -> Iterator[Finding]:
    for path, line, col, msg in concurrency.find_guarded_by(index):
        yield Finding(path, line, col, "guarded-by", msg)


def rule_lock_order(index: PackageIndex) -> Iterator[Finding]:
    for path, line, col, msg in concurrency.find_lock_order(index):
        yield Finding(path, line, col, "lock-order", msg)


def rule_blocking_under_lock(index: PackageIndex) -> Iterator[Finding]:
    for path, line, col, msg in concurrency.find_blocking_under_lock(index):
        yield Finding(path, line, col, "blocking-under-lock", msg)


# -------------------------------------------- program-identity rules
# The analysis lives in analysis/identity.py (same contract as the
# concurrency lane); these wrappers stamp the rule ids.


def rule_stale_program(index: PackageIndex) -> Iterator[Finding]:
    from megba_tpu_torch.analysis import identity

    for path, line, col, msg in identity.find_stale_program(index):
        yield Finding(path, line, col, "stale-program", msg)


def rule_cache_split(index: PackageIndex) -> Iterator[Finding]:
    from megba_tpu_torch.analysis import identity

    for path, line, col, msg in identity.find_cache_split(index):
        yield Finding(path, line, col, "cache-split", msg)


def rule_key_surface_drift(index: PackageIndex) -> Iterator[Finding]:
    from megba_tpu_torch.analysis import identity

    for path, line, col, msg in identity.find_key_surface_drift(index):
        yield Finding(path, line, col, "key-surface-drift", msg)


RULES = {
    "raw-clock": rule_raw_clock,
    "guarded-by": rule_guarded_by,
    "lock-order": rule_lock_order,
    "blocking-under-lock": rule_blocking_under_lock,
    "stale-program": rule_stale_program,
    "cache-split": rule_cache_split,
    "key-surface-drift": rule_key_surface_drift,
}

"""Program-identity contract analysis (lint lane 7) of the port.

Counterpart of `megba_tpu/analysis/identity.py`.  The port compiles no
program, but it keys the same surfaces: `serving/artifacts.py`'s
fingerprints, the `compile_pool` manifests (`option_fingerprint`,
`option_config`) and bucket keys (`pool_key`), and the host plan
caches.  Its lowering entries are `flat_solve`, `distributed_lm_solve`,
`solve_pgo`, the serving front `batched_solve_program` and the
lane-batched bucket program `lane_lm_solve`; JAX's `lower_bucket` (the
auditor's AOT lowering) was left out of the port on purpose and is not
an entry here.

Every serving-tier correctness story hangs on key discipline: the
retrace sentinel's `static_key`, the artifact store's
`option_fingerprint`, the warm-manifest `option_config`, and the
compile-pool bucket keys must all agree on which option fields change
the lowered program.  `static_key` reprs the frozen option dataclasses
WHOLE, so the failure modes are exactly two:

- a field the lowering path READS but some surface strips (or a
  builder's key omits the option entirely) serves a *wrong program*
  on a cache hit — the `stale-program` rule;
- a field NO lowering path reads, that is not on the observability
  strip-list, reaches every key anyway and silently *fragments* the
  compile cache, artifact store and warm manifests — the `cache-split`
  rule;
- and the strip-list itself is a contract: every strip site, exclusion
  list and cache front must derive from the ONE extracted registry
  (`OBSERVABILITY_FIELDS`), and operand-declared values must never be
  branched on inside traced code — the `key-surface-drift` rule.

Pure standard library (ast) over the callgraph index
(analysis/callgraph.py), in the concurrency lane's mold: this module
never imports or executes the code under analysis.  Everything is
name-convention driven — option classes are recognised by class NAME
(ProblemOption / SolverOption / AlgoOption / RobustOption), lowering
entry points by function name (flat_solve, batched_solve_program,
lane_lm_solve, solve_pgo, distributed_lm_solve) or an inline
`# megba: lowering-entry` pragma, and strip helpers by name
(strip_observability / _sans_telemetry / _strip_telemetry) — so the
seeded fixtures under tests/data/lint_fixtures/ exercise every rule
without importing the package.

The option-field read set is computed from the callgraph's
per-function attribute-read pass (`FunctionInfo.attr_reads`), resolved
against named parameters through each function's lexical scope chain:
a nested closure reading `solver_opt.tol` where the enclosing function
assigned `solver_opt = option.solver_option` attributes the read to
`solver_option.tol` on the enclosing `option` parameter.  Parameter
types come from annotations first, then the repo's naming conventions
(`option`/`opt` -> ProblemOption, `solver_opt[ion]` -> SolverOption,
...).  Resolution is conservative: an unresolvable read is ignored
(never guessed), which can only make `cache-split` fire — and a false
fire is answered with one of the two declared-intent pragmas, each a
visible, greppable statement of why a field is keyed.

Declared-intent escape hatches (field-scoped pragmas, parsed with a
dedicated regex because the parenthesised form stops the generic
pragma tokenizer):

- a `lowering-relevant` pragma on a field declaration asserts the
  field selects a program family even though no lowering code branches
  on it today (e.g. validated-to-one-value kind selectors, the backend
  `device` knob);
- a `key-exempt` pragma asserts a field is truly host-only and keying
  it would only fragment caches (derived shape hints).  A key-exempt
  field READ on the lowering path is a contradiction and fires
  `stale-program`.

Per-line suppression composes as everywhere else:
`# megba: allow-stale-program` / `allow-cache-split` /
`allow-key-surface-drift` on the flagged line.
"""

from __future__ import annotations

import ast
import re
from typing import (
    Dict,
    Iterator,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from megba_tpu_torch.analysis.callgraph import (
    FunctionInfo,
    ModuleInfo,
    PackageIndex,
    _dotted,
    pragmas_on_line,
)

# ---------------------------------------------------------------- names

OPTION_CLASS_NAMES = ("ProblemOption", "SolverOption", "AlgoOption",
                      "RobustOption")
ROOT_OPTION_CLASS = "ProblemOption"

# Canonical ProblemOption container-field spelling per sub-option
# class, used when a class is analysed without a ProblemOption that
# references it (fixtures), or to rescue alias reads.
_CLASS_PREFIX = {
    "SolverOption": "solver_option",
    "AlgoOption": "algo_option",
    "RobustOption": "robust_option",
}

# Parameter-name conventions (annotation wins when present).
PARAM_NAME_TYPES = {
    "option": "ProblemOption",
    "opt": "ProblemOption",
    "problem_option": "ProblemOption",
    "base_option": "ProblemOption",
    "report_option": "ProblemOption",
    "solve_option": "ProblemOption",
    "compare_option": "ProblemOption",
    "solver_option": "SolverOption",
    "solver_opt": "SolverOption",
    "algo_option": "AlgoOption",
    "algo_opt": "AlgoOption",
    "robust_option": "RobustOption",
    "robust_opt": "RobustOption",
}

# The lowering entry points: flat_solve's paths (one device and the
# meshes all go through flat_solve / distributed_lm_solve), the serving
# batched front and the lane-batched bucket program, and the PGO driver.
LOWERING_ENTRY_NAMES = frozenset({
    "flat_solve",
    "distributed_lm_solve",
    "batched_solve_program",
    "lane_lm_solve",
    "solve_pgo",
})

# Canonical strip helpers: a function with one of these names (or one
# that references one) is a declared observability-strip site.
STRIP_HELPER_NAMES = frozenset({
    "strip_observability",
    "_sans_telemetry",
    "_strip_telemetry",
})

# The one extracted strip registry (common.OBSERVABILITY_FIELDS).
REGISTRY_NAME = "OBSERVABILITY_FIELDS"

# Key-constructor call tails: a static program/artifact key surface.
KEY_FN_TAILS = frozenset({"static_key"})

# Operand-declared values (runtime data fed into traced programs as
# arguments).  Branching on one in Python inside traced code bakes the
# traced value static (operand-as-static); only `is None` presence
# checks are sanctioned.
OPERAND_NAMES = frozenset({
    "edge_mask",
    "mask",
    "sqrt_info",
    "cam_fixed",
    "pt_fixed",
    "initial_region",
    "init_region",
    "initial_v",
    "init_v",
    "initial_dx",
    "fault_plan",
    "verbose_token",
})

# Field-scoped pragmas need their own regexes: the parenthesised form
# stops callgraph.PRAGMA_RE at the "(" (same situation as the
# concurrency lane's guarded-by pragma).
_MEGBA_COMMENT_RE = re.compile(r"#\s*megba:(.*)$")
_LOWERING_RELEVANT_RE = re.compile(r"lowering-relevant\(\s*([\w.]+)\s*\)")
_KEY_EXEMPT_RE = re.compile(r"key-exempt\(\s*([\w.]+)\s*\)")


# ------------------------------------------------------------- helpers

def _short(qualname: str) -> str:
    return ".".join(qualname.rsplit(".", 2)[-2:])


def _own_nodes(info: FunctionInfo) -> Iterator[ast.AST]:
    """Every node in `info`'s own body, skipping nested defs (they are
    indexed functions of their own and analysed separately)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(info.node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _is_cleared_const(node: ast.AST) -> bool:
    """A "cleared" strip value: None / False / 0 / "" literal."""
    return (isinstance(node, ast.Constant)
            and (node.value is None or node.value is False
                 or node.value == 0 or node.value == ""))


def _annotation_class(node: Optional[ast.AST]) -> Optional[str]:
    """Option class named by an annotation (handles Optional[...] and
    string annotations); None when it names no option class."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        tail = node.value.split(".")[-1].strip("'\" ")
        return tail if tail in OPTION_CLASS_NAMES else None
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in OPTION_CLASS_NAMES:
            return sub.id
        if (isinstance(sub, ast.Attribute)
                and sub.attr in OPTION_CLASS_NAMES):
            return sub.attr
    return None


def _param_names(node: ast.AST) -> List[ast.arg]:
    args = node.args
    return list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)


# ------------------------------------------------------------ registry

class _Registry:
    """The extracted program-identity field registry: option classes,
    their leaf fields (dotted from ProblemOption), the observability
    strip-list, and the declared-intent pragmas."""

    def __init__(self) -> None:
        # class name -> {field name -> sub-option class} (containers)
        self.containers: Dict[str, Dict[str, str]] = {}
        # class name -> {field name -> (path, lineno)} (leaves)
        self.leaves: Dict[str, Dict[str, Tuple[str, int]]] = {}
        self.defined: Set[str] = set()
        # dotted-from-ProblemOption leaf path -> (path, lineno)
        self.leaf_paths: Dict[str, Tuple[str, int]] = {}
        self.strip_fields: Tuple[str, ...] = ()
        # pragma kind -> {field path}
        self.pragmas: Dict[str, Set[str]] = {
            "lowering-relevant": set(), "key-exempt": set()}
        # (kind, field, path, lineno) for reporting
        self.pragma_sites: List[Tuple[str, str, str, int]] = []

    def prefix_for(self, classname: str) -> str:
        """Dotted-path prefix for fields of `classname` ("" for the
        root class, "solver_option." for SolverOption, ...)."""
        if classname == ROOT_OPTION_CLASS:
            return ""
        for field, cls in self.containers.get(
                ROOT_OPTION_CLASS, {}).items():
            if cls == classname:
                return field + "."
        fallback = _CLASS_PREFIX.get(classname)
        return fallback + "." if fallback else classname + "."


def _extract_registry(index: PackageIndex) -> _Registry:
    reg = _Registry()
    # -- option class declarations (prefer the ProblemOption module on
    # duplicate definitions, so a vendored copy cannot shadow the
    # canonical one when both are under the linted paths).
    defs: Dict[str, Tuple[ModuleInfo, ast.ClassDef]] = {}
    root_mod: Optional[str] = None
    for modname in sorted(index.modules):
        mod = index.modules[modname]
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.ClassDef)
                    and node.name in OPTION_CLASS_NAMES):
                if node.name == ROOT_OPTION_CLASS and root_mod is None:
                    root_mod = modname
                if node.name not in defs:
                    defs[node.name] = (mod, node)
    if root_mod is not None:
        mod = index.modules[root_mod]
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.ClassDef)
                    and node.name in OPTION_CLASS_NAMES):
                defs[node.name] = (mod, node)

    for classname, (mod, node) in defs.items():
        reg.defined.add(classname)
        reg.containers.setdefault(classname, {})
        reg.leaves.setdefault(classname, {})
        for stmt in node.body:
            if not (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                continue
            field = stmt.target.id
            sub = _annotation_class(stmt.annotation)
            if sub is not None and sub != classname:
                reg.containers[classname][field] = sub
            else:
                reg.leaves[classname][field] = (mod.path, stmt.lineno)

    # -- dotted leaf paths (one container level, the repo's shape)
    for field, loc in reg.leaves.get(ROOT_OPTION_CLASS, {}).items():
        reg.leaf_paths[field] = loc
    for cfield, cls in reg.containers.get(ROOT_OPTION_CLASS, {}).items():
        for field, loc in reg.leaves.get(cls, {}).items():
            reg.leaf_paths[f"{cfield}.{field}"] = loc
    # Sub-option classes analysed without a referencing ProblemOption
    # (single-file fixtures) still contribute under their canonical
    # prefix.
    referenced = set(reg.containers.get(ROOT_OPTION_CLASS, {}).values())
    for cls in reg.defined - {ROOT_OPTION_CLASS} - referenced:
        prefix = reg.prefix_for(cls)
        for field, loc in reg.leaves.get(cls, {}).items():
            reg.leaf_paths.setdefault(prefix + field, loc)

    # -- the strip-list: the module-level OBSERVABILITY_FIELDS tuple
    # (ProblemOption's module wins), falling back to the union of
    # cleared kwargs in the declared strip helpers.
    candidates: List[Tuple[str, Tuple[str, ...]]] = []
    for modname in sorted(index.modules):
        mod = index.modules[modname]
        for stmt in mod.tree.body:
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == REGISTRY_NAME
                    and isinstance(stmt.value, (ast.Tuple, ast.List))):
                names = tuple(
                    e.value for e in stmt.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str))
                if names:
                    candidates.append((modname, names))
    for modname, names in candidates:
        if modname == root_mod:
            reg.strip_fields = names
            break
    else:
        if candidates:
            reg.strip_fields = candidates[0][1]
    if not reg.strip_fields:
        cleared: Set[str] = set()
        for info in index.functions.values():
            if info.qualname.rsplit(".", 1)[-1] in STRIP_HELPER_NAMES:
                for _line, fields in _strip_replaces(info):
                    cleared |= fields
        reg.strip_fields = tuple(sorted(cleared))

    # -- declared-intent pragmas, anywhere under the linted paths
    for mod in index.modules.values():
        for lineno, line in enumerate(mod.source_lines, start=1):
            m = _MEGBA_COMMENT_RE.search(line)
            if not m:
                continue
            tail = m.group(1)
            for rx, kind in ((_LOWERING_RELEVANT_RE, "lowering-relevant"),
                             (_KEY_EXEMPT_RE, "key-exempt")):
                for pm in rx.finditer(tail):
                    reg.pragmas[kind].add(pm.group(1))
                    reg.pragma_sites.append(
                        (kind, pm.group(1), mod.path, lineno))
    return reg


def _strip_replaces(info: FunctionInfo) -> List[Tuple[int, Set[str]]]:
    """(lineno, {cleared field names}) for every `replace(...)` call in
    `info`'s own body that clears at least one keyword to a cleared
    constant (None/False/0/"")."""
    out: List[Tuple[int, Set[str]]] = []
    for node in _own_nodes(info):
        if not isinstance(node, ast.Call):
            continue
        callee = _dotted(node.func)
        if callee is None or callee.split(".")[-1] != "replace":
            continue
        cleared = {kw.arg for kw in node.keywords
                   if kw.arg is not None and _is_cleared_const(kw.value)}
        if cleared:
            out.append((node.lineno, cleared))
    return out


# ------------------------------------------------------------ analyzer

class _Analyzer:
    """One shared pass per PackageIndex (memoised on the index): the
    registry, the lowering-closure, the resolved option-field read set,
    and the key/cache surfaces the three rules consume."""

    def __init__(self, index: PackageIndex) -> None:
        self.index = index
        self.reg = _extract_registry(index)
        # module-qualified cache-alias name -> builder function qualname
        # (`_cached_x = lru_cache(...)(_build_x)` module assigns).
        self.cache_aliases: Dict[str, str] = {}
        self._collect_cache_aliases()
        self.entries: List[str] = self._find_entries()
        self.closure: Set[str] = self._closure()
        # dotted leaf path -> sorted qualnames of closure readers
        self.reads: Dict[str, List[str]] = {}
        self._collect_reads()

    # -- cache fronts ------------------------------------------------
    def _collect_cache_aliases(self) -> None:
        for mod in self.index.modules.values():
            for stmt in mod.tree.body:
                if not (isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                        and isinstance(stmt.value, ast.Call)):
                    continue
                if not self._is_cache_wrapper(stmt.value):
                    continue
                builder = None
                for sub in ast.walk(stmt.value):
                    if isinstance(sub, (ast.Name, ast.Attribute)):
                        q = self.index.resolve(mod, None, sub)
                        if q is not None:
                            builder = q
                            break
                if builder is not None:
                    alias = f"{mod.name}.{stmt.targets[0].id}"
                    self.cache_aliases[alias] = builder

    @staticmethod
    def _is_cache_wrapper(call: ast.Call) -> bool:
        """`lru_cache(...)(fn)` / `normalized_lru_cache(...)(fn)` shape:
        the callee is itself a call whose name tail mentions cache."""
        fn = call.func
        if isinstance(fn, ast.Call):
            inner = _dotted(fn.func)
            return inner is not None and "cache" in inner.split(".")[-1]
        dotted = _dotted(fn)
        return dotted is not None and "cache" in dotted.split(".")[-1]

    def _cache_refs(self, info: FunctionInfo) -> List[str]:
        """Memoised-program references in `info`'s own body: cache
        aliases it names, plus refs to cache-DECORATED functions."""
        mod = self.index.modules[info.module]
        out: List[str] = []
        for node in _own_nodes(info):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                alias = f"{mod.name}.{node.id}"
                target = self.cache_aliases.get(
                    alias) or self.cache_aliases.get(
                        mod.imports.get(node.id, ""))
                if target is not None:
                    out.append(target)
        for q in info.refs:
            ref = self.index.functions.get(q)
            if ref is not None and _is_cache_decorated(ref.node):
                out.append(q)
        return out

    # -- closure -----------------------------------------------------
    def _find_entries(self) -> List[str]:
        out = []
        for q, info in self.index.functions.items():
            simple = q.rsplit(".", 1)[-1]
            mod = self.index.modules[info.module]
            if simple in LOWERING_ENTRY_NAMES or "lowering-entry" in (
                    pragmas_on_line(mod.source_lines, info.node.lineno)):
                out.append(q)
        return sorted(out)

    def _closure(self) -> Set[str]:
        seen = set(self.entries)
        frontier = list(self.entries)
        while frontier:
            q = frontier.pop()
            info = self.index.functions[q]
            nxt = (list(info.refs) + list(info.children)
                   + self._cache_refs(info))
            for n in nxt:
                if n in self.index.functions and n not in seen:
                    seen.add(n)
                    frontier.append(n)
        return seen

    # -- read resolution ---------------------------------------------
    def _scope_chain(self, info: FunctionInfo) -> List[FunctionInfo]:
        chain = [info]
        cur = info
        while cur.parent is not None:
            cur = self.index.functions.get(cur.parent)
            if cur is None:
                break
            chain.append(cur)
        return chain

    def param_types(self, info: FunctionInfo) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for a in _param_names(info.node):
            cls = _annotation_class(a.annotation)
            if cls is None:
                cls = PARAM_NAME_TYPES.get(a.arg)
            if cls is not None and cls in self.reg.defined:
                out[a.arg] = cls
        return out

    def root_type(self, info: FunctionInfo, root: str,
                  _depth: int = 0) -> Optional[str]:
        """Option class of `root` in `info`'s scope chain: own params
        and aliases first, then each enclosing function's (closure
        capture)."""
        if _depth > 8:
            return None
        for scope in self._scope_chain(info):
            ptypes = self.param_types(scope)
            if root in ptypes:
                return ptypes[root]
            if root in scope.assigns:
                val = scope.assigns[root]
                vroot, _, vchain = val.partition(".")
                if vroot == root and not vchain:
                    return None
                base = self.root_type(scope, vroot, _depth + 1)
                if base is None:
                    return None
                return self._walk_containers(base, vchain)
        return None

    def _walk_containers(self, cls: str, chain: str) -> Optional[str]:
        if not chain:
            return cls
        for comp in chain.split("."):
            nxt = self.reg.containers.get(cls, {}).get(comp)
            if nxt is None:
                return None
            cls = nxt
        return cls

    def resolve_read(self, info: FunctionInfo, root: str,
                     chain: str) -> Optional[str]:
        """Dotted-from-ProblemOption leaf path of the attribute read
        `root.chain` in `info`, or None when it is not an option-field
        read (unknown root, method access, off-registry attribute)."""
        if not chain:
            return None
        cls = self.root_type(info, root)
        if cls is None:
            return None
        consumed: List[str] = []
        for comp in chain.split("."):
            sub = self.reg.containers.get(cls, {}).get(comp)
            if sub is not None:
                consumed.append(comp)
                cls = sub
                continue
            if comp in self.reg.leaves.get(cls, {}):
                # Path rooted at the read's OWN class, then prefixed
                # back to ProblemOption.
                start = self.root_type(info, root)
                return (self.reg.prefix_for(start)
                        + ".".join(consumed + [comp]))
            return None
        return None  # pure container access, no leaf touched

    def _collect_reads(self) -> None:
        for q in sorted(self.closure):
            info = self.index.functions[q]
            for root, chains in info.attr_reads.items():
                for chain in chains:
                    path = self.resolve_read(info, root, chain)
                    if path is not None:
                        self.reads.setdefault(path, []).append(q)
        for readers in self.reads.values():
            readers.sort()

    # -- located lookups (only used when emitting findings) ----------
    def locate_reads(self, info: FunctionInfo,
                     leaf: str) -> List[Tuple[int, int]]:
        """(line, col) of every outermost attribute read in `info`'s
        own body whose chain ends in `leaf` and resolves to an option
        field ending in `leaf`."""
        out = []
        for node in _own_nodes(info):
            if not (isinstance(node, ast.Attribute)
                    and isinstance(node.ctx, ast.Load)):
                continue
            dotted = _dotted(node)
            if dotted is None or dotted.split(".")[-1] != leaf:
                continue
            root, _, chain = dotted.partition(".")
            path = self.resolve_read(info, root, chain)
            if path is not None and path.split(".")[-1] == leaf:
                out.append((node.lineno, node.col_offset))
        return sorted(set(out))

    # -- strip discipline --------------------------------------------
    def is_strip_helper(self, info: FunctionInfo) -> bool:
        return info.qualname.rsplit(".", 1)[-1] in STRIP_HELPER_NAMES

    def references_strip_helper(self, info: FunctionInfo) -> bool:
        for node in _own_nodes(info):
            if (isinstance(node, ast.Name)
                    and isinstance(node.ctx, ast.Load)
                    and node.id in STRIP_HELPER_NAMES):
                return True
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.ctx, ast.Load)
                    and node.attr in STRIP_HELPER_NAMES):
                return True
        return False

    def strips_fully(self, info: FunctionInfo) -> bool:
        """`info` clears the whole strip-list itself, or routes through
        a declared strip helper."""
        if self.is_strip_helper(info) or self.references_strip_helper(info):
            return True
        strip = set(self.reg.strip_fields)
        return any(strip <= cleared
                   for _line, cleared in _strip_replaces(info))

    def strip_exempt_fields(self, info: FunctionInfo) -> Set[str]:
        """Strip-listed fields `info` may legitimately READ: the
        consume-and-strip shape (resolve the sink, then clear it in the
        same function, inline or via a helper)."""
        if self.is_strip_helper(info) or self.references_strip_helper(info):
            return set(self.reg.strip_fields)
        out: Set[str] = set()
        for _line, cleared in _strip_replaces(info):
            out |= cleared & set(self.reg.strip_fields)
        return out


def _is_cache_decorated(node: ast.AST) -> bool:
    for dec in getattr(node, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        dotted = _dotted(target)
        if dotted is not None and "cache" in dotted.split(".")[-1]:
            return True
    return False


def _analyzer(index: PackageIndex) -> _Analyzer:
    cached = getattr(index, "_megba_identity", None)
    if cached is None:
        cached = _Analyzer(index)
        index._megba_identity = cached  # type: ignore[attr-defined]
    return cached


# ------------------------------------------------------- rule: stale

def find_stale_program(
        index: PackageIndex) -> Iterator[Tuple[str, int, int, str]]:
    """Wrong-program hazards.

    (a) a strip-listed (or key-exempt-declared) field READ by a
        function on the lowering closure that does not itself strip it
        — the compiled program depends on a knob every cache key has
        had cleared, so a sink/flag flip silently serves a stale
        program;
    (b) a closure function with an option parameter that builds a
        `static_key(...)` WITHOUT the option — every option field is
        invisible to that program's identity.
    """
    a = _analyzer(index)
    if not a.reg.leaf_paths:
        return
    hidden = set(a.reg.strip_fields) | {
        p for p in a.reg.pragmas["key-exempt"]}
    for q in sorted(a.closure):
        info = index.functions[q]
        mod = index.modules[info.module]
        exempt = a.strip_exempt_fields(info)
        # (a) hidden-field reads
        for root, chains in sorted(info.attr_reads.items()):
            for chain in sorted(chains):
                path = a.resolve_read(info, root, chain)
                if path is None or path not in hidden or path in exempt:
                    continue
                leaf = path.split(".")[-1]
                locs = a.locate_reads(info, leaf) or [
                    (info.node.lineno, info.node.col_offset)]
                what = ("is on the observability strip-list"
                        if path in a.reg.strip_fields
                        else "is declared key-exempt")
                for line, col in locs:
                    yield (mod.path, line, col,
                           f"option field `{path}` is read on the "
                           f"lowering path ({_short(q)}) but {what} — "
                           "the compiled program depends on a knob its "
                           "cache keys never see (wrong-program "
                           "hazard); key the field, or consume it and "
                           "strip it in this same function")
    # (b) static keys that omit the option
    for q, info in sorted(index.functions.items()):
        in_scope: Dict[str, str] = {}
        for scope in a._scope_chain(info):
            for name, cls in a.param_types(scope).items():
                in_scope.setdefault(name, cls)
        option_params = {n for n, c in in_scope.items()
                         if c == ROOT_OPTION_CLASS}
        if not option_params:
            continue
        mod = index.modules[info.module]
        # Option taint: a local assigned from ANY expression containing
        # an option parameter (e.g. `compare_option =
        # _sans_telemetry(option)`) carries the option into the key.
        tainted = set(option_params)
        for _ in range(3):  # tiny fixpoint; chains are short
            grew = False
            for node in _own_nodes(info):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    continue
                if any(isinstance(sub, ast.Name) and sub.id in tainted
                       for sub in ast.walk(node.value)):
                    if node.targets[0].id not in tainted:
                        tainted.add(node.targets[0].id)
                        grew = True
            if not grew:
                break
        for node in _own_nodes(info):
            if not isinstance(node, ast.Call):
                continue
            callee = _dotted(node.func)
            if callee is None or callee.split(".")[-1] not in KEY_FN_TAILS:
                continue
            arg_names: Set[str] = set()
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Name):
                        arg_names.add(sub.id)
            if tainted & arg_names:
                continue
            yield (mod.path, node.lineno, node.col_offset,
                   f"{_short(q)} builds a static key that omits its "
                   f"option parameter "
                   f"`{sorted(option_params)[0]}` — every option field "
                   "is invisible to this program's identity "
                   "(wrong-program hazard); pass the (stripped) option "
                   "into the key")


# -------------------------------------------------- rule: cache-split

def find_cache_split(
        index: PackageIndex) -> Iterator[Tuple[str, int, int, str]]:
    """Fields that fragment every key surface for nothing: present in
    the option dataclasses (and therefore in every `static_key` repr,
    artifact fingerprint, manifest config and bucket key), never read
    on the lowering closure, not on the observability strip-list, and
    carrying no declared-intent pragma."""
    a = _analyzer(index)
    strip = set(a.reg.strip_fields)
    declared = (a.reg.pragmas["lowering-relevant"]
                | a.reg.pragmas["key-exempt"])
    for path in sorted(a.reg.leaf_paths):
        if path in strip or path.split(".")[-1] in strip:
            continue
        if path in declared:
            continue
        if path in a.reads:
            continue
        fpath, lineno = a.reg.leaf_paths[path]
        yield (fpath, lineno, 0,
               f"option field `{path}` reaches every key surface "
               "(static_key reprs the whole option; artifact "
               "fingerprints, warm manifests and bucket keys follow) "
               "but is never read on the lowering path — it silently "
               "fragments the compile cache, artifact store and warm "
               "manifests; declare it lowering-relevant(...) if it "
               "selects a program family, key-exempt(...) if it is "
               "host-only, or add it to the observability strip-list")


# -------------------------------------------- rule: key-surface-drift

def find_key_surface_drift(
        index: PackageIndex) -> Iterator[Tuple[str, int, int, str]]:
    """The strip-list is one registry and every surface must derive
    from it.

    (a) partial strips: a `replace(...)` clearing a non-empty PROPER
        subset of the strip-list (the un-cleared knob fragments that
        surface's keys);
    (b) a declared strip helper that neither clears the full list nor
        routes through another helper;
    (c) hardcoded membership tuples that overlap the strip-list but
        disagree with it (the manifest-comparison exclusion bug
        class);
    (d) a function with an option parameter fronting a memoised
        program cache without stripping first (the un-stripped public
        cache-front bug class);
    (e) a field carrying BOTH declared-intent pragmas, or a pragma
        naming a field the registry does not define;
    (f) operand-declared values branched on in Python inside traced
        code (operand-as-static) — `is None` presence checks
        sanctioned.
    """
    a = _analyzer(index)
    strip = set(a.reg.strip_fields)

    if strip:
        for q, info in sorted(index.functions.items()):
            mod = index.modules[info.module]
            is_helper = a.is_strip_helper(info)
            conforming = False
            for lineno, cleared in _strip_replaces(info):
                inter = cleared & strip
                if not inter:
                    continue
                if strip <= cleared:
                    conforming = True
                    continue
                missing = sorted(strip - cleared)
                yield (mod.path, lineno, 0,
                       f"partial observability strip in {_short(q)}: "
                       f"clears {sorted(inter)} but the declared "
                       f"strip-list is {sorted(strip)} — the "
                       f"un-cleared {missing} still fragments this "
                       "key surface; route through the canonical "
                       "strip helper")
            # (b) helper conformance
            if (is_helper and not conforming
                    and not a.references_strip_helper(info)):
                yield (mod.path, info.node.lineno, info.node.col_offset,
                       f"strip helper {_short(q)} clears neither the "
                       f"full strip-list {sorted(strip)} nor routes "
                       "through another declared helper — surfaces "
                       "keyed through it drift from the registry")

        # (c) hardcoded exclusion tuples
        for q, info in sorted(index.functions.items()):
            mod = index.modules[info.module]
            for node in _own_nodes(info):
                if not (isinstance(node, ast.Compare)
                        and len(node.ops) == 1
                        and isinstance(node.ops[0], (ast.In, ast.NotIn))
                        and isinstance(node.comparators[0],
                                       (ast.Tuple, ast.List, ast.Set))):
                    continue
                consts = {e.value for e in node.comparators[0].elts
                          if isinstance(e, ast.Constant)
                          and isinstance(e.value, str)}
                if not consts or not (consts & strip):
                    continue
                if consts == strip:
                    continue
                yield (mod.path, node.lineno, node.col_offset,
                       f"hardcoded key-exclusion {sorted(consts)} in "
                       f"{_short(q)} drifts from the observability "
                       f"registry {sorted(strip)} — derive the "
                       f"membership test from {REGISTRY_NAME} so the "
                       "comparison surface cannot disagree with the "
                       "strip sites")

        # (d) un-stripped cache fronts
        for q in sorted(a.closure):
            info = index.functions[q]
            if a.is_strip_helper(info):
                continue
            if ROOT_OPTION_CLASS not in a.param_types(info).values():
                continue
            fronts = a._cache_refs(info)
            if not fronts or a.strips_fully(info):
                continue
            mod = index.modules[info.module]
            yield (mod.path, info.node.lineno, info.node.col_offset,
                   f"{_short(q)} fronts the memoised program cache "
                   f"({_short(sorted(fronts)[0])}) with an un-stripped "
                   "option — a telemetry/metrics-armed option splits "
                   "the compile cache and warm keys per sink value; "
                   "strip the observability fields before the cache "
                   "lookup")

    # (e) pragma hygiene
    both = (a.reg.pragmas["lowering-relevant"]
            & a.reg.pragmas["key-exempt"])
    known = set(a.reg.leaf_paths)
    for kind, field, path, lineno in sorted(a.reg.pragma_sites):
        if field in both and kind == "key-exempt":
            yield (path, lineno, 0,
                   f"option field `{field}` carries BOTH "
                   "lowering-relevant and key-exempt pragmas — the "
                   "declarations contradict; a field either shapes "
                   "the program or it does not")
        if known and field not in known:
            yield (path, lineno, 0,
                   f"identity pragma names `{field}`, which is not a "
                   "declared option field — a renamed or removed "
                   "field must take its pragma with it")

    # (f) operand-as-static branches in traced code
    for q in sorted(index.reachable):
        info = index.functions.get(q)
        if info is None:
            continue
        mod = index.modules[info.module]
        operand_params: Set[str] = set()
        for scope in a._scope_chain(info):
            operand_params |= {p.arg for p in _param_names(scope.node)
                               if p.arg in OPERAND_NAMES}
        if not operand_params:
            continue
        seen: Set[Tuple[str, int]] = set()
        for node in _own_nodes(info):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                for name, lineno, col in _unsanctioned_operands(
                        node.test, operand_params):
                    if (name, lineno) in seen:
                        continue
                    seen.add((name, lineno))
                    yield (mod.path, lineno, col,
                           f"operand `{name}` appears in a "
                           f"Python-level branch inside traced code "
                           f"({_short(q)}) — a branch on a traced "
                           "value bakes it static "
                           "(operand-as-static); only `is None` "
                           "presence checks are host decisions, use "
                           "lax.cond/jnp.where for value branches")


def _unsanctioned_operands(
        test: ast.AST,
        operand_params: Set[str]) -> List[Tuple[str, int, int]]:
    """Operand-name loads inside a branch test that are NOT of the
    sanctioned `x is None` / `x is not None` presence-check shape."""
    sanctioned: Set[int] = set()
    for node in ast.walk(test):
        if (isinstance(node, ast.Compare) and len(node.ops) == 1
                and isinstance(node.ops[0], (ast.Is, ast.IsNot))
                and isinstance(node.comparators[0], ast.Constant)
                and node.comparators[0].value is None):
            for sub in ast.walk(node.left):
                if isinstance(sub, ast.Name):
                    sanctioned.add(id(sub))
    out = []
    for node in ast.walk(test):
        if (isinstance(node, ast.Name) and node.id in operand_params
                and id(node) not in sanctioned):
            out.append((node.id, node.lineno, node.col_offset))
    return out


# ----------------------------------------------------------- summary

def identity_summary(index: PackageIndex) -> Dict[str, object]:
    """Inspection hook (tests, docs): the extracted registry, entry
    points, closure size and resolved read set."""
    a = _analyzer(index)
    return {
        "entries": list(a.entries),
        "closure": sorted(a.closure),
        "strip_fields": tuple(a.reg.strip_fields),
        "leaf_paths": sorted(a.reg.leaf_paths),
        "reads": {k: list(v) for k, v in sorted(a.reads.items())},
        "pragmas": {k: sorted(v) for k, v in a.reg.pragmas.items()},
        "cache_aliases": dict(sorted(a.cache_aliases.items())),
    }

"""AST-level concurrency contract analyzer for the port's host serving
tier (`megba_tpu_torch.serving`, `parallel/multihost.py`,
`robustness/elastic.py`).

Counterpart of `megba_tpu/analysis/concurrency.py`, unchanged in its
passes.  Pure standard library (ast) over the existing PackageIndex —
nothing here imports or executes the code under analysis.  Three
passes, each a lint rule (analysis/rules.py registers them; `python -m
megba_tpu_torch.analysis.lint megba_tpu_torch` gates the package on all
three):

**guarded-by** — race detection for shared mutable attributes of
classes that own a `threading.Lock/RLock/Condition`.  A field's lock is
declared with an inline `# megba: guarded-by(<lockattr>)` pragma on its
assignment (conventionally in `__init__`), or *inferred* when at least
80% of its post-construction accesses (and at least 5 of them) happen
under one owned lock.  Any other read/write of a guarded field outside
a `with <lock>` block is a finding — for declared fields always (the
pragma IS the contract), for inferred fields only when the class is
reachable from a second thread per the `threading.Thread(target=...)`
census this pass also builds (a class whose method is a thread target,
or that spawns threads itself).  `# megba: allow-unguarded` on the
access line is the escape hatch (equivalent to `allow-guarded-by`).

**lock-order** — deadlock analysis.  The pass builds the
acquires-while-holding digraph across the whole package: nested `with`
blocks, acquisitions inside functions *called* while a lock is held
(through the callgraph, including `self.method()` edges resolved to the
defining class), and `Condition.wait` re-acquires (waiting on a
condition while holding another lock re-acquires the condition LAST —
the edge that turns an innocuous-looking wait into an inversion).  Any
cycle is a finding, reported with the witness path
(`A._a -> B._b (file:line) -> A._a (file:line)`).

**blocking-under-lock** — the classic serve-loop stall shape: a call
from a curated blocking set made while any lock is held.  The curated
set: `*.result(...)` (Future.result), `*.get()` with no positional
arguments (queue.Queue.get — dict `.get(key)` always passes the key),
`*.join()` / `*.join(<number>)` (Thread/Queue join; `sep.join(parts)`
passes a non-literal), `*.wait(...)` on anything that is not a held
Condition of the same class (Event.wait, Popen.wait — waiting on a
HELD condition releases it and is the sanctioned pattern),
socket/pipe-style `*.recv/recv_bytes/recv_into/_recv_frame(...)` (the
lockstep-RPC shape), and `time.sleep` above a 0.05 s threshold (or
with a non-constant duration — a backoff sleep under a lock stalls
every other holder).

Deliberate conservatisms (the linter never guesses): lock identities
are `self.<attr>` of the owning class (constructed locally, or named by
a `guarded-by` pragma — a declared guard counts as an owned lock even
when the object is handed in or aliased) and module-level
`NAME = threading.Lock()` globals — locks reached through another
object's attribute are otherwise invisible; subclass methods are not
checked against a base class's declarations (inheritance is not
walked); closures nested inside methods are
analyzed as separate functions with an empty held-set and their `self`
accesses are not attributed to the class; inheritance is not walked.
Private methods (leading underscore) that are only ever called from
under a lock inherit that lock as held-at-entry (fixed point over the
class's internal callgraph), so `_foo_locked()` helpers need no
annotation; a private method referenced without being called (thread
target, callback registration) escapes and is analyzed lock-free.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from megba_tpu_torch.analysis.callgraph import (
    FunctionInfo,
    ModuleInfo,
    PackageIndex,
    _dotted,
)

# `# megba: guarded-by(<lockattr>)` — parsed separately from the token
# pragmas (callgraph.PRAGMA_RE stops at the parenthesis).
_GUARDED_BY_RE = re.compile(r"#\s*megba:.*?guarded-by\(\s*(\w+)\s*\)")
# `# megba: allow-unguarded` rides the normal token-pragma syntax.
_ALLOW_UNGUARDED_RE = re.compile(r"#\s*megba:.*?\ballow-unguarded\b")

_LOCK_CTORS = {
    "threading.Lock": "Lock",
    "threading.RLock": "RLock",
    "threading.Condition": "Condition",
}

_RECV_TAILS = {"recv", "recv_bytes", "recv_into", "_recv_frame"}
_SLEEP_THRESHOLD_S = 0.05

# Fully-qualified call heads whose `.join` is path/string assembly, not
# a thread join.
_JOIN_EXEMPT_PREFIXES = ("os.path.", "posixpath.", "ntpath.")


# --------------------------------------------------------------- model


@dataclasses.dataclass
class _ClassModel:
    qualname: str  # dotted class qualname (module path included)
    module: str
    locks: Dict[str, str] = dataclasses.field(default_factory=dict)
    # lock attr -> ctor kind ("Lock" | "RLock" | "Condition")
    cond_alias: Dict[str, str] = dataclasses.field(default_factory=dict)
    # condition attr -> underlying lock attr (threading.Condition(self.X))
    declared: Dict[str, Tuple[str, int]] = dataclasses.field(
        default_factory=dict)  # field -> (lock attr, decl line)
    methods: Dict[str, str] = dataclasses.field(default_factory=dict)
    # method simple name -> function qualname
    threaded: bool = False  # census: shares state with a second thread

    def lock_id(self, attr: str) -> str:
        return f"{_short(self.qualname)}.{self.canonical(attr)}"

    def canonical(self, attr: str) -> str:
        return self.cond_alias.get(attr, attr)


@dataclasses.dataclass
class _Access:
    attr: str
    is_write: bool
    held: frozenset  # lexical held set (lock attrs of the class)
    line: int
    col: int
    in_init: bool
    method: str  # method simple name


@dataclasses.dataclass
class _Scan:
    """Per-function lexical facts, entry-held-independent."""

    accesses: List[_Access] = dataclasses.field(default_factory=list)
    # with-block acquisitions: (lock id, lexical held ids, line, col)
    acquires: List[Tuple[str, frozenset, int, int]] = dataclasses.field(
        default_factory=list)
    # resolved calls: (callee qualname, lexical held ids, line, col)
    calls: List[Tuple[str, frozenset, int, int]] = dataclasses.field(
        default_factory=list)
    # curated blocking calls: (label, lexical held ids, line, col)
    blocking: List[Tuple[str, frozenset, int, int]] = dataclasses.field(
        default_factory=list)
    # Condition.wait sites: (cond lock id, lexical held ids, line, col)
    waits: List[Tuple[str, frozenset, int, int]] = dataclasses.field(
        default_factory=list)
    # self-method names referenced WITHOUT a call (escapes: callbacks,
    # thread targets) — such methods run lock-free at entry
    escapes: Set[str] = dataclasses.field(default_factory=set)
    spawns_thread: bool = False
    # thread targets: resolved function qualnames
    thread_targets: Set[str] = dataclasses.field(default_factory=set)


def _short(qualname: str) -> str:
    """`megba_tpu.serving.queue.FleetQueue` -> `queue.FleetQueue` —
    findings stay readable without losing which module owns the lock."""
    parts = qualname.split(".")
    return ".".join(parts[-2:]) if len(parts) > 2 else qualname


def _alias_target(mod: ModuleInfo, dotted: Optional[str]) -> Optional[str]:
    if dotted is None:
        return None
    head, *rest = dotted.split(".")
    target = mod.imports.get(head, head)
    return ".".join([target] + rest)


def _self_attr(node: ast.AST) -> Optional[str]:
    """`self.X` -> "X", else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _const_number(node: ast.AST) -> Optional[float]:
    if isinstance(node, ast.Constant) and isinstance(
            node.value, (int, float)) and not isinstance(node.value, bool):
        return float(node.value)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _const_number(node.operand)
        return -inner if inner is not None else None
    return None


def _classname_of(index: PackageIndex, info: FunctionInfo) -> Optional[str]:
    """Innermost enclosing class, walking out through nested defs."""
    cur: Optional[FunctionInfo] = info
    while cur is not None:
        if cur.classname is not None:
            return cur.classname
        cur = index.functions.get(cur.parent) if cur.parent else None
    return None


# ------------------------------------------------------------ analyzer


class _Analyzer:
    """One full concurrency model per PackageIndex (memoised on it)."""

    def __init__(self, index: PackageIndex) -> None:
        self.index = index
        self.classes: Dict[str, _ClassModel] = {}
        self.module_locks: Dict[str, str] = {}  # "mod.NAME" -> lock id
        self.scans: Dict[str, _Scan] = {}
        self.entry_held: Dict[str, frozenset] = {}
        self._acq_summary: Dict[str, Dict[str, Tuple[str, int, int]]] = {}
        self._build()

    # ------------------------------------------------------------ build
    def _build(self) -> None:
        self._collect_module_locks()
        self._collect_classes()
        for qual, info in sorted(self.index.functions.items()):
            self.scans[qual] = self._scan_function(qual, info)
        self._census()
        self._solve_entry_held()

    def _collect_module_locks(self) -> None:
        for mod in self.index.modules.values():
            for stmt in mod.tree.body:
                if not (isinstance(stmt, ast.Assign)
                        and isinstance(stmt.value, ast.Call)):
                    continue
                full = _alias_target(mod, _dotted(stmt.value.func))
                if full not in _LOCK_CTORS:
                    continue
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        key = f"{mod.name}.{tgt.id}"
                        self.module_locks[key] = (
                            f"{_short(mod.name)}.{tgt.id}")

    def _collect_classes(self) -> None:
        for cls_qual, methods in self.index.classes.items():
            any_q = next(iter(methods.values()))
            modname = self.index.functions[any_q].module
            mod = self.index.modules[modname]
            cm = _ClassModel(qualname=cls_qual, module=modname)
            cm.methods = dict(methods)
            for mname, fq in sorted(methods.items()):
                fn = self.index.functions[fq].node
                for node in ast.walk(fn):
                    if isinstance(node, ast.Assign):
                        targets = node.targets
                    elif isinstance(node, ast.AnnAssign):
                        targets = [node.target]  # self.x: T = ... pragmas
                    else:
                        continue
                    for tgt in targets:
                        attr = _self_attr(tgt)
                        if attr is None:
                            continue
                        if isinstance(node.value, ast.Call):
                            full = _alias_target(
                                mod, _dotted(node.value.func))
                            kind = _LOCK_CTORS.get(full or "")
                            if kind is not None:
                                cm.locks[attr] = kind
                                if kind == "Condition" and node.value.args:
                                    inner = _self_attr(node.value.args[0])
                                    if inner is not None:
                                        cm.cond_alias[attr] = inner
                        # A multi-line assignment carries its pragma on
                        # the closing line; scan the statement's span.
                        end = getattr(node, "end_lineno", node.lineno)
                        decl = None
                        for ln in range(node.lineno,
                                        min(end, len(mod.source_lines)) + 1):
                            decl = _GUARDED_BY_RE.search(
                                mod.source_lines[ln - 1])
                            if decl is not None:
                                break
                        if decl is not None:
                            cm.declared[attr] = (decl.group(1), node.lineno)
            # A declared guard that is not locally constructed (a lock
            # handed in or aliased from another object) still IS the
            # contract: register it so `with self.<guard>` is tracked
            # and unlocked accesses of the declaring field flag.
            for _field, (lockattr, _line) in sorted(cm.declared.items()):
                cm.locks.setdefault(lockattr, "Lock")
            if cm.locks:
                self.classes[cls_qual] = cm

    # ------------------------------------------------------------- scan
    def _scan_function(self, qual: str, info: FunctionInfo) -> _Scan:
        scan = _Scan()
        mod = self.index.modules[info.module]
        cm = (self.classes.get(info.classname)
              if info.classname is not None else None)
        in_init = bool(cm is not None
                       and qual.rsplit(".", 1)[-1] == "__init__")
        method = qual.rsplit(".", 1)[-1]

        def lock_of(expr: ast.AST) -> Optional[str]:
            attr = _self_attr(expr)
            if attr is not None and cm is not None and attr in cm.locks:
                return cm.lock_id(attr)
            full = _alias_target(mod, _dotted(expr))
            if full in self.module_locks:
                return self.module_locks[full]
            # A bare name in its defining module: qualify and retry.
            local = f"{mod.name}.{full}"
            if local in self.module_locks:
                return self.module_locks[local]
            return None

        def handle_call(node: ast.Call, held: frozenset) -> None:
            func = node.func
            dotted = _dotted(func)
            full = _alias_target(mod, dotted)
            # threading.Thread(target=...) census
            if full == "threading.Thread":
                scan.spawns_thread = True
                for kw in node.keywords:
                    if kw.arg != "target":
                        continue
                    tattr = _self_attr(kw.value)
                    if tattr is not None and cm is not None:
                        tq = cm.methods.get(tattr)
                        if tq is not None:
                            scan.thread_targets.add(tq)
                    else:
                        tq = self.index.resolve(mod, info, kw.value)
                        if tq is not None:
                            scan.thread_targets.add(tq)
                return
            # Condition.wait on an owned lock: sanctioned release +
            # re-acquire (the re-acquire edge rides scan.waits)
            if (isinstance(func, ast.Attribute)
                    and func.attr in ("wait", "wait_for")):
                recv_lock = lock_of(func.value)
                if recv_lock is not None:
                    scan.waits.append(
                        (recv_lock, held, node.lineno, node.col_offset))
                    return
            # curated blocking set
            label = self._blocking_label(mod, node)
            if label is not None:
                scan.blocking.append(
                    (label, held, node.lineno, node.col_offset))
            # resolved calls (self.method() included via callgraph)
            callee = self.index.resolve(mod, info, func)
            if callee is not None and callee != qual:
                scan.calls.append(
                    (callee, held, node.lineno, node.col_offset))

        def visit(node: ast.AST, held: frozenset) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
                return  # separate scope: analyzed as its own function
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = held
                for item in node.items:
                    lock = lock_of(item.context_expr)
                    if lock is not None and lock not in inner:
                        scan.acquires.append(
                            (lock, inner, item.context_expr.lineno,
                             item.context_expr.col_offset))
                        inner = inner | {lock}
                for item in node.items:
                    visit(item.context_expr, held)
                    if item.optional_vars is not None:
                        visit(item.optional_vars, held)
                for stmt in node.body:
                    visit(stmt, inner)
                return
            if isinstance(node, ast.Call):
                handle_call(node, held)
            if isinstance(node, ast.Attribute) and cm is not None:
                attr = _self_attr(node)
                if (attr is not None and attr not in cm.locks
                        and attr not in cm.methods):
                    is_write = isinstance(node.ctx, (ast.Store, ast.Del))
                    scan.accesses.append(_Access(
                        attr=attr, is_write=is_write, held=held,
                        line=node.lineno, col=node.col_offset,
                        in_init=in_init, method=method))
                elif (attr is not None and attr in cm.methods
                      and isinstance(node.ctx, ast.Load)):
                    scan.escapes.add(attr)  # may be pruned at call sites
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in ast.iter_child_nodes(info.node):
            visit(stmt, frozenset())

        # `self.m(...)` loads the attribute then calls it — an escape
        # survives only if some Load of the name is NOT the func of a
        # Call (a bare reference: callback registration, thread target).
        loads: Dict[str, int] = {}
        call_loads: Dict[str, int] = {}
        for node in ast.walk(info.node):
            if isinstance(node, ast.Call):
                attr = _self_attr(node.func)
                if attr is not None:
                    call_loads[attr] = call_loads.get(attr, 0) + 1
            if isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, ast.Load):
                attr = _self_attr(node)
                if attr is not None:
                    loads[attr] = loads.get(attr, 0) + 1
        scan.escapes = {a for a in scan.escapes
                        if loads.get(a, 0) > call_loads.get(a, 0)}
        return scan

    def _blocking_label(self, mod: ModuleInfo,
                        node: ast.Call) -> Optional[str]:
        func = node.func
        dotted = _dotted(func)
        full = _alias_target(mod, dotted)
        if full == "time.sleep":
            if not node.args:
                return None
            dur = _const_number(node.args[0])
            if dur is None:
                return f"`{dotted}(<non-constant>)`"
            if dur > _SLEEP_THRESHOLD_S:
                return f"`{dotted}({dur:g})`"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        tail = func.attr
        recv_is_literal = isinstance(func.value, ast.Constant)
        if tail in _RECV_TAILS:
            return f"`{dotted or tail}(...)`"
        if tail == "result":
            if recv_is_literal:
                return None
            return f"`{dotted or tail}(...)` (Future.result)"
        if tail == "get":
            if node.args:  # dict.get(key[, default]) always passes the key
                return None
            return f"`{dotted or tail}()` (queue get)"
        if tail == "join":
            if recv_is_literal:
                return None  # "sep".join(...)
            if full is not None and full.startswith(_JOIN_EXEMPT_PREFIXES):
                return None
            if node.args and (len(node.args) > 1
                              or _const_number(node.args[0]) is None):
                return None  # sep.join(parts) / path join
            return f"`{dotted or tail}(...)` (thread/queue join)"
        if tail in ("wait", "wait_for"):
            # a *held* Condition's wait is sanctioned and handled before
            # this point; any other .wait under a lock blocks the holder
            return f"`{dotted or tail}(...)`"
        return None

    # ----------------------------------------------------------- census
    def _census(self) -> None:
        roots: Set[str] = set()
        for qual, scan in self.scans.items():
            roots |= scan.thread_targets
        # transitive: everything a thread root calls runs on that thread
        frontier = sorted(roots)
        seen = set(frontier)
        while frontier:
            q = frontier.pop()
            for callee, _, _, _ in self.scans.get(q, _Scan()).calls:
                if callee not in seen:
                    seen.add(callee)
                    frontier.append(callee)
        self.thread_reachable = seen
        for cls_qual, cm in self.classes.items():
            for mname, fq in cm.methods.items():
                if fq in seen:
                    cm.threaded = True
                if self.scans.get(fq, _Scan()).spawns_thread:
                    cm.threaded = True

    # --------------------------------------------------- entry-held sets
    def _solve_entry_held(self) -> None:
        """Greatest fixed point: a private method only ever called with
        lock L held is analyzed as holding L at entry."""
        entry: Dict[str, frozenset] = {
            q: frozenset() for q in self.index.functions}
        # call sites per callee, restricted to same-class self calls
        sites: Dict[str, List[Tuple[str, frozenset]]] = {}
        for caller, scan in self.scans.items():
            for callee, held, _, _ in scan.calls:
                sites.setdefault(callee, []).append((caller, held))
        candidates = []
        for cls_qual, cm in self.classes.items():
            lock_ids = frozenset(cm.lock_id(a) for a in cm.locks)
            escaped = set()
            for fq in cm.methods.values():
                for a in self.scans[fq].escapes:
                    if a in cm.methods:
                        escaped.add(cm.methods[a])
            for mname, fq in cm.methods.items():
                if (mname.startswith("_") and not mname.startswith("__")
                        and fq not in self.thread_reachable_roots()
                        and fq not in escaped
                        and sites.get(fq)):
                    entry[fq] = lock_ids
                    candidates.append(fq)
        changed = True
        while changed:
            changed = False
            for fq in candidates:
                new = None
                for caller, held in sites[fq]:
                    at_site = held | entry.get(caller, frozenset())
                    new = at_site if new is None else (new & at_site)
                new = new if new is not None else frozenset()
                if new != entry[fq]:
                    entry[fq] = new
                    changed = True
        self.entry_held = entry

    def thread_reachable_roots(self) -> Set[str]:
        roots: Set[str] = set()
        for scan in self.scans.values():
            roots |= scan.thread_targets
        return roots

    def held_at(self, qual: str, lexical: frozenset) -> frozenset:
        return lexical | self.entry_held.get(qual, frozenset())

    # ------------------------------------------------- acquire summaries
    def _acquires_of(self, qual: str,
                     stack: Optional[Set[str]] = None
                     ) -> Dict[str, Tuple[str, int, int]]:
        """Locks (transitively) acquired inside `qual`:
        lock id -> (path, line, col) of the acquisition site."""
        if qual in self._acq_summary:
            return self._acq_summary[qual]
        stack = stack or set()
        if qual in stack:
            return {}
        stack.add(qual)
        out: Dict[str, Tuple[str, int, int]] = {}
        scan = self.scans.get(qual)
        info = self.index.functions.get(qual)
        if scan is None or info is None:
            return {}
        path = self.index.modules[info.module].path
        for lock, _, line, col in scan.acquires:
            out.setdefault(lock, (path, line, col))
        for callee, _, _, _ in scan.calls:
            for lock, site in self._acquires_of(callee, stack).items():
                out.setdefault(lock, site)
        stack.discard(qual)
        self._acq_summary[qual] = out
        return out


def _analyzer(index: PackageIndex) -> _Analyzer:
    cached = getattr(index, "_megba_concurrency", None)
    if cached is None:
        cached = _Analyzer(index)
        index._megba_concurrency = cached  # type: ignore[attr-defined]
    return cached


# ---------------------------------------------------------------- rules


def find_guarded_by(index: PackageIndex):
    """Yields (path, line, col, message) for guarded-by races."""
    an = _analyzer(index)
    for cls_qual in sorted(an.classes):
        cm = an.classes[cls_qual]
        mod = index.modules[cm.module]
        # gather every self.<attr> access across the class's methods
        per_field: Dict[str, List[Tuple[str, _Access]]] = {}
        for mname, fq in sorted(cm.methods.items()):
            for acc in an.scans[fq].accesses:
                per_field.setdefault(acc.attr, []).append((fq, acc))
        for field in sorted(per_field):
            accs = per_field[field]
            post = [(fq, a) for fq, a in accs if not a.in_init]
            if not any(a.is_write for _, a in post):
                continue  # settled in __init__: publication is safe
            declared = cm.declared.get(field)
            guard: Optional[str] = None
            how = ""
            if declared is not None:
                guard = cm.canonical(declared[0])
                how = "declared"
            else:
                n = len(post)
                if n >= 5:
                    best, best_n = None, 0
                    for attr in cm.locks:
                        lid = cm.lock_id(attr)
                        n_under = sum(
                            1 for fq, a in post
                            if lid in an.held_at(fq, a.held))
                        if n_under > best_n:
                            best, best_n = attr, n_under
                    if best is not None and best_n / n >= 0.8:
                        guard = cm.canonical(best)
                        how = (f"inferred: {best_n}/{n} accesses "
                               f"hold it")
            if guard is None or guard not in cm.locks:
                continue
            if how != "declared" and not cm.threaded:
                continue  # census: no second thread reaches this class
            lock_id = cm.lock_id(guard)
            for fq, a in post:
                if lock_id in an.held_at(fq, a.held):
                    continue
                line_src = (mod.source_lines[a.line - 1]
                            if a.line <= len(mod.source_lines) else "")
                if _ALLOW_UNGUARDED_RE.search(line_src):
                    continue
                kind = "write" if a.is_write else "read"
                yield (
                    mod.path, a.line, a.col,
                    f"{kind} of `{_short(cls_qual)}.{field}` without "
                    f"`self.{guard}` ({how}); a concurrent holder can "
                    "race this access — take the lock or annotate the "
                    "line with `# megba: allow-unguarded`")


def find_lock_order(index: PackageIndex):
    """Yields (path, line, col, message) — one per lock-order cycle."""
    an = _analyzer(index)
    # edge (a -> b) -> (path, line, col, note); first (sorted) site wins
    edges: Dict[Tuple[str, str], Tuple[str, int, int, str]] = {}

    def add_edge(a: str, b: str, site: Tuple[str, int, int],
                 note: str) -> None:
        if a != b:
            edges.setdefault((a, b), (site[0], site[1], site[2], note))

    for qual in sorted(an.scans):
        scan = an.scans[qual]
        info = index.functions[qual]
        path = index.modules[info.module].path
        for lock, lexical, line, col in scan.acquires:
            for h in sorted(an.held_at(qual, lexical)):
                add_edge(h, lock, (path, line, col), "acquire")
        for callee, lexical, line, col in scan.calls:
            held = an.held_at(qual, lexical)
            if not held:
                continue
            for lock, site in sorted(an._acquires_of(callee).items()):
                if lock in held:
                    continue
                for h in sorted(held):
                    add_edge(h, lock, site,
                             f"via call on {path}:{line}")
        for cond, lexical, line, col in scan.waits:
            held = an.held_at(qual, lexical)
            for h in sorted(held - {cond}):
                # wait releases the condition, then re-acquires it LAST
                # — while still holding h
                add_edge(h, cond, (path, line, col),
                         "Condition.wait re-acquire")

    # cycle detection: DFS with colouring; report each cycle once,
    # canonicalised by rotating to its smallest node
    adj: Dict[str, List[str]] = {}
    for (a, b) in edges:
        adj.setdefault(a, []).append(b)
    for a in adj:
        adj[a].sort()
    seen_cycles: Set[Tuple[str, ...]] = set()
    findings = []

    def dfs(node: str, stack: List[str], on_stack: Set[str],
            visited: Set[str]) -> None:
        visited.add(node)
        on_stack.add(node)
        stack.append(node)
        for nxt in adj.get(node, ()):
            if nxt in on_stack:
                cyc = stack[stack.index(nxt):]
                k = min(range(len(cyc)), key=lambda i: cyc[i])
                canon = tuple(cyc[k:] + cyc[:k])
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    findings.append(canon)
            elif nxt not in visited:
                dfs(nxt, stack, on_stack, visited)
        stack.pop()
        on_stack.discard(node)

    visited: Set[str] = set()
    for node in sorted(adj):
        if node not in visited:
            dfs(node, [], set(), visited)

    for cyc in sorted(findings):
        hops = []
        for i, a in enumerate(cyc):
            b = cyc[(i + 1) % len(cyc)]
            path, line, col, note = edges[(a, b)]
            hops.append(f"{b} ({path}:{line}, {note})")
        first = edges[(cyc[0], cyc[1 % len(cyc)])]
        witness = " -> ".join([cyc[0]] + hops)
        yield (
            first[0], first[1], first[2],
            f"lock-order cycle (deadlock witness path): {witness}; "
            "acquire these locks in one global order")


def find_blocking_under_lock(index: PackageIndex):
    """Yields (path, line, col, message) for blocking calls under a
    held lock."""
    an = _analyzer(index)
    for qual in sorted(an.scans):
        scan = an.scans[qual]
        info = index.functions[qual]
        path = index.modules[info.module].path
        for label, lexical, line, col in scan.blocking:
            held = an.held_at(qual, lexical)
            if not held:
                continue
            locks = ", ".join(f"`{h}`" for h in sorted(held))
            yield (
                path, line, col,
                f"blocking call {label} while holding {locks}: every "
                "other thread needing the lock stalls behind this I/O "
                "(the serve-loop stall shape); move the blocking call "
                "outside the critical section")
        # waiting on a condition while holding ANOTHER lock is both a
        # stall and a re-acquire inversion; the lock-order pass reports
        # the cycle, this pass reports the stall
        for cond, lexical, line, col in scan.waits:
            others = an.held_at(qual, lexical) - {cond}
            if not others:
                continue
            locks = ", ".join(f"`{h}`" for h in sorted(others))
            yield (
                path, line, col,
                f"`{cond}.wait()` releases only its own condition; "
                f"still holding {locks} while blocked — every other "
                "holder of that lock stalls for the wakeup")

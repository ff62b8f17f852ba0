"""AST module index + call graph for the port's linter.

Counterpart of `megba_tpu/analysis/callgraph.py`, unchanged in its model
so that both linters index a file alike.  Pure standard library (ast) —
the linter must run before any heavy import, so nothing here imports
torch or numpy, and nothing ever executes the code under analysis.  The
jit-entry marks below find nothing in the port (it compiles no
program); the identity lane's lowering entries are by name
(analysis/identity.py).

The model is deliberately simple and conservative:

- Every `def` in the package is indexed under a dotted qualname
  (`megba_tpu.algo.lm.lm_solve`, `megba_tpu.solve._build_single_solve.fn`).
- A function is a *jit entry* when it (a) is decorated with `jax.jit` /
  `functools.partial(jax.jit, ...)`, (b) is passed by name into a call
  whose callee ends in `jit` or `shard_map`, or (c) carries an inline
  `# megba: jit-entry` pragma on its `def` line (for engines that only
  ever arrive inside a jitted computation through a parameter, e.g. the
  residual engines `make_residual_jacobian_fn` hands to `flat_solve`).
- Reachability: any *reference* (not just call) from a reachable
  function's body to another indexed function marks that function
  reachable — this over-approximates calls, which is exactly right for
  a linter: functions passed to `lax.while_loop` / `lax.cond` / `vmap`
  inside a jitted body are traced even though they are never "called"
  by name.
- Each function additionally carries its raw attribute-read sets
  (`FunctionInfo.attr_reads`: root name -> full dotted chains read off
  it) and its simple-alias assignments (`FunctionInfo.assigns`) — the
  per-function field-read pass the program-identity lane
  (analysis/identity.py) resolves against named option parameters.

Resolution is lexical: local defs, enclosing defs, module-level defs,
then imports (`from megba_tpu.algo.lm import lm_solve` and
`from megba_tpu.parallel import mesh; mesh.get_or_build_program` both
resolve).  Anything unresolvable is silently ignored — the linter never
guesses.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

PRAGMA_RE = re.compile(r"#\s*megba:\s*([a-zA-Z0-9_,\s-]+)")

_JIT_WRAP_NAMES = {"jit", "shard_map"}


def pragmas_on_line(source_lines: List[str], lineno: int) -> Set[str]:
    """Inline `# megba: tok[, tok...]` tokens on a 1-based physical line."""
    if not (1 <= lineno <= len(source_lines)):
        return set()
    m = PRAGMA_RE.search(source_lines[lineno - 1])
    if not m:
        return set()
    return {t.strip() for t in m.group(1).replace(",", " ").split() if t.strip()}


@dataclasses.dataclass
class FunctionInfo:
    qualname: str  # module-dotted path, nesting flattened with "."
    module: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    parent: Optional[str]  # enclosing function qualname
    children: List[str] = dataclasses.field(default_factory=list)
    refs: Set[str] = dataclasses.field(default_factory=set)
    is_entry: bool = False
    # Dotted qualname of the innermost enclosing class, when this def is
    # a method (None for plain functions).  Lets `self.method()` calls
    # resolve to the defining class — the cross-method lock edges the
    # concurrency passes follow.
    classname: Optional[str] = None
    # Attribute-read sets (raw material for the identity lane, reusable
    # by any future rule): root Name -> dotted attribute chains read
    # off it in THIS function's own body (a nested def records its own
    # reads on its own FunctionInfo, so closure reads resolve through
    # `parent`).  `option.solver_option.bf16` records
    # {"solver_option.bf16"} under "option"; only FULL chains are
    # recorded (never their suffixes), only Load contexts count, and
    # chains that resolve to indexed functions stay refs, not reads.
    attr_reads: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)
    # Simple local aliases: `solver_opt = option.solver_option` records
    # {"solver_opt": "option.solver_option"} — the single-level
    # resolution step a consumer needs to root alias reads back at a
    # named parameter (last assignment wins; only pure Name/Attribute
    # chain values are recorded).
    assigns: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModuleInfo:
    name: str  # dotted module name
    path: str
    tree: ast.Module
    source_lines: List[str]
    # local alias -> fully qualified dotted target ("np" -> "numpy",
    # "lm_solve" -> "megba_tpu.algo.lm.lm_solve")
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)
    functions: Dict[str, str] = dataclasses.field(default_factory=dict)
    # module-level simple name -> function qualname


class PackageIndex:
    """Parsed view of a set of Python files plus the jit call graph."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.reachable: Set[str] = set()
        # class qualname -> method simple name -> function qualname
        # (immediate methods only; no inheritance walking — the linter
        # never guesses).
        self.classes: Dict[str, Dict[str, str]] = {}

    # ------------------------------------------------------------- build
    @classmethod
    def build(cls, paths: Iterable[str]) -> "PackageIndex":
        index = cls()
        for path, modname in _iter_module_files(paths):
            index._add_module(path, modname)
        for mod in index.modules.values():
            index._collect_refs_and_entries(mod)
        index._propagate_reachability()
        return index

    def _add_module(self, path: str, modname: str) -> None:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
        mod = ModuleInfo(
            name=modname, path=path, tree=tree,
            source_lines=source.splitlines())
        self.modules[modname] = mod
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    mod.imports[alias.asname or alias.name.split(".")[0]] = (
                        alias.name if alias.asname else alias.name.split(".")[0])
                    if alias.asname:
                        mod.imports[alias.asname] = alias.name
            elif isinstance(node, ast.ImportFrom):
                if node.module is None or node.level:
                    continue  # relative imports unused in this repo
                for alias in node.names:
                    mod.imports[alias.asname or alias.name] = (
                        f"{node.module}.{alias.name}")
        self._index_functions(mod, tree, parent=None, prefix=modname)

    def _index_functions(self, mod: ModuleInfo, node: ast.AST,
                         parent: Optional[str], prefix: str,
                         classname: Optional[str] = None) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{child.name}"
                info = FunctionInfo(
                    qualname=qual, module=mod.name, node=child, parent=parent,
                    classname=classname)
                self.functions[qual] = info
                if classname is not None:
                    self.classes.setdefault(classname, {})[child.name] = qual
                if parent is not None:
                    self.functions[parent].children.append(qual)
                else:
                    mod.functions[child.name] = qual
                # A method's own nested defs are plain functions again.
                self._index_functions(mod, child, parent=qual, prefix=qual,
                                      classname=None)
            elif isinstance(child, ast.ClassDef):
                # Methods are indexed too (flat qualname through the class).
                self._index_functions(
                    mod, child, parent=parent, prefix=f"{prefix}.{child.name}",
                    classname=f"{prefix}.{child.name}")
            elif isinstance(child, (ast.If, ast.Try, ast.With, ast.For,
                                    ast.While)):
                # Compound statements at the same scope can hold defs —
                # mesh.py's shard_map fallback lives in an `except:` block.
                self._index_functions(mod, child, parent, prefix, classname)

    # -------------------------------------------------- refs and entries
    def _scope_chain(self, mod: ModuleInfo,
                     func: Optional[FunctionInfo]) -> List[FunctionInfo]:
        chain = []
        cur = func
        while cur is not None:
            chain.append(cur)
            cur = self.functions.get(cur.parent) if cur.parent else None
        return chain

    def resolve(self, mod: ModuleInfo, func: Optional[FunctionInfo],
                name_node: ast.AST) -> Optional[str]:
        """Resolve a Name/Attribute node to an indexed function qualname."""
        dotted = _dotted(name_node)
        if dotted is None:
            return None
        head, *rest = dotted.split(".")
        # 0. `self.method(...)` resolves to the innermost enclosing
        #    class's own method (closures nested in methods capture
        #    `self`, so the whole scope chain is searched).  Immediate
        #    methods only — no inheritance guessing.
        if head == "self" and len(rest) == 1:
            for scope in self._scope_chain(mod, func):
                if scope.classname is not None:
                    q = self.classes.get(scope.classname, {}).get(rest[0])
                    if q is not None:
                        return q
                    break  # innermost class decides; never walk outward
        # 1. lexical function scopes: own nested defs, then siblings via
        #    each enclosing function's children
        if not rest:
            for scope in self._scope_chain(mod, func):
                for child_q in scope.children:
                    if child_q.rsplit(".", 1)[-1] == head:
                        return child_q
        # 2. module-level defs
        if not rest and head in mod.functions:
            return mod.functions[head]
        # 3. imports: direct function import, or `import pkg.mod` /
        #    `from pkg import mod` followed by `mod.fn`
        target = mod.imports.get(head)
        if target is None:
            return None
        full = ".".join([target] + rest)
        return full if full in self.functions else None

    def _collect_refs_and_entries(self, mod: ModuleInfo) -> None:
        """One pass over the module: per-function references + entries."""

        index = self

        def owner_of(node_stack) -> Optional[FunctionInfo]:
            for n in reversed(node_stack):
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = getattr(n, "_megba_qualname", None)
                    if q:
                        return index.functions[q]
            return None

        # annotate nodes with their qualnames for owner lookup
        for q, info in self.functions.items():
            if info.module == mod.name:
                info.node._megba_qualname = q  # type: ignore[attr-defined]

        class Visitor(ast.NodeVisitor):
            def __init__(self) -> None:
                self.stack: List[ast.AST] = []

            def generic_visit(self, node: ast.AST) -> None:
                self.stack.append(node)
                super().generic_visit(node)
                self.stack.pop()

            def visit_FunctionDef(self, node):  # noqa: N802
                q = getattr(node, "_megba_qualname", None)
                if q is not None:
                    info = index.functions[q]
                    if _has_jit_decorator(node):
                        info.is_entry = True
                    if "jit-entry" in pragmas_on_line(
                            mod.source_lines, node.lineno):
                        info.is_entry = True
                self.generic_visit(node)

            visit_AsyncFunctionDef = visit_FunctionDef  # noqa: N815

            def visit_Call(self, node):  # noqa: N802
                owner = owner_of(self.stack)
                callee = _dotted(node.func)
                if callee is not None and callee.split(".")[-1] in _JIT_WRAP_NAMES:
                    # jax.jit(fn, ...) / shard_map(fn, ...): every
                    # function reference anywhere in the argument
                    # expressions becomes a jit entry — including ones
                    # wrapped in adapters, e.g. jax.jit(traced("s", fn)).
                    for arg in list(node.args) + [kw.value for kw in node.keywords]:
                        for sub in ast.walk(arg):
                            if isinstance(sub, (ast.Name, ast.Attribute)):
                                q = index.resolve(mod, owner, sub)
                                if q is not None:
                                    index.functions[q].is_entry = True
                self.generic_visit(node)

            def visit_Name(self, node):  # noqa: N802
                if isinstance(node.ctx, ast.Load):
                    owner = owner_of(self.stack)
                    if owner is not None:
                        q = index.resolve(mod, owner, node)
                        if q is not None and q != owner.qualname:
                            owner.refs.add(q)
                self.generic_visit(node)

            def visit_Attribute(self, node):  # noqa: N802
                if isinstance(node.ctx, ast.Load):
                    owner = owner_of(self.stack)
                    if owner is not None:
                        q = index.resolve(mod, owner, node)
                        if q is not None and q != owner.qualname:
                            owner.refs.add(q)
                            return  # don't double-count the inner Name
                        # Not a function reference: record the full
                        # attribute-read chain on its owner — but only
                        # at the OUTERMOST Attribute of a chain (an
                        # inner `a.b` of `a.b.c` sees its parent
                        # Attribute on the stack and is skipped, so
                        # suffixes are never recorded).
                        if not (self.stack
                                and isinstance(self.stack[-1], ast.Attribute)):
                            dotted = _dotted(node)
                            if dotted is not None:
                                root, _, chain = dotted.partition(".")
                                owner.attr_reads.setdefault(
                                    root, set()).add(chain)
                self.generic_visit(node)

            def visit_Assign(self, node):  # noqa: N802
                owner = owner_of(self.stack)
                if (owner is not None and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    val = _dotted(node.value)
                    if val is not None:
                        owner.assigns[node.targets[0].id] = val
                self.generic_visit(node)

            def visit_AnnAssign(self, node):  # noqa: N802
                owner = owner_of(self.stack)
                if (owner is not None and node.value is not None
                        and isinstance(node.target, ast.Name)):
                    val = _dotted(node.value)
                    if val is not None:
                        owner.assigns[node.target.id] = val
                self.generic_visit(node)

        Visitor().visit(mod.tree)

    def _propagate_reachability(self) -> None:
        frontier = [q for q, f in self.functions.items() if f.is_entry]
        seen = set(frontier)
        while frontier:
            q = frontier.pop()
            info = self.functions[q]
            # A reachable function's nested defs are traced with it.
            for nxt in list(info.refs) + list(info.children):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        self.reachable = seen

    # ------------------------------------------------------------ helpers
    def module_of_path(self, path: str) -> Optional[ModuleInfo]:
        for mod in self.modules.values():
            if os.path.samefile(mod.path, path):
                return mod
        return None


def _dotted(node: ast.AST) -> Optional[str]:
    """`a.b.c` Attribute/Name chain -> "a.b.c", else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _has_jit_decorator(node) -> bool:
    for dec in node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        dotted = _dotted(target)
        if dotted is None:
            continue
        tail = dotted.split(".")[-1]
        if tail in _JIT_WRAP_NAMES:
            return True
        if tail == "partial":
            # functools.partial(jax.jit, ...) as a decorator factory
            if isinstance(dec, ast.Call) and dec.args:
                inner = _dotted(dec.args[0])
                if inner is not None and inner.split(".")[-1] in _JIT_WRAP_NAMES:
                    return True
    return False


def _iter_module_files(paths: Iterable[str]) -> List[Tuple[str, str]]:
    """Expand files/dirs into (path, dotted module name) pairs.

    The dotted name is rooted at the nearest ancestor directory that is
    NOT a package (has no __init__.py), so `megba_tpu/algo/lm.py` maps
    to `megba_tpu.algo.lm` whether the linter is invoked from the repo
    root or given an absolute path.
    """
    out: List[Tuple[str, str]] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if not d.startswith(".") and d != "__pycache__")
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        fp = os.path.join(dirpath, fn)
                        out.append((fp, _module_name(fp)))
        elif os.path.isfile(p) and p.endswith(".py"):
            out.append((p, _module_name(p)))
        else:
            # A vanished path must FAIL the gate, not lint zero files
            # and report clean — a typo'd directory in scripts/lint.sh
            # would otherwise turn the whole acceptance gate green.
            raise ValueError(f"not a directory or .py file: {p!r}")
    if not out:
        raise ValueError(f"no Python files found under: {list(paths)!r}")
    return out


def _module_name(path: str) -> str:
    path = os.path.abspath(path)
    parts = [os.path.splitext(os.path.basename(path))[0]]
    d = os.path.dirname(path)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        d = os.path.dirname(d)
    name = ".".join(reversed(parts))
    return name[: -len(".__init__")] if name.endswith(".__init__") else name

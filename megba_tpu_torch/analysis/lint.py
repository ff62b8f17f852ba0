"""The port's linter CLI: `python -m megba_tpu_torch.analysis.lint <paths>`.

Counterpart of `megba_tpu/analysis/lint.py`, with the same exit codes,
output lines and pragmas.  The analysis itself is standard-library only
(ast; it never imports or executes the code under lint): parses the
given files/packages, builds the call graph (analysis/callgraph.py) and
runs the repo-specific rules (analysis/rules.py).  Exit status: 0 clean,
1 findings, 2 usage/path error.

Findings print as `path:line:col: <rule> <message>`, one per line, so
editors and CI logs link straight to the site.  Suppress a single
finding with an inline `# megba: allow-<rule>` pragma on the flagged
line; mark engine functions only ever traced through a parameter with
`# megba: jit-entry`.
"""

from __future__ import annotations

import argparse
import sys
from typing import Iterable, List, Optional, Sequence

from megba_tpu_torch.analysis.callgraph import PackageIndex, pragmas_on_line
from megba_tpu_torch.analysis.rules import ALL_RULES, RULES, Finding


def lint_paths(paths: Iterable[str],
               rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the (selected) rules over `paths`; returns kept findings.

    Findings on lines carrying the matching `# megba: allow-<rule>`
    pragma are dropped here, so every caller — CLI, tests, CI — sees
    identical suppression semantics.
    """
    index = PackageIndex.build(paths)
    selected = list(rules) if rules else list(ALL_RULES)
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise ValueError(f"unknown rule(s): {', '.join(unknown)}; "
                         f"known: {', '.join(ALL_RULES)}")
    findings: List[Finding] = []
    lines_by_path = {m.path: m.source_lines for m in index.modules.values()}
    for rule in selected:
        for f in RULES[rule](index):
            allowed = pragmas_on_line(lines_by_path.get(f.path, []), f.line)
            if f"allow-{f.rule}" in allowed:
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def list_suppressions(paths: Iterable[str]):
    """Every inline `# megba: allow-<rule>` pragma under `paths`.

    Returns sorted (path, line, [allow-tokens], source-line) tuples —
    the audit trail of accumulated suppressions, so a pragma can never
    quietly outlive the code smell it excused.  Only well-formed
    `allow-<rule>` tokens count (a docstring's literal `allow-<rule>`
    placeholder captures as a bare "allow-" and is not a suppression).
    """
    import re

    well_formed = re.compile(r"allow-[A-Za-z0-9_][A-Za-z0-9_-]*$")
    index = PackageIndex.build(paths)
    out = []
    for mod in index.modules.values():
        for lineno in range(1, len(mod.source_lines) + 1):
            allows = sorted(
                t for t in pragmas_on_line(mod.source_lines, lineno)
                if well_formed.fullmatch(t))
            if allows:
                out.append((mod.path, lineno, allows,
                            mod.source_lines[lineno - 1].strip()))
    return sorted(out)


def run_lint(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m megba_tpu_torch.analysis.lint",
        description="megba_tpu_torch linter (clock, concurrency and "
                    "program-identity lanes)")
    parser.add_argument("paths", nargs="*",
                        help="package dirs or .py files to lint")
    parser.add_argument("--rule", action="append", dest="rules",
                        metavar="RULE",
                        help="run only this rule (repeatable)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule ids and exit")
    parser.add_argument("--list-suppressions", action="store_true",
                        help="print every inline `# megba: allow-<rule>` "
                             "pragma under the given paths with file:line")
    args = parser.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            print(r)
        return 0
    if not args.paths:
        parser.print_usage(sys.stderr)
        return 2
    if args.list_suppressions:
        try:
            found = list_suppressions(args.paths)
        except ValueError as exc:  # bad path: usage error, not traceback
            print(f"error: {exc}", file=sys.stderr)
            return 2
        for path, lineno, allows, source in found:
            print(f"{path}:{lineno}: {', '.join(allows)} | {source}")
        print(f"{len(found)} suppression(s)", file=sys.stderr)
        return 0
    try:
        findings = lint_paths(args.paths, rules=args.rules)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    for f in findings:
        print(f.format())
    if findings:
        print(f"{len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(run_lint())

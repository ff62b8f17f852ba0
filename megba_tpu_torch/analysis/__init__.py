"""Static and runtime correctness tooling of the port.

Counterpart of `megba_tpu/analysis/`, with its module names.  The port
compiles no program, so its lanes check what the port does instead:

- `analysis.lint` — zero-dependency AST linter (the clock, concurrency
  and program-identity lanes).  `python -m megba_tpu_torch.analysis.lint
  megba_tpu_torch`.
- `analysis.edge_budget` — the declared flops and bytes of one S.p
  product, priced for the port's kernels.
- `analysis.strict_dtype` — the sanitizer lane: small BA and PGO solves
  under a torch function mode that raises on a float-dtype mix outside
  the declared mixed arms and on a NaN outside the declared sites.
- `analysis.retrace` — the rebuild sentinel: kernel-library builds and
  plan-cache misses per (site, signature).
- `analysis.program_audit` — the launch and host-sync census of the
  canonical specs against the committed `audit_budget.json`.
  CLI: `python -m megba_tpu_torch.analysis.program_audit --check` /
  `--update`.

Suppress a single lint finding with an inline `# megba: allow-<rule>`
pragma on the flagged line.

Submodules are loaded lazily: `python -m megba_tpu_torch.analysis.lint`
must not re-import the module it is executing (runpy warns), and the
solver's hooks must not drag the linter in on the production import
path.
"""

_EXPORTS = {
    "lint_paths": "lint", "run_lint": "lint",
    "RetraceError": "retrace", "RetraceSentinel": "retrace",
    "sentinel": "retrace",
    "strict_promotion": "strict_dtype",
    "ProgramSpec": "program_audit", "audit_all": "program_audit",
    "program_specs": "program_audit",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(
            f"megba_tpu_torch.analysis.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module 'megba_tpu_torch.analysis' has no "
                         f"attribute {name!r}")

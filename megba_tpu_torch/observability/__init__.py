"""Solve observability: the per-iteration trace (trace.py), the JSONL
`SolveReport` telemetry (report.py) and its reader (summarize.py,
`python -m megba_tpu_torch.observability.summarize`).

`report` and `summarize` load on first use, so a solve with telemetry
off imports neither.
"""

from megba_tpu_torch.observability.trace import SolveTrace, trace_to_dict

__all__ = ["SolveReport", "SolveTrace", "append_report", "build_report",
           "trace_to_dict"]

_LAZY = {"SolveReport", "append_report", "build_report"}


def __getattr__(name):
    if name in _LAZY:
        from megba_tpu_torch.observability import report

        return getattr(report, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

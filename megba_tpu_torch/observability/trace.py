"""SolveTrace: per-iteration convergence history of one LM solve.

Counterpart of `megba_tpu/observability/trace.py`: fixed-size
`[max_iter]` CPU tensors, written once per LM iteration and masked by
`LMResult.iterations`.  Field names and order are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import torch

TRACE_FIELDS = (
    "cost",
    "grad_inf_norm",
    "trust_region",
    "rho",
    "accept",
    "pcg_iters",
    "pcg_eta",
    "pcg_r0_ratio",
    "recovery",
    "pcg_breakdown",
    "precond_fallback",
)

_FIELD_DTYPES = {"accept": torch.bool, "pcg_iters": torch.int32,
                 "recovery": torch.bool, "pcg_breakdown": torch.int32,
                 "precond_fallback": torch.int32}


@dataclasses.dataclass
class SolveTrace:
    """Per-iteration LM history, shaped [max_iter] and masked by k.

    `cost` is the TRIAL cost of each iteration; `grad_inf_norm` is
    ||g||_inf of the system the iteration ends with; `trust_region` the
    region the step was computed with; `rho` the gain ratio; `accept` the
    decision; `pcg_iters` the inner-solver iterations.  Under
    `RobustOption.guards`, `recovery` marks a rolled-back step and
    `pcg_breakdown` counts the PCG's breakdown restarts (zero without
    guards); `precond_fallback` is the enum-coded fallback count
    (solver/precond.encode_precond_fallback) whenever SCHUR_DIAG or a
    non-JACOBI family is live, zero otherwise.
    """

    cost: torch.Tensor
    grad_inf_norm: torch.Tensor
    trust_region: torch.Tensor
    rho: torch.Tensor
    accept: torch.Tensor
    pcg_iters: torch.Tensor
    pcg_eta: torch.Tensor
    pcg_r0_ratio: torch.Tensor
    recovery: torch.Tensor
    pcg_breakdown: torch.Tensor
    precond_fallback: torch.Tensor

    @classmethod
    def empty(cls, max_iter: int, dtype: torch.dtype) -> "SolveTrace":
        return cls(**{f: torch.zeros((max_iter,),
                                     dtype=_FIELD_DTYPES.get(f, dtype))
                      for f in TRACE_FIELDS})

    def record(self, k: int, **values) -> None:
        """Write iteration k's observables (in place)."""
        for name, v in values.items():
            getattr(self, name)[k] = v


def trace_slice(trace: SolveTrace, n: int) -> SolveTrace:
    """The first n iterations (drops the unused tail)."""
    return SolveTrace(**{f: getattr(trace, f)[:n].clone()
                         for f in TRACE_FIELDS})


def trace_filler(n: int) -> SolveTrace:
    """n iterations of inert history: NaN (float64) in the float fields,
    no accepts or recoveries, 0 in the counters, as the JAX package's.

    Used when a checkpointed solve resumes a snapshot written before
    traces existed: the pre-resume iterations are unknowable, but the
    stitched trace must still line up index-for-index with
    `LMResult.iterations`.
    """
    return SolveTrace(**{
        f: (torch.zeros((n,), dtype=_FIELD_DTYPES[f]) if f in _FIELD_DTYPES
            else torch.full((n,), float("nan"), dtype=torch.float64))
        for f in TRACE_FIELDS})


def trace_concat(parts) -> SolveTrace:
    """Concatenate per-chunk traces into one solve history (the float
    fields promote as numpy's concatenate does: float32 beside float64
    filler gives float64).  The checkpointed drivers slice each chunk's
    trace to the iterations it ran and stitch the chunks back together,
    so a resumed solve reports the trace a straight run would."""
    return SolveTrace(**{
        f: torch.cat([torch.as_tensor(getattr(p, f)) for p in parts])
        if parts else torch.zeros((0,),
                                  dtype=_FIELD_DTYPES.get(f, torch.float64))
        for f in TRACE_FIELDS})


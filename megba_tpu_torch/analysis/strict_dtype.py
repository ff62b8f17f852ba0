"""Strict-dtype sanitizer lane of the port.

Counterpart of `megba_tpu/analysis/strict_dtype.py`, which runs small
solves under `jax_numpy_dtype_promotion='strict'` and `jax_debug_nans`.
Here `strict_promotion()` installs a `torch.overrides.TorchFunctionMode`
that sees every torch function and tensor method the solve calls and
raises `StrictDtypeError`:

- when an op's tensor operands mix floating dtypes outside the port's
  declared mixed arms: bfloat16 operands beside float32 or float64 (the
  bf16 rung's operands with their wider accumulation) are declared; any
  other mix (float32 with float64, float16 with either) is a promotion
  torch would make silently;
- with `debug_nans`, when an op returns a NaN outside the declared
  sites (`DECLARED_NAN_SITES`): the fault injection
  (robustness/faults.py), which makes NaNs on purpose.  Only the
  innermost frame of the port that called the op is matched, so a NaN
  made anywhere else (a matvec, a preconditioner, a kernel wrapper,
  the PCG or LM loop itself) raises, and so does a fault's NaN once
  other code carries it on, as under `jax_debug_nans`.  The breakdown
  guards make no NaN: they read `isfinite` and select with `where`.

Python scalars are weak, as in JAX, and never count as a dtype.  The NaN
check reads every float output on the host, so it is for small solves
only.  `python -m megba_tpu_torch.analysis.strict_dtype [--device D]`
runs small BA and PGO solves under it (float32 and float64) and exits 0
when they pass.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import torch
from torch.overrides import TorchFunctionMode

# Floating dtypes that may sit beside a wider one in one op: the bf16
# rung's operands (f32 or f64 accumulation).
DECLARED_NARROW = frozenset({torch.bfloat16})

# (module suffix, function name or "*") pairs whose frames may produce
# a NaN: the fault injection.
DECLARED_NAN_SITES = (
    ("robustness.faults", "*"),
)

# Functions that only read metadata, move data or allocate without
# writing (an uninitialised buffer may hold any bits, NaNs too, until a
# kernel fills it): never a promotion, never a NaN of the solve's.
_PASS = frozenset({"__get__", "__set__", "size", "dim", "numel",
                   "element_size", "is_floating_point", "is_contiguous",
                   "data_ptr", "stride", "storage_offset", "__len__",
                   "__repr__", "__format__", "__bool__", "__int__",
                   "__float__", "__index__", "item", "tolist", "numpy",
                   "to", "type", "float", "double", "half", "bfloat16",
                   "copy_", "detach", "clone", "contiguous", "cpu", "cuda",
                   "view", "reshape", "__setitem__", "__getitem__",
                   "isnan", "isfinite", "isinf", "any", "all",
                   "_make_subclass", "__reduce_ex__", "empty",
                   "empty_strided", "new_empty",
                   "new_zeros", "new_ones", "new_full", "new_tensor",
                   "empty_like", "zeros_like", "ones_like", "full_like"})


class StrictDtypeError(RuntimeError):
    """A float-dtype mix or a NaN outside the declared sites.  Not a
    TypeError: torch turns a TypeError raised inside a binary operator
    into NotImplemented."""


def _tensors(x, out):
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _name(func) -> str:
    return getattr(func, "__name__", None) or repr(func)


def float_mix(tensors) -> frozenset:
    """The floating dtypes of `tensors` when they mix outside the
    declared arms, else an empty set."""
    floats = {t.dtype for t in tensors if t.is_floating_point()}
    wide = floats - DECLARED_NARROW
    if len(wide) > 1:
        return frozenset(floats)
    return frozenset()


def _has_nan(t: torch.Tensor) -> bool:
    """Whether `t` holds a NaN; False for a value inside a functorch
    transform (vmap, grad), which has no value to read: the transform's
    result is checked where it leaves it."""
    try:
        return bool(torch.isnan(t).any())
    except RuntimeError:
        return False


def _declared_nan_frame() -> bool:
    """Whether the innermost frame of the port that called the op is a
    declared NaN site; False when no frame of the port called it."""
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("megba_tpu_torch.") and mod != __name__:
            return any(mod.endswith(suffix) and fn in ("*", f.f_code.co_name)
                       for suffix, fn in DECLARED_NAN_SITES)
        f = f.f_back
    return False


class StrictMode(TorchFunctionMode):
    """The sanitizer's torch function mode (see the module docstring).
    `ops` counts the calls it checked, `nans_declared` the NaNs it let
    through at a declared site."""

    def __init__(self, debug_nans: bool = True):
        super().__init__()
        self.debug_nans = debug_nans
        self.ops = 0
        self.nans_declared = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _name(func)
        if name not in _PASS:
            self.ops += 1
            mix = float_mix(_tensors((args, kwargs), []))
            if mix:
                raise StrictDtypeError(
                    f"`{name}` mixes floating dtypes "
                    f"{sorted(str(d) for d in mix)} outside the declared "
                    "mixed arms (bf16 operands with f32/f64 accumulation)")
        out = func(*args, **kwargs)
        if self.debug_nans and name not in _PASS:
            for t in _tensors(out, []):
                if t.is_floating_point() and t.numel() and _has_nan(t):
                    if _declared_nan_frame():
                        self.nans_declared += 1
                        break
                    raise StrictDtypeError(
                        f"`{name}` returned a NaN outside the declared "
                        "NaN sites (faults and guards)")
        return out


@contextlib.contextmanager
def strict_promotion(debug_nans: bool = True):
    """Run the block under the sanitizer; yields the `StrictMode`."""
    mode = StrictMode(debug_nans)
    with mode:
        yield mode


def run_ba_smoke(dtype=None, world_size: int = 1, device="cpu"):
    """One tiny BA solve under the sanitizer; returns the LMResult."""
    import numpy as np

    from megba_tpu_torch.common import (
        AlgoOption,
        JacobianMode,
        ProblemOption,
        SolverOption,
    )
    from megba_tpu_torch.io.synthetic import make_synthetic_bal
    from megba_tpu_torch.ops.residuals import make_residual_jacobian_fn
    from megba_tpu_torch.solve import flat_solve

    dtype = np.float32 if dtype is None else dtype
    s = make_synthetic_bal(num_cameras=4, num_points=24, obs_per_point=3,
                           seed=0, param_noise=4e-2, pixel_noise=0.3,
                           dtype=dtype)
    option = ProblemOption(
        dtype=dtype, world_size=world_size,
        algo_option=AlgoOption(max_iter=4),
        solver_option=SolverOption(max_iter=10, tol=1e-8))
    dev = device if world_size == 1 else [device] * world_size
    res = flat_solve(
        make_residual_jacobian_fn(mode=JacobianMode.AUTODIFF),
        s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx, option,
        device=dev)
    _check_decrease("ba", res.initial_cost, res.cost, res.iterations)
    return res


def run_pgo_smoke(dtype=None, device="cpu"):
    """One tiny pose-graph solve under the sanitizer."""
    import numpy as np

    from megba_tpu_torch.common import AlgoOption, ProblemOption, SolverOption
    from megba_tpu_torch.models.pgo import make_synthetic_pose_graph, solve_pgo

    dtype = np.float32 if dtype is None else dtype
    g = make_synthetic_pose_graph(num_poses=12, seed=0)
    option = ProblemOption(
        dtype=dtype,
        algo_option=AlgoOption(max_iter=4),
        solver_option=SolverOption(max_iter=10, tol=1e-8))
    res = solve_pgo(g.poses0, g.edge_i, g.edge_j, g.meas, option,
                    device=device)
    _check_decrease("pgo", res.initial_cost, res.cost, res.iterations)
    return res


def _check_decrease(label, cost0, cost, iters) -> None:
    import math

    c0, c1 = float(cost0), float(cost)
    if not (math.isfinite(c0) and math.isfinite(c1)):
        raise AssertionError(f"[{label}] non-finite cost: {c0} -> {c1}")
    if not c1 <= c0:
        raise AssertionError(f"[{label}] cost did not decrease: "
                             f"{c0:.6e} -> {c1:.6e}")
    print(f"[strict-dtype] {label}: {c0:.6e} -> {c1:.6e} "
          f"in {int(iters)} iters OK", flush=True)


def run_lane(device="cpu") -> dict:
    """The lane: BA at float32 and float64 and PGO at float32 under the
    sanitizer; returns {"ops": calls checked, "nans_declared": ...}.
    The solves inject no fault, so a NaN even at a declared site fails."""
    import numpy as np

    with strict_promotion() as mode:
        for dt in (np.float32, np.float64):
            run_ba_smoke(dtype=dt, device=device)
        run_pgo_smoke(device=device)
    if mode.nans_declared:
        raise StrictDtypeError(
            f"{mode.nans_declared} NaN(s) at a declared site in the "
            "lane's fault-free solves")
    return {"ops": mode.ops, "nans_declared": mode.nans_declared}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m megba_tpu_torch.analysis.strict_dtype",
        description="small BA and PGO solves under the strict-dtype mode")
    ap.add_argument("--device", default="cpu",
                    help="the solves' device (default: cpu)")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    info = run_lane(args.device)
    print(f"strict-dtype sanitizer lane OK ({info['ops']} ops checked)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

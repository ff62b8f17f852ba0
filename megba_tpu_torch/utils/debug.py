"""Debug / inspection helpers.

Counterpart of `megba_tpu/utils/debug.py`, the reference's debug layer
(include/macro.h): the `PRINT_DMEMORY` / `PRINT_DCSR` device-memory dumps
(macro.h:14-84) become `describe_array` / `print_blocks`, which take a
tensor on any device or a numpy array and print the JAX package's text,
and the `ASSERT_CUDA_NO_ERROR` / `ASSERT_HOST_NO_MEM_ERROR` macros
(macro.h:49-95) map to `assert_all_finite`, the failure a solve can
actually hit (NaN/Inf poisoning).  The port runs no traced program, so
`assert_all_finite` always checks eagerly; its `debug=` flag is accepted
for the JAX package's signature and has no further effect.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def _host(x: Any) -> np.ndarray:
    """A tensor (any device, any dtype; bfloat16 widened to float32,
    which holds it exactly) or an array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(x)


def _dtype_name(x: Any, a: np.ndarray) -> str:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(a.dtype)


def describe_array(name: str, x: Any, max_items: int = 8) -> str:
    """One-line summary: shape, dtype, range, norm, first items."""
    a = _host(x)
    if a.size == 0:
        return f"{name}: shape={a.shape} (empty)"
    flat = a.reshape(-1)
    head = ", ".join(f"{v:.5g}" for v in flat[:max_items])
    finite = np.isfinite(flat)
    extra = "" if finite.all() else f" NONFINITE={int((~finite).sum())}"
    more = ", ..." if flat.size > max_items else ""
    return (
        f"{name}: shape={a.shape} dtype={_dtype_name(x, a)} "
        f"min={flat.min():.5g} max={flat.max():.5g} "
        f"|x|={np.linalg.norm(flat):.5g}{extra} [{head}{more}]"
    )


def print_blocks(name: str, blocks: Any,
                 indices: Optional[range] = None) -> None:
    """Pretty-print a few [N, d, d] Hessian blocks (PRINT_DCSR's role of
    eyeballing assembled system content, macro.h:61-84)."""
    b = _host(blocks)
    indices = indices if indices is not None else range(min(2, b.shape[0]))
    print(f"{name}: {b.shape[0]} blocks of {b.shape[1]}x{b.shape[2]}")
    for i in indices:
        with np.printoptions(precision=4, suppress=True):
            print(f"  block[{i}] =\n{np.asarray(b[i])}")


def assert_all_finite(x: Any, name: str = "array", debug: bool = False):
    """Identity passthrough that raises FloatingPointError if `x` (a
    tensor on any device, or an array) holds non-finite values.  The
    check is eager (it reads a CUDA tensor's count back, one sync); the
    JAX package's `debug=` gate for traced programs has no counterpart
    and no effect here."""
    del debug
    if isinstance(x, torch.Tensor):
        bad = int((~torch.isfinite(x.detach())).sum())
    else:
        bad = int((~np.isfinite(np.asarray(x))).sum())
    if bad:
        raise FloatingPointError(f"{name} contains {bad} non-finite values")
    return x

"""Call-shape-normalising memoisation (the JAX package's
`utils/memo.py`).

`functools.lru_cache` keys the raw call shape: `f(x)` and `f(arg=x)` are
two entries though they run the same code on the same value.  For a
program factory (the serving layer's `compile_pool.batched_solve_program`)
that would build one bucket program twice.  `normalized_lru_cache` binds
every call against the wrapped function's signature, defaults applied,
so every spelling of one logical call hits one entry.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)


def normalized_lru_cache(maxsize: int = 64) -> Callable[[F], F]:
    """`functools.lru_cache` behind signature-normalised call binding.

    Var-positional and var-keyword parameters are refused when the
    function is decorated: they have no canonical positional form.  The
    wrapper exposes `cache_clear()`, `cache_info()` and `__wrapped__`.
    """

    def deco(fn: F) -> F:
        sig = inspect.signature(fn)
        for p in sig.parameters.values():
            if p.kind in (inspect.Parameter.VAR_POSITIONAL,
                          inspect.Parameter.VAR_KEYWORD):
                raise TypeError(
                    f"normalized_lru_cache cannot canonicalise *args/"
                    f"**kwargs parameter {p.name!r} of {fn.__qualname__}")
        order = tuple(sig.parameters)
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            return cached(*(bound.arguments[name] for name in order))

        wrapper.cache_clear = cached.cache_clear  # type: ignore[attr-defined]
        wrapper.cache_info = cached.cache_info  # type: ignore[attr-defined]
        return wrapper  # type: ignore[return-value]

    return deco

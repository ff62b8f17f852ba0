"""Hooks of the launch and host-read census (analysis/program_audit.py).

The solver's loops call `mark` at the top of every LM and PCG iteration
and after each loop, every public collective calls `note_collective`
once (the outermost call only), and every kernel wrapper calls
`kernel_call` where it launches or runs its plain version: with no
census open each is one global lookup.  Standard library only.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

# The open census's callback (name, detail) or None.
_HOOK: Optional[Callable[[str, str], None]] = None
# Per thread, the nesting depth of public collectives (psum inside
# psum_groups counts once, as the outer kind).
_TLS = threading.local()


def _depth() -> int:
    return getattr(_TLS, "depth", 0)


def mark(region: str) -> None:
    """A region boundary: "lm" / "pcg" start an LM / PCG iteration,
    "lm_done" / "pcg_done" close the loop."""
    if _HOOK is not None:
        _HOOK("mark", region)


def note_collective(kind: str) -> None:
    """One public collective of `kind` (psum, psum_groups, psum_scatter,
    all_gather, ppermute)."""
    if _HOOK is not None and _depth() == 0:
        _HOOK("collective", kind)


class collective_scope:
    """Marks a public collective's body, so that the collectives it calls
    are not counted again."""

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self):
        note_collective(self.kind)
        _TLS.depth = _depth() + 1

    def __exit__(self, *exc):
        _TLS.depth = _depth() - 1


def kernel_call(name: str, arm: str) -> None:
    """One call of a kernel wrapper in `arm`, counted where it would
    launch: on a card it launches, on the CPU its plain version runs."""
    if _HOOK is not None:
        _HOOK("kernel", f"{name}:{arm}")


def set_hook(hook: Optional[Callable[[str, str], None]]) -> None:
    global _HOOK
    _HOOK = hook

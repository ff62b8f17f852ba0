"""Collectives over the shards of one controller (PyTorch).

Counterpart of the `jax.lax` collectives the JAX package's sharded solve
runs inside `shard_map` (`psum`, `psum_scatter`, `ppermute`,
`all_gather`).  Here one Python process drives every shard, as MegBA's
own `cudaSetDevice(i)` loops did, so a collective is a function on a
list of per-shard tensors: each moves its operands with `.to(device)`,
which does nothing when the shards share a device, and sums them in
shard order, one fixed order on the CPU, on one card and on several,
so its result is bitwise repeatable.  A NaN in one shard's operand
reaches every output that sums it, as it does through `jax.lax.psum`.

bf16 payloads (`payload_cast`, SolverOption.bf16_collectives): an
operand cast to bfloat16 is summed in float32 in shard order, and the
sum rounded to bfloat16 once, the value a bfloat16 all-reduce returns;
`up` then restores the compute dtype.

`for_shards` runs one function per shard; while a `ShardLaunches`
context is open it credits each shard with the kernel launches its call
made (read from the wrappers' own `launches` counts, so the kernel layer
knows nothing of shards).

`ppermute` is one hop between two shards; the 2-D S.p product passes the
point shards around the ring of camera columns with it
(solver/pcg.make_matvec_2d).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


def payload_cast(enabled: bool, compute_dtype: torch.dtype = torch.float32
                 ) -> Tuple[Callable, Callable]:
    """(down, up) casts around a collective's payload (JAX
    mesh.collective_payload_cast): bfloat16 on the wire when `enabled`,
    identities otherwise."""
    if not enabled:
        return _identity, _identity

    def down(x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16)

    def up(x: torch.Tensor) -> torch.Tensor:
        return x.to(compute_dtype)

    return down, up


def _identity(x):
    return x


def psum(parts: Sequence[torch.Tensor],
         device: Optional[torch.device] = None) -> torch.Tensor:
    """The sum of the shards' tensors on `device` (default: the first
    shard's), added in shard order.  One part is returned as it is."""
    dev = parts[0].device if device is None else torch.device(device)
    if len(parts) == 1:
        return parts[0].to(dev)
    bf16 = parts[0].dtype == torch.bfloat16
    out = parts[0].to(dev)
    if bf16:
        out = out.float()
    for p in parts[1:]:
        p = p.to(dev)
        out = out + (p.float() if bf16 else p)
    return out.to(torch.bfloat16) if bf16 else out


def psum_groups(parts: Sequence[torch.Tensor],
                groups: Sequence[Sequence[int]],
                devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """`psum` within each group of shard indices: out[g] sums
    parts[i] for i in groups[g], in that order, on devices[g]."""
    return [psum([parts[i] for i in g], d) for g, d in zip(groups, devices)]


def psum_scatter(parts: Sequence[torch.Tensor], num_chunks: int, dim: int,
                 devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """out[c] = the sum over the shards of chunk c of their tensors (equal
    contiguous chunks along `dim`), on devices[c] (`tiled=True`)."""
    size = parts[0].shape[dim] // num_chunks
    return [psum([p.narrow(dim, c * size, size) for p in parts], devices[c])
            for c in range(num_chunks)]


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               device: torch.device) -> torch.Tensor:
    """The shards' tensors concatenated along `dim` in shard order, on
    `device` (`tiled=True`)."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def ppermute(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One hop between two shards: `x` sent to the shard on `device`."""
    return x.to(device)


def per_shard(x, n: int):
    """A per-shard tuple as given, or n Nones for an absent operand."""
    return (None,) * n if x is None else x


class ShardLaunches:
    """Launches per kernel wrapper and shard while the context is open.

    `counts[name][k]` is the number of launches of wrapper `name` made by
    shard k's calls of `for_shards`; the launches made outside any
    `for_shards` (the replicated work, on the first shard's device) are
    shard 0's.  Only the outermost `for_shards` credits a shard."""

    def __init__(self, kernels: Sequence):
        self.kernels = tuple(kernels)
        self.counts: Dict[str, Dict[int, int]] = {
            k.__name__: {} for k in self.kernels}

    def _totals(self) -> List[int]:
        return [k.launches for k in self.kernels]

    def credit(self, shard: int, before: Sequence[int]) -> None:
        for k, b, a in zip(self.kernels, before, self._totals()):
            if a > b:
                per = self.counts[k.__name__]
                per[shard] = per.get(shard, 0) + a - b

    def __enter__(self) -> "ShardLaunches":
        self._start = self._totals()
        _OPEN.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _OPEN.remove(self)
        credited = [sum(self.counts[k.__name__].values())
                    for k in self.kernels]
        self.credit(0, [s + c for s, c in zip(self._start, credited)])


_OPEN: List[ShardLaunches] = []
_depth = 0


def for_shards(fn: Callable, *lists: Sequence) -> list:
    """[fn(*args_k) for each shard k], args_k the k-th entry of each of
    `lists`; each open `ShardLaunches` credits shard k with the launches
    of its call."""
    global _depth
    counters = _OPEN if _depth == 0 else []
    out = []
    _depth += 1
    try:
        for k, args in enumerate(zip(*lists)):
            before = [c._totals() for c in counters]
            out.append(fn(*args))
            for c, b in zip(counters, before):
                c.credit(k, b)
    finally:
        _depth -= 1
    return out

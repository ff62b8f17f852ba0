"""Collectives over the shards of a mesh (PyTorch).

Counterpart of the `jax.lax` collectives the JAX package's sharded solve
runs inside `shard_map` (`psum`, `psum_scatter`, `ppermute`,
`all_gather`).  One Python process drives every shard of its own, as
MegBA's own `cudaSetDevice(i)` loops did, so a collective is a function
on a list of per-shard tensors: each moves its operands with
`.to(device)`, which does nothing when the shards share a device, and
sums them in shard order, one fixed order on the CPU, on one card and on
several, so its result is bitwise repeatable.  A NaN in one shard's
operand reaches every output that sums it, as it does through
`jax.lax.psum`.

A mesh may span OS processes (parallel/multihost.py).  Inside
`mesh_scope(mesh)` of such a mesh, `for_shards` runs only this
process's shards and puts a `REMOTE` placeholder (shaped like the
local outputs: tuples of `REMOTE`, None kept) where another process's
shard would be.  `psum`, `psum_groups`, `psum_scatter` and `all_gather`
then complete the remote parts with ONE cross-process gather
(`torch.distributed.all_gather` over gloo, the parts' bytes staged
through host memory) and fold every part in shard order, on every
process: each process ends with the same bits a one-process mesh of
the same shards computes, so every rank holds the same replicated
state and takes the same decisions.  `dist.all_reduce` is never used:
its summation order depends on its algorithm.  Every summed part has
the same shape, known on every process, so the gathers carry raw bytes
and no pickles.  `ppermute` (the 2-D ring) does not cross processes.

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

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


class _Remote:
    """The placeholder of another process's shard in a per-shard list."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "REMOTE"

    def __reduce__(self):
        return (_Remote, ())


REMOTE = _Remote()


class ProcessLayout:
    """Which process owns each shard of a mesh that spans processes, as
    this process (`rank`) sees it."""

    def __init__(self, owners: Sequence[int], rank: int):
        self.owners = tuple(int(q) for q in owners)
        self.rank = int(rank)
        self.nproc = max(self.owners) + 1
        self.local = tuple(k for k, q in enumerate(self.owners)
                           if q == self.rank)
        if not self.local:
            raise ValueError(f"process {rank} owns no shard of the mesh")
        self.home = self.local[0]
        # Shard k's position among its owner's shards (its slot in the
        # owner's gather payload), and each process's shard count.
        self.slot = [0] * len(self.owners)
        self.counts = [0] * self.nproc
        for k, q in enumerate(self.owners):
            self.slot[k] = self.counts[q]
            self.counts[q] += 1


_tls = threading.local()


def process_layout() -> Optional[ProcessLayout]:
    """The layout of the multi-process mesh whose scope is open on this
    thread, or None (every shard is this process's)."""
    return getattr(_tls, "layout", None)


@contextlib.contextmanager
def mesh_scope(mesh):
    """Run the collectives of this thread over `mesh`: a mesh that spans
    processes (`mesh.processes`) makes `for_shards` run this process's
    shards alone and the sums gather the others' parts; any other mesh
    leaves every shard local.  Re-entrant; per thread, so a dispatch
    thread abandoned inside a gather (robustness/elastic) leaves no
    layout behind for the next solve."""
    procs = getattr(mesh, "processes", ())
    layout = (ProcessLayout(procs, mesh.process)
              if len(set(procs)) > 1 else None)
    prev = process_layout()
    _tls.layout = layout
    try:
        yield layout
    finally:
        _tls.layout = prev


# Cross-process gathers: count, bytes received from other processes and
# host seconds, for a rank's per-iteration figures (chip_smoke.py).
_GATHERS = {"gathers": 0, "bytes": 0, "seconds": 0.0}


def gather_stats() -> Dict[str, float]:
    """The cross-process gathers made since the last reset."""
    return dict(_GATHERS)


def reset_gather_stats() -> None:
    _GATHERS.update(gathers=0, bytes=0, seconds=0.0)


def _complete(parts: Sequence) -> list:
    """`parts` with every `REMOTE` part replaced by its owner's tensor,
    through one all_gather of the processes' local parts as raw bytes;
    the remote parts land on the device of this process's first part.
    A list with no remote part is returned as it is."""
    layout = process_layout()
    if layout is None or not any(p is REMOTE for p in parts):
        return list(parts)
    import torch.distributed as dist

    if len(parts) != len(layout.owners):
        raise ValueError(f"{len(parts)} parts for a mesh of "
                         f"{len(layout.owners)} shards")
    t0 = time.perf_counter()
    local = [parts[k] for k in layout.local]
    first = local[0]
    dev, dtype, shape = first.device, first.dtype, first.shape
    nbytes = first.numel() * first.element_size()
    width = max(layout.counts) * nbytes
    # Host staging: gloo moves host memory; the copy also orders the
    # gather after the parts' device work.
    send = torch.zeros(width, dtype=torch.uint8)
    for j, p in enumerate(local):
        if p.shape != shape or p.dtype != dtype:
            raise ValueError("psum parts differ in shape or dtype")
        send[j * nbytes:(j + 1) * nbytes] = (
            p.detach().contiguous().reshape(-1).cpu().view(torch.uint8))
    recv = [torch.empty(width, dtype=torch.uint8)
            for _ in range(layout.nproc)]
    dist.all_gather(recv, send)
    out = list(parts)
    for k, q in enumerate(layout.owners):
        if q != layout.rank:
            at = layout.slot[k] * nbytes
            out[k] = recv[q][at:at + nbytes].view(dtype).reshape(
                shape).to(dev)
    _GATHERS["gathers"] += 1
    _GATHERS["bytes"] += width * (layout.nproc - 1)
    _GATHERS["seconds"] += time.perf_counter() - t0
    return out


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
    shard's, or on a mesh across processes this process's first), added
    in shard order.  One part is returned as it is."""
    parts = _complete(parts)
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
    parts = _complete(parts)
    return [psum([parts[i] for i in g], d) for g, d in zip(groups, devices)]


def psum_scatter(parts: Sequence[torch.Tensor], num_chunks: int, dim: int,
                 devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """out[c] = the sum over the shards of chunk c of their tensors (equal
    contiguous chunks along `dim`), on devices[c] (`tiled=True`)."""
    parts = _complete(parts)
    size = parts[0].shape[dim] // num_chunks
    return [psum([p.narrow(dim, c * size, size) for p in parts], devices[c])
            for c in range(num_chunks)]


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               device: torch.device) -> torch.Tensor:
    """The shards' tensors concatenated along `dim` in shard order, on
    `device` (`tiled=True`).  Every part has one shape, as under
    `jax.lax.all_gather`."""
    parts = _complete(parts)
    return torch.cat([p.to(device) for p in parts], dim=dim)


def ppermute(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One hop between two shards: `x` sent to the shard on `device`.
    Within one process only: a hop between processes would be a
    point-to-point send, which the port does not make."""
    if process_layout() is not None:
        raise NotImplementedError(
            "ppermute between processes is not implemented (the 2-D "
            "mesh's ring); a mesh across processes runs the 1-D lowering")
    return x.to(device)


def per_shard(x, n: int):
    """A per-shard tuple as given, or n Nones for an absent operand."""
    return (None,) * n if x is None else x


class ShardLaunches:
    """Launches per kernel wrapper and shard while the context is open.

    `counts[name][k]` is the number of launches of wrapper `name` made by
    shard k's calls of `for_shards`; the launches made outside any
    `for_shards` (the replicated work, on the first shard's device, or
    this process's first on a mesh across processes) are that shard's.
    Only the outermost `for_shards` credits a shard."""

    def __init__(self, kernels: Sequence):
        self.kernels = tuple(kernels)
        self.home = 0
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
        self.credit(self.home,
                    [s + c for s, c in zip(self._start, credited)])


_OPEN: List[ShardLaunches] = []
_depth = 0


def _mirror(out):
    """The placeholder of a remote shard's output, shaped like a local
    one: tuples and lists of placeholders, None kept."""
    if out is None:
        return None
    if isinstance(out, tuple) and hasattr(out, "_fields"):
        return type(out)(*(_mirror(x) for x in out))
    if isinstance(out, (tuple, list)):
        return type(out)(_mirror(x) for x in out)
    return REMOTE


def for_shards(fn: Callable, *lists: Sequence) -> list:
    """[fn(*args_k) for each shard k], args_k the k-th entry of each of
    `lists`; each open `ShardLaunches` credits shard k with the launches
    of its call.  Inside the `mesh_scope` of a mesh across processes only
    this process's shards run, and another's entry is the placeholder of
    its output (`_mirror`)."""
    global _depth
    layout = process_layout()
    counters = _OPEN if _depth == 0 else []
    if layout is not None:
        for c in counters:
            c.home = layout.home
    out = []
    _depth += 1
    try:
        for k, args in enumerate(zip(*lists)):
            if layout is not None and layout.owners[k] != layout.rank:
                out.append(REMOTE)
                continue
            before = [c._totals() for c in counters]
            out.append(fn(*args))
            for c, b in zip(counters, before):
                c.credit(k, b)
    finally:
        _depth -= 1
    if layout is not None:
        placeholder = _mirror(out[layout.home])
        out = [placeholder if layout.owners[k] != layout.rank else o
               for k, o in enumerate(out)]
    return out

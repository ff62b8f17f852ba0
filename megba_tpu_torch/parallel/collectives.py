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
and no pickles.  A sum within subgroups (`psum_groups`, the grouped
`psum_scatter`) completes the whole mesh's list with one gather, so a
process receives parts it does not sum: correct, and counted in
`gather_stats`.  `ppermute` (the 2-D ring) crosses processes with
point-to-point sends of a shard's bytes (`isend` / `irecv`).

bf16 payloads (`payload_cast`, SolverOption.bf16_collectives): an
operand cast to bfloat16 is summed in float32 in shard order, and the
sum rounded to bfloat16 once, the value a bfloat16 all-reduce returns;
`up` then restores the compute dtype.

`for_shards` runs one function per shard; while a `ShardLaunches`
context is open it credits each shard with the kernel launches its call
made (read from the wrappers' own `launches` counts, so the kernel layer
knows nothing of shards).

`ppermute` makes one step of hops between shards; the 2-D S.p product
passes the point shards around the ring of camera columns with it
(solver/pcg.make_matvec_2d).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from megba_tpu_torch.analysis.census import collective_scope
from megba_tpu_torch.utils.timing import monotonic_s


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


# Cross-process traffic: the gathers (count, bytes received from other
# processes, host seconds) and the ring's hops between processes (the
# same three), for a rank's per-iteration figures (chip_smoke.py).
_GATHERS = {"gathers": 0, "bytes": 0, "seconds": 0.0,
            "hops": 0, "hop_bytes": 0, "hop_seconds": 0.0}


def gather_stats() -> Dict[str, float]:
    """The cross-process gathers and hops made since the last reset."""
    return dict(_GATHERS)


def reset_gather_stats() -> None:
    _GATHERS.update(gathers=0, bytes=0, seconds=0.0, hops=0, hop_bytes=0,
                    hop_seconds=0.0)


def _meta(parts: Sequence, like) -> Tuple[torch.device, torch.dtype,
                                          torch.Size]:
    """(device, dtype, shape) of the first part this process holds, or of
    `like` = (shape, dtype) (device: the CPU) when it holds none."""
    for p in parts:
        if p is not REMOTE and p is not None:
            return p.device, p.dtype, p.shape
    if like is None:
        raise ValueError(
            "this process holds no part of the group: pass like=(shape, "
            "dtype) so its buffers can be sized")
    return torch.device("cpu"), like[1], torch.Size(like[0])


def _to_bytes(p: torch.Tensor) -> torch.Tensor:
    """A part's raw bytes on the host (gloo moves host memory; the copy
    also orders the exchange after the part's device work)."""
    return p.detach().contiguous().reshape(-1).cpu().view(torch.uint8)


def _complete(parts: Sequence, shards: Optional[Sequence[int]] = None,
              like=None) -> list:
    """`parts` with every `REMOTE` part replaced by its owner's tensor,
    through one all_gather of the processes' parts as raw bytes.

    `parts[j]` is shard `shards[j]`'s; `shards` defaults to the whole
    mesh, and then a list that holds no remote part (one already
    completed, as a sum's inner calls pass it) is returned as it is.
    Every process calls the gather with the same `shards`, including a
    process that owns none of them, which sends an empty payload and
    sizes its buffers from `like` = (shape, dtype).  The remote parts
    land on the device of this process's first part of the list (the
    CPU if it has none)."""
    layout = process_layout()
    if layout is None:
        return list(parts)
    if shards is None:
        if not any(p is REMOTE for p in parts):
            return list(parts)
        shards = range(len(layout.owners))
    shards = [int(k) for k in shards]
    if len(shards) != len(parts):
        raise ValueError(f"{len(parts)} parts for {len(shards)} shards")
    import torch.distributed as dist

    t0 = monotonic_s()
    dev, dtype, shape = _meta(parts, like)
    nbytes = shape.numel() * torch.empty((), dtype=dtype).element_size()
    owners = [layout.owners[k] for k in shards]
    counts = [owners.count(q) for q in range(layout.nproc)]
    width = max(counts) * nbytes
    send = torch.zeros(width, dtype=torch.uint8)
    j = 0
    for p, q in zip(parts, owners):
        if q != layout.rank:
            continue
        if p.shape != shape or p.dtype != dtype:
            raise ValueError("psum parts differ in shape or dtype")
        send[j * nbytes:(j + 1) * nbytes] = _to_bytes(p)
        j += 1
    recv = [torch.empty(width, dtype=torch.uint8)
            for _ in range(layout.nproc)]
    dist.all_gather(recv, send)
    out = list(parts)
    slot = [0] * layout.nproc
    for i, q in enumerate(owners):
        at = slot[q] * nbytes
        slot[q] += 1
        if q != layout.rank:
            out[i] = recv[q][at:at + nbytes].view(dtype).reshape(
                shape).to(dev)
    _GATHERS["gathers"] += 1
    _GATHERS["bytes"] += width * (layout.nproc - 1)
    _GATHERS["seconds"] += monotonic_s() - t0
    return out


def _collective(kind: str):
    """Count each outermost call of a public collective in the census
    (analysis/program_audit.py) as `kind`."""
    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            with collective_scope(kind):
                return fn(*args, **kwargs)
        return counted
    return wrap


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


@_collective("psum")
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


def _remote_device(d) -> bool:
    """Whether an output device names another process's shard (None on
    a mesh across processes): its output is `REMOTE`, not computed."""
    return d is None and process_layout() is not None


@_collective("psum_groups")
def psum_groups(parts: Sequence[torch.Tensor],
                groups: Sequence[Sequence[int]],
                devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """`psum` within each group of shard indices: out[g] sums
    parts[i] for i in groups[g], in that order, on devices[g].  `parts`
    is the whole mesh's list (one gather across processes completes it
    for every group); a group whose device is another process's
    (None) gives `REMOTE`."""
    parts = _complete(parts)
    return [REMOTE if _remote_device(d) else psum([parts[i] for i in g], d)
            for g, d in zip(groups, devices)]


@_collective("psum_scatter")
def psum_scatter(parts: Sequence[torch.Tensor], num_chunks: int, dim: int,
                 devices: Sequence[torch.device],
                 groups: Optional[Sequence[Sequence[int]]] = None
                 ) -> List[torch.Tensor]:
    """A reduce-scatter within each group of shard indices (`tiled=True`):
    out[g[c]] sums chunk c (equal contiguous chunks along `dim`) of the
    tensors of the shards of g, on devices[g[c]], for c < `num_chunks`.
    `groups` defaults to the whole mesh as one group, so out[c] sums
    chunk c over every shard; the 2-D mesh's camera-axis scatter passes
    its rows, each of `num_chunks` shards, and then `parts`, `devices`
    and the result are the whole mesh's lists.  One gather across
    processes completes `parts` for every group; an output on another
    process's shard (device None) is `REMOTE`."""
    parts = _complete(parts)
    size = parts[0].shape[dim] // num_chunks
    out = [REMOTE] * len(devices)
    for g in ([range(len(parts))] if groups is None else groups):
        for c in range(num_chunks):
            k = g[c]
            if not _remote_device(devices[k]):
                out[k] = psum([parts[i].narrow(dim, c * size, size)
                               for i in g], devices[k])
    return out


@_collective("all_gather")
def all_gather(parts: Sequence[torch.Tensor], dim: int,
               device: torch.device, shards: Optional[Sequence[int]] = None,
               like=None) -> torch.Tensor:
    """The shards' tensors concatenated along `dim` in shard order, on
    `device` (`tiled=True`).  Every part has one shape, as under
    `jax.lax.all_gather`.  `shards` names the shard of each part when
    `parts` is a subgroup's (across processes, `like` = (shape, dtype)
    sizes the buffers of a process that holds none of them)."""
    parts = _complete(parts, shards, like)
    return torch.cat([p.to(device) for p in parts], dim=dim)


@_collective("ppermute")
def ppermute(parts: Sequence, perm: Sequence[Tuple[int, int]],
             devices: Sequence[torch.device], like=None) -> list:
    """Hops between shards (`jax.lax.ppermute`): out[dst] = parts[src] on
    devices[dst] for each (src, dst) of `perm`, None where no hop lands.

    `parts` and the result are the whole mesh's lists.  A hop inside one
    process is `.to(device)`.  Across processes every process walks
    `perm` in the same order: the owner of `src` sends the part's raw
    bytes (staged through host memory, as `_complete` stages them) and
    the owner of `dst` receives them into a buffer sized from the part's
    known shape and dtype (a local part's, or `like` = (shape, dtype));
    all of one call's sends and receives are posted together and then
    waited on, so a ring whose every hop crosses cannot deadlock.  A hop
    that lands on another process's shard gives `REMOTE`."""
    layout = process_layout()
    out: list = [None] * len(devices)
    if layout is None:
        for s, t in perm:
            out[t] = parts[s].to(devices[t])
        return out
    import torch.distributed as dist

    t0 = monotonic_s()
    _, dtype, shape = _meta(parts, like)
    nbytes = shape.numel() * torch.empty((), dtype=dtype).element_size()
    works, recvs, keep = [], [], []
    for j, (s, t) in enumerate(perm):
        src, dst = layout.owners[s], layout.owners[t]
        if src == layout.rank and dst == layout.rank:
            out[t] = parts[s].to(devices[t])
        elif src == layout.rank:
            buf = _to_bytes(parts[s])
            keep.append(buf)
            works.append(dist.isend(buf, dst, tag=j))
        elif dst == layout.rank:
            buf = torch.empty(nbytes, dtype=torch.uint8)
            works.append(dist.irecv(buf, src, tag=j))
            recvs.append((t, buf))
        else:
            out[t] = REMOTE
    for w in works:
        w.wait()
    for t, buf in recvs:
        out[t] = buf.view(dtype).reshape(shape).to(devices[t])
    if works:
        _GATHERS["hops"] += len(works)
        _GATHERS["hop_bytes"] += nbytes * len(recvs)
        _GATHERS["hop_seconds"] += monotonic_s() - t0
    return out


def per_shard(x, n: int):
    """A per-shard tuple as given, or n Nones for an absent operand."""
    return (None,) * n if x is None else x


class ShardLaunches:
    """Launches per kernel wrapper and shard while the context is open.

    `counts[name][k]` is the number of launches of wrapper `name` made by
    shard k's calls of `for_shards`; the launches made outside any
    `for_shards` (the replicated work, on the first shard's device, or
    this process's first on a mesh across processes) are that shard's,
    and `replicated` holds them apart once the context has closed.  Only
    the outermost `for_shards` credits a shard."""

    def __init__(self, kernels: Sequence):
        self.kernels = tuple(kernels)
        self.home = 0
        self.counts: Dict[str, Dict[int, int]] = {
            k.__name__: {} for k in self.kernels}
        self.replicated: Dict[str, int] = {}

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
        before = [s + c for s, c in zip(self._start, credited)]
        # The replicated work's launches, credited to the home shard.
        self.replicated = {k.__name__: a - b for k, b, a in zip(
            self.kernels, before, self._totals()) if a > b}
        self.credit(self.home, before)


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

"""Multi-process runtime over torch.distributed.

Counterpart of `megba_tpu/parallel/multihost.py`, with its names.  MegBA
itself ran one process (a single-process `ncclCommInitAll`).  Here
several OS processes join one gloo process group through
`initialize_multihost`; a solve of `world_size` N > 1 then builds its
1-D mesh, or with `SolverOption.mesh_2d` its 2-D mesh, across them
(parallel/mesh.make_process_mesh: each process
gives its own devices, shards in rank order), every process runs the
same host prep on the full problem, lowers only its own shards, and
holds the replicated state on its first local device.  The sums
complete the other processes' parts with one all_gather each and fold
them in shard order (parallel/collectives.py), so a world-N solve over
P processes is bitwise the one-process world-N solve.

The backend is gloo, on the CPU and on the card alike: NCCL takes one
rank per card, and a host with one card runs every rank on it.  gloo
moves host memory, so the gathered parts are staged through the host
(`tensor.cpu()`) and moved back to the device.

Probed teardown behaviour (torch 2.13, gloo, a peer SIGKILLed mid-run):
a collective raises `RuntimeError` ("Connection closed by peer") within
milliseconds; `destroy_process_group` returns at once, even while
another thread is parked in a collective of the group (that thread
raises when the group's timeout ends); a new group can be initialised
after it.  A barrier raises at once on a dead peer and waits out the
group timeout on a hung one.  So `shutdown_multihost` runs its
cooperative barrier on a helper thread bounded by `timeout_s`, the
abandon mode runs none, and neither waits on a peer; `PG_TIMEOUT_S`
bounds every collective of the group.
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# Every collective of the process group raises after this many seconds
# with a peer that neither answers nor dies (a dead peer raises at
# once).
PG_TIMEOUT_S = 120.0
# How long a rank waits for the rendezvous store and its peers to join.
RENDEZVOUS_TIMEOUT_S = 300.0

# The parameters this module initialised the process group with (None
# until it did): repeat calls with them are idempotent.  Reset by
# `shutdown_multihost`, which is what makes a later initialisation at
# another world size legal (the elastic shrink-world path).
_initialized_with: Optional[Tuple] = None
# The summary of the group this module initialised, and the rendezvous
# store it holds (a client, or the master on rank 0 of a non-elastic
# world).
_info: Optional[dict] = None
_store = None


def _distributed_is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _split_address(address: str) -> Tuple[str, int]:
    host, _, port = str(address).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"coordinator_address must be host:port, got {address!r}")
    return host.strip("[]"), int(port)


def _make_store(host: str, port: int, num_processes: int,
                is_master: bool):
    """The rendezvous store: the master binds `port` (0: a free port),
    a client connects to it."""
    return dist.TCPStore(
        host, int(port), int(num_processes), is_master,
        timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S),
        wait_for_workers=False)


def _init_group(store, num_processes: int, process_id: int) -> None:
    dist.init_process_group(
        "gloo", store=store, rank=int(process_id),
        world_size=int(num_processes),
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))


def _local_device_count() -> int:
    """This process's devices: its visible cards, or the CPU as one."""
    if torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def _gather_counts(n: int) -> list:
    """Every process's `n`, in rank order (one all_gather)."""
    out = [torch.zeros(1, dtype=torch.int64)
           for _ in range(dist.get_world_size())]
    dist.all_gather(out, torch.tensor([int(n)], dtype=torch.int64))
    return [int(c) for c in out]


def _summary() -> dict:
    if not _distributed_is_initialized():
        n = _local_device_count()
        return {"process_index": 0, "process_count": 1,
                "local_devices": n, "global_devices": n,
                "backend": None}
    n = _local_device_count()
    return {"process_index": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "local_devices": n,
            "global_devices": sum(_gather_counts(n)),
            "backend": dist.get_backend()}


def serve_rendezvous(port: int, num_processes: int, block: bool = True):
    """Host the rendezvous store as a process of its own.

    Elastic worlds keep the rendezvous out of the solver ranks, as the
    JAX package does (its coordination service): a rank that hosts it
    takes the store down with it when it dies, and the survivors could
    not form a new group.  A sacrificial rendezvous process owns it
    instead; the harness SIGKILLs it when the world is done.  Port 0
    binds a free port; the line printed names the port bound, which the
    ranks then dial.  Run via
    `python -m megba_tpu_torch.parallel.multihost --serve <port> <world>`.
    """
    store = _make_store("0.0.0.0", port, num_processes, True)
    print(f"rendezvous serving {num_processes} processes on port "
          f"{store.port}", flush=True)
    if block:
        import time

        while True:  # killed, never joined
            time.sleep(3600)
    return store


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    elastic: bool = False,
) -> dict:
    """Join this process to a gloo process group (idempotent).

    `coordinator_address` ("host:port") names the rendezvous store.  In
    a plain world, process 0 hosts it, as the JAX package's process 0
    hosts its coordinator (port 0 binds a free port and prints it as
    `rendezvous serving N processes on port P`); with `elastic=True`
    the store is external (`serve_rendezvous`) and every rank is a
    client, and all three parameters are required.  With no arguments
    the torch launcher's environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK) is used if present, else the process stays alone.
    Returns {process_index, process_count, local_devices,
    global_devices, backend}.

    An exact repeat of the parameters returns the same summary; other
    parameters raise until `shutdown_multihost` runs, after which a
    process may initialise again, with other parameters too (the
    shrink-world resume).  Every collective of the group is bounded by
    `PG_TIMEOUT_S`.
    """
    global _initialized_with, _info, _store
    initialized = _distributed_is_initialized()
    explicit = any(a is not None
                   for a in (coordinator_address, num_processes, process_id))
    params = (coordinator_address, num_processes, process_id, bool(elastic))
    if initialized:
        # Idempotent on an exact repeat of OUR parameters; anything else
        # (other parameters, or a group this module did not make) cannot
        # be applied, and ignoring it would leave hosts solving alone.
        if explicit and params != _initialized_with:
            raise RuntimeError(
                "torch.distributed is already initialized with different "
                "parameters; call shutdown_multihost() before "
                "re-initializing, or initialize_multihost before any "
                "other torch.distributed use")
        if _info is None:
            _info = _summary()
        return dict(_info)
    if elastic and (not explicit or None in (coordinator_address,
                                             num_processes, process_id)):
        raise ValueError(
            "elastic=True requires explicit coordinator_address / "
            "num_processes / process_id (the rendezvous process is "
            "external; there is no auto-detection)")
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "initialize_multihost needs coordinator_address, "
                "num_processes and process_id together")
        host, port = _split_address(coordinator_address)
        master = not elastic and int(process_id) == 0
        store = _make_store(host, port, num_processes, master)
        if master and port == 0:
            print(f"rendezvous serving {num_processes} processes on port "
                  f"{store.port}", flush=True)
        _init_group(store, num_processes, process_id)
        _store = store
        _initialized_with = params
    elif all(k in os.environ
             for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
        dist.init_process_group(
            "gloo", init_method="env://",
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        _initialized_with = params
    _info = _summary()
    return dict(_info)


def shutdown_multihost(abandon: bool = False, timeout_s: float = 5.0) -> bool:
    """Tear down the process group so a new initialisation is legal.

    Returns True when a group was torn down.  Two modes:

    - **Cooperative** (default): every rank calls this; a barrier runs
      on a helper thread, and this call waits for it at most
      `timeout_s` (a peer that died on the way out would hold it), then
      destroys the group either way.
    - **Abandon** (`abandon=True`): peers are presumed dead, and no
      collective runs; the group is destroyed at once.

    `destroy_process_group` returns at once even with a dead peer or a
    thread parked in a collective (module docstring), so neither mode
    blocks on a peer.  Either way the record of the parameters is
    cleared: a later `initialize_multihost`, with the same parameters
    or others, is legal.
    """
    global _initialized_with, _info, _store
    was_initialized = _distributed_is_initialized()
    _initialized_with = None
    _info = None
    if not was_initialized:
        _store = None
        return False
    if not abandon:
        done = threading.Event()

        def _graceful():
            try:
                dist.barrier()
            except Exception:
                pass  # destroyed below either way
            finally:
                done.set()

        threading.Thread(target=_graceful, daemon=True,
                         name="multihost-shutdown").start()
        done.wait(timeout_s)
    dist.destroy_process_group()
    _store = None
    return True


def cpu_cross_process_collectives_available() -> bool:
    """Can this torch run cross-process collectives on host tensors?
    True when torch.distributed has the gloo backend (the port's one
    backend; tests skip their multi-process lanes without it)."""
    return dist.is_available() and dist.is_gloo_available()


def enable_cpu_cross_process_collectives() -> bool:
    """Select gloo for cross-process sums (JAX's jaxlib switch).  The
    port's process group is always gloo, so this only reports whether
    gloo is there; it changes nothing."""
    return cpu_cross_process_collectives_available()


def mesh_is_multiprocess(mesh) -> bool:
    """True when the mesh's shards span more than one OS process."""
    return len(set(getattr(mesh, "processes", ()))) > 1


def _lift(x, device):
    """Host arrays and tensors (and tuples / lists of them) on `device`."""
    import numpy as np

    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return type(x)(_lift(v, device) for v in x)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


def globalize_for_mesh(mesh, x, spec):
    """Lower one operand for a mesh, this process's part of it.

    `spec` None: a replicated value, lifted to the home device (this
    process's first).  `spec` = parallel.mesh.EDGE_AXIS: a per-shard
    operand, `x` a sequence of the shards' values or a callable `k ->`
    shard k's value; each shard this process owns is lifted to its
    device, another process's is None (and a callable is never asked
    for it).  Every process holds the full host problem (the
    multi-process contract of flat_solve / solve_pgo), so each can take
    exactly the shards its devices own.  Values may be host arrays,
    tensors or tuples / lists of them.
    """
    if x is None:
        return None
    if spec is None:
        return _lift(x, mesh.home_device)
    local = set(mesh.local_shards)
    get = x if callable(x) else (lambda k: x[k])
    return tuple(_lift(get(k), d) if k in local else None
                 for k, d in enumerate(mesh.devices))


def dispatch_on_mesh(prog, mesh):
    """Run `prog()`, a mesh program whose operands were lowered for the
    mesh (`globalize_for_mesh`), inside the mesh's collective scope
    (parallel/collectives.mesh_scope) and, on a card, with this
    process's home card current.  The one dispatch sequence of both
    solver families (parallel/mesh.distributed_lm_solve and
    models/pgo)."""
    from megba_tpu_torch.parallel.collectives import mesh_scope

    home = mesh.home_device
    with mesh_scope(mesh):
        if home.type == "cuda":
            with torch.cuda.device(home):
                return prog()
        return prog()


def _main(argv=None) -> int:
    """CLI: `python -m megba_tpu_torch.parallel.multihost --serve <port>
    <world>` runs the rendezvous process of a world (port 0: a free
    one, printed); SIGKILL it when the world is done."""
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) == 3 and argv[0] == "--serve":
        serve_rendezvous(int(argv[1]), int(argv[2]))
        return 0
    print("usage: python -m megba_tpu_torch.parallel.multihost "
          "--serve <port> <num_processes>")
    return 2


if __name__ == "__main__":
    raise SystemExit(_main())

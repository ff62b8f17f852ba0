"""Device mesh and the edge-sharded LM solve (PyTorch).

Counterpart of `megba_tpu/parallel/mesh.py`.  The JAX package runs one
SPMD program over a `jax.sharding.Mesh` with `shard_map`; MegBA, its
model, ran one process with `cudaSetDevice(i)` loops.  The port does the
latter: one controller drives N shards, each a device of a `Mesh`.  The
device list may repeat a device, so N shards can share one card (or the
CPU), as the JAX package's tests run N virtual CPU devices.

Where state lives:

- per shard, on its device: the edge arrays of a contiguous piece of the
  camera-sorted edge stream, its dual plans over all global vertices, its
  residuals and Jacobians (and W), its halves of the Schur build, of the
  coupling products, of the cost and J.dx sums and of the preconditioner
  builds' edge sums;
- once, on the first shard's device: the parameters, the Hessian block
  diagonals and gradient, the PCG vectors and scalars, the
  preconditioner and the LM scalars, which the JAX package replicates on
  every device.

One device is the mesh of one shard (`one_shard`): every layer runs the
same code at every world size, and a sum over one shard is its part.

Every sum across the shards runs through `parallel.collectives`, in
shard order.  On the 2-D camera x edge mesh (`make_mesh_2d`, shard
e * C + c is device (e, c)) the S.p product's sums are scoped to the
edge and camera subgroups and the point shards pass around a ring
over the camera columns (solver/pcg.make_matvec_2d).  The column's
summed point shard, its Hll^-1 product and its camera reduction are held
on device (0, c), the first of the column, where the JAX package's
subgroup psums leave a copy on every device of the subgroup.

A mesh may span OS processes (`make_process_mesh`, once
parallel/multihost.initialize_multihost has joined them): shards in
process rank order, as `jax.devices()` orders a multi-host mesh, each
process holding its own shards' devices and None for the others'
(`Mesh.processes` names each shard's owner).  Every process runs the
same host prep on the full problem, lowers only its own shards, and
keeps the replicated state on its first local device (`home_device`);
the sums gather the other processes' parts (parallel/collectives.py).
The 2-D mesh does not span processes.  Between cards of one process
there is no NCCL route: the collectives move tensors with `.to(device)`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from megba_tpu_torch.core.types import pad_edges
from megba_tpu_torch.ops.segtiles import DeviceCameraTilePlan, DualPlans

EDGE_AXIS = "edges"
# The second axis of the 2-D mesh: camera blocks (JAX mesh.py CAM_AXIS).
CAM_AXIS = "cams"

DeviceSpec = Union[None, str, torch.device, Sequence]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """N devices, one per shard, in device-block order: on the 2-D mesh
    shard e * cam_blocks + c is device (e, c).  A device may repeat.

    Across processes, `processes[k]` is the rank that owns shard k,
    `process` is this process's rank, and `devices[k]` is None for a
    shard of another process; one process leaves `processes` empty."""

    devices: Tuple[Optional[torch.device], ...]
    shape: Tuple[int, ...]  # (E,) or (E, C)
    axis_names: Tuple[str, ...]
    processes: Tuple[int, ...] = ()
    process: int = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def is_multiprocess(self) -> bool:
        return len(set(self.processes)) > 1

    @property
    def local_shards(self) -> Tuple[int, ...]:
        """The shards this process owns, in shard order."""
        if not self.processes:
            return tuple(range(self.size))
        return tuple(k for k, q in enumerate(self.processes)
                     if q == self.process)

    @property
    def home(self) -> int:
        """The shard whose device holds the replicated state: the first,
        or this process's first across processes."""
        return self.local_shards[0]

    @property
    def home_device(self) -> torch.device:
        return self.devices[self.home]

    @property
    def is_2d(self) -> bool:
        return len(self.axis_names) > 1

    @property
    def edge_shards(self) -> int:
        return self.shape[0]

    @property
    def cam_blocks(self) -> int:
        return self.shape[1] if self.is_2d else 1

    def axis_groups(self, axis: str):
        """The shard groups a collective over one axis reduces within:
        over EDGE_AXIS one group per camera column c (shards e*C + c for
        every e), over CAM_AXIS one per edge shard e."""
        E, C = self.edge_shards, self.cam_blocks
        if axis == EDGE_AXIS:
            return [[e * C + c for e in range(E)] for c in range(C)]
        if axis == CAM_AXIS:
            return [[e * C + c for c in range(C)] for e in range(E)]
        raise ValueError(f"unknown mesh axis {axis!r}")


@dataclasses.dataclass(frozen=True)
class ShardedPlans:
    """The per-shard dual plans of a solve over a mesh.

    `shards[k]` plans shard k's edges on `mesh.devices[k]` over ALL
    global segments (every camera and every point), so the shards'
    per-vertex outputs line up for the sum.  On the 2-D camera x edge
    mesh `tile_plan` carries the ring step's buckets."""

    mesh: Mesh
    shards: Tuple[DualPlans, ...]
    tile_plan: Optional[DeviceCameraTilePlan] = None

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return self.mesh.devices


def one_shard(plans: DualPlans) -> ShardedPlans:
    """One device's plans as the single shard of a one-device mesh."""
    dev = plans.cam.seg.device
    return ShardedPlans(mesh=Mesh(devices=(dev,), shape=(1,),
                                  axis_names=(EDGE_AXIS,)),
                        shards=(plans,))


def mesh_axes(mesh: Mesh):
    """The axis names of a mesh: the edge axis of the 1-D mesh, the
    (edge, camera) pair of the 2-D one (JAX mesh.py:111)."""
    return mesh.axis_names if mesh.is_2d else mesh.axis_names[0]


def factor_mesh_2d(world_size: int, cam_blocks: int = 0) -> Tuple[int, int]:
    """(edge_shards, cam_blocks) of a 2-D mesh of `world_size` devices
    (JAX mesh.py:122): `cam_blocks` > 0 must divide world_size; 0 takes
    the largest divisor <= sqrt(world_size)."""
    world_size = int(world_size)
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    cam_blocks = int(cam_blocks)
    if cam_blocks > 0:
        if world_size % cam_blocks or cam_blocks > world_size:
            raise ValueError(
                f"cam_blocks={cam_blocks} does not factor "
                f"world_size={world_size} into edge_shards x cam_blocks")
        return world_size // cam_blocks, cam_blocks
    c = 1
    d = 1
    while d * d <= world_size:
        if world_size % d == 0:
            c = d
        d += 1
    return world_size // c, c


def nearest_cam_blocks(world_size: int, cam_blocks: int) -> int:
    """The largest feasible cam_blocks <= the requested one for this
    world (JAX mesh.py:148)."""
    world_size = int(world_size)
    cam_blocks = max(1, int(cam_blocks))
    best = 1
    for c in range(1, min(cam_blocks, world_size) + 1):
        if world_size % c == 0:
            best = c
    return best


_LOCAL_ONLY = [0]
_LOCAL_ONLY_LOCK = threading.Lock()


@contextlib.contextmanager
def local_devices_only():
    """Build meshes from this process's devices alone while open (JAX
    mesh.py:196): the shrink-world resume (robustness/elastic.
    resume_elastic) re-lowers on the survivor's devices, never a lost
    peer's.  Re-entrant, and process-wide: a solve dispatched on another
    thread inside the scope sees it too."""
    with _LOCAL_ONLY_LOCK:
        _LOCAL_ONLY[0] += 1
    try:
        yield
    finally:
        with _LOCAL_ONLY_LOCK:
            _LOCAL_ONLY[0] -= 1


def local_only_active() -> bool:
    return _LOCAL_ONLY[0] > 0


def multiprocess_active() -> bool:
    """Whether a mesh of more than one shard spans processes here: a
    process group of more than one rank is up (parallel/multihost) and
    no `local_devices_only` scope is open."""
    if local_only_active():
        return False
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _local_devices(devices: DeviceSpec, default: str) -> Tuple[torch.device,
                                                                ...]:
    """This process's devices of a mesh across processes: one device
    (one shard), a sequence (one shard each), or None: this process's
    visible cards (`default="cpu"`: one CPU shard)."""
    if devices is None:
        if default == "cpu":
            return (torch.device("cpu"),)
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "megba_tpu_torch: no CUDA device is available in this "
                "process; pass device='cpu' to run its shard on the CPU")
        return tuple(torch.device("cuda", i) for i in range(n))
    if isinstance(devices, (str, torch.device)):
        devices = (devices,)
    return resolve_devices(len(devices), devices)


def make_process_mesh(world_size: int, devices: DeviceSpec = None,
                      default: str = "cuda") -> Mesh:
    """The 1-D mesh of `world_size` shards across the processes of the
    process group: each process gives its own devices (`devices`, one
    shard each; see `_local_devices`), the processes' shard counts are
    gathered (one small all_gather, every process calls this), and the
    shards follow in process rank order.  The counts must add up to
    `world_size`."""
    import torch.distributed as dist

    local = _local_devices(devices, default)
    nproc, rank = dist.get_world_size(), dist.get_rank()
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(nproc)]
    dist.all_gather(counts, torch.tensor([len(local)], dtype=torch.int64))
    counts = [int(c) for c in counts]
    if sum(counts) != int(world_size):
        raise ValueError(
            f"world_size {world_size} over {nproc} processes that hold "
            f"{counts} devices ({sum(counts)} in all): each process passes "
            "its own devices, one shard each")
    owners = tuple(q for q, c in enumerate(counts) for _ in range(c))
    it = iter(local)
    devs = tuple(next(it) if q == rank else None for q in owners)
    return Mesh(devices=devs, shape=(len(devs),), axis_names=(EDGE_AXIS,),
                processes=owners, process=rank)


def resolve_devices(world_size: int, devices: DeviceSpec = None,
                    default: str = "cuda") -> Tuple[torch.device, ...]:
    """The devices of a `world_size` mesh.  With none given: the first
    `world_size` visible cards (`default="cpu"`: that many CPU shards);
    fewer cards than shards raises, and nothing falls back to the CPU.
    A given sequence may repeat a device; it must hold `world_size`."""
    world_size = int(world_size)
    if devices is None:
        if default == "cpu":
            return (torch.device("cpu"),) * world_size
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < world_size:
            raise RuntimeError(
                f"megba_tpu_torch: world_size {world_size} needs "
                f"{world_size} CUDA devices, {n} visible; pass a device "
                f"list, e.g. device=['cuda:0'] * {world_size} to put every "
                f"shard on one card or ['cpu'] * {world_size}")
        return tuple(torch.device("cuda", i) for i in range(world_size))
    if isinstance(devices, (str, torch.device)):
        raise ValueError(
            f"world_size {world_size} needs a sequence of {world_size} "
            f"devices, got the single device {devices!r}")
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "megba_tpu_torch: no CUDA device is available; pass "
                "'cpu' devices to run on the CPU")
        if d.type == "cuda" and d.index is not None and \
                d.index >= torch.cuda.device_count():
            raise RuntimeError(f"megba_tpu_torch: {d} is not a visible "
                               "CUDA device")
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {d}")
        out.append(d)
    if world_size > len(out):
        raise ValueError(f"world_size {world_size} exceeds available "
                         f"devices {len(out)}")
    return tuple(out[:world_size])


def make_mesh(world_size: int, devices: DeviceSpec = None) -> Mesh:
    """The 1-D edge-sharding mesh (JAX mesh.py:235), over `devices` or
    the first `world_size` visible cards (`resolve_devices`)."""
    devs = resolve_devices(world_size, devices)
    return Mesh(devices=devs, shape=(len(devs),), axis_names=(EDGE_AXIS,))


def make_mesh_2d(edge_shards: int, cam_blocks: int,
                 devices: DeviceSpec = None) -> Mesh:
    """The 2-D (edge_shards x cam_blocks) mesh (JAX mesh.py:171): shard
    e * cam_blocks + c is device (e, c), the block order of
    `ops.segtiles.build_camera_tile_plan`."""
    E, C = int(edge_shards), int(cam_blocks)
    if E < 1 or C < 1:
        raise ValueError(
            f"edge_shards and cam_blocks must be >= 1, got {E} x {C}")
    devs = resolve_devices(E * C, devices)
    return Mesh(devices=devs, shape=(E, C), axis_names=(EDGE_AXIS, CAM_AXIS))


def shard_edge_arrays(obs: np.ndarray, cam_idx: np.ndarray,
                      pt_idx: np.ndarray, world_size: int, dtype=None):
    """Pad the edge axis to a multiple of world_size; returns (obs,
    cam_idx, pt_idx, mask) (JAX mesh.py:277).  The port's own shards need
    no padding (ops/segtiles.make_sharded_dual_plans)."""
    if dtype is None:
        dtype = obs.dtype
    return pad_edges(obs, cam_idx, pt_idx, world_size, dtype=dtype)


def distributed_lm_solve(cameras: torch.Tensor, points: torch.Tensor, obs,
                         cam_idx, pt_idx, mask, option, mesh: Mesh, plans,
                         sqrt_info=None, cam_fixed=None, pt_fixed=None,
                         verbose: bool = False, residual_jac_fn=None,
                         initial_region=None, initial_v=None,
                         initial_dx=None, fault_plan=None,
                         cluster_plan=None, tile_plan=None):
    """Run the LM solve over the mesh's shards (JAX mesh.py:294).

    `cameras` / `points` (feature-major) live on the first shard's
    device (across processes: this process's first, `mesh.home_device`,
    with None for another process's shard in every per-shard tuple);
    `obs`, `cam_idx`, `pt_idx`, `mask`, `sqrt_info` and
    `fault_plan` are per-shard tuples in each shard's camera-slot order on
    its device, and `plans` the shards' dual plans
    (ops/segtiles.make_sharded_dual_plans; one device: its one plan).
    A 2-D mesh needs the device tile plan
    (ops/segtiles.device_camera_tile_plan).  Returns the LMResult on the
    home device.
    """
    from megba_tpu_torch.algo.lm import lm_solve

    plans = tuple(plans)
    if len(plans) != mesh.size:
        raise ValueError(f"{len(plans)} shard plans for a mesh of "
                         f"{mesh.size} devices")
    if mesh.is_2d and tile_plan is None:
        raise ValueError(
            "a 2-D mesh solve needs the camera-tile plan operand: solve "
            "through flat_solve (which plans it) or pass tile_plan="
            "ops.segtiles.device_camera_tile_plan(...)")
    sharded = ShardedPlans(
        mesh=mesh, shards=plans, tile_plan=tile_plan if mesh.is_2d else None)
    from megba_tpu_torch.parallel.multihost import dispatch_on_mesh

    return dispatch_on_mesh(lambda: lm_solve(
        cameras, points, tuple(obs), tuple(cam_idx), tuple(pt_idx),
        tuple(mask), option, sharded,
        sqrt_info=None if sqrt_info is None else tuple(sqrt_info),
        cam_fixed=cam_fixed, pt_fixed=pt_fixed, verbose=verbose,
        residual_jac_fn=residual_jac_fn, initial_region=initial_region,
        initial_v=initial_v, initial_dx=initial_dx,
        fault_plan=None if fault_plan is None else tuple(fault_plan),
        cluster_plan=cluster_plan), mesh)

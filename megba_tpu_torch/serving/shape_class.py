"""Shape classes: canonical padded buckets for fleet solves.

Counterpart of `megba_tpu/serving/shape_class.py`, with the same ladder
and `EDGE_QUANTUM`, so both packages put a problem in the same bucket.
A problem's dimensions are quantised onto a ladder of powers of two
over a floor per axis, so every problem maps to one of a small, closed
set of padded shapes; the lanes of one bucket share one lane-batched
solve (algo/lanes.py) and one bucket program (serving/compile_pool.py).

The padding reuses what the solver already does:

- the edge axis is padded as `core.types.pad_edges` pads it: masked-out
  edges repeating the last edge's vertex indices, so camera-sortedness
  survives and every index stays in range, up to the bucket's size;
- padded cameras and points are zero parameter blocks flagged in the
  `cam_fixed` / `pt_fixed` masks, which zero their Jacobian columns and
  pin their Hessian blocks to the identity
  (linear_system/builder.weight_system_inputs, build_schur_system), so
  their steps are exactly zero and the LM never moves them.

All buckets are powers of two times a floor, so the ladder is monotone
(more of anything never lands in a smaller bucket) and its size is
logarithmic in the problem-size range.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from megba_tpu_torch.core.fm import EDGE_QUANTUM
from megba_tpu_torch.native import sort_edges_by_camera


def _round_up_pow2_multiple(n: int, floor: int) -> int:
    """Smallest `floor * 2**k` (k >= 0) that is >= n."""
    out = floor
    while out < n:
        out *= 2
    return out


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """The bucketing ladder: floors + power-of-two growth per axis.

    `edge_floor` must be a multiple of EDGE_QUANTUM, as in the JAX
    package (whose chunked edge reductions need it), so that both
    packages bucket alike.  `lane_floor` buckets the batch axis the same
    way, so a bucket's program count stays logarithmic in the batch
    sizes the dispatch queue produces.
    """

    cam_floor: int = 4
    pt_floor: int = 16
    edge_floor: int = EDGE_QUANTUM
    lane_floor: int = 1

    def __post_init__(self) -> None:
        for name in ("cam_floor", "pt_floor", "edge_floor", "lane_floor"):
            v = getattr(self, name)
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        if self.edge_floor % EDGE_QUANTUM:
            raise ValueError(
                f"edge_floor must be a multiple of EDGE_QUANTUM "
                f"({EDGE_QUANTUM}), got {self.edge_floor}")

    def bucket_cams(self, n: int) -> int:
        return _round_up_pow2_multiple(int(n), self.cam_floor)

    def bucket_points(self, n: int) -> int:
        return _round_up_pow2_multiple(int(n), self.pt_floor)

    def bucket_edges(self, n: int) -> int:
        return _round_up_pow2_multiple(int(n), self.edge_floor)

    def bucket_lanes(self, n: int) -> int:
        return _round_up_pow2_multiple(int(n), self.lane_floor)


@dataclasses.dataclass(frozen=True)
class ShapeClass:
    """One padded bucket: the static shape every member solves at.

    Hashable; the dict key the batcher groups problems under and the
    compile pool keys programs by (with the lane count and the option).
    `dtype` is the numpy dtype name, so the class is JSON-serializable
    for warm-up manifests.
    """

    n_cam: int
    n_pt: int
    n_edge: int
    dtype: str

    def __str__(self) -> str:  # manifest / stats key
        return f"c{self.n_cam}_p{self.n_pt}_e{self.n_edge}_{self.dtype}"

    def to_dict(self) -> Dict[str, Any]:
        return {"n_cam": self.n_cam, "n_pt": self.n_pt,
                "n_edge": self.n_edge, "dtype": self.dtype}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ShapeClass":
        return cls(n_cam=int(d["n_cam"]), n_pt=int(d["n_pt"]),
                   n_edge=int(d["n_edge"]), dtype=str(d["dtype"]))


def classify(n_cam: int, n_pt: int, n_edge: int, dtype,
             ladder: BucketLadder) -> ShapeClass:
    """Canonicalize raw problem dimensions onto the ladder."""
    if n_cam < 1 or n_pt < 1 or n_edge < 1:
        raise ValueError(
            f"degenerate problem: n_cam={n_cam} n_pt={n_pt} n_edge={n_edge}")
    return ShapeClass(
        n_cam=ladder.bucket_cams(n_cam),
        n_pt=ladder.bucket_points(n_pt),
        n_edge=ladder.bucket_edges(n_edge),
        dtype=np.dtype(dtype).name,
    )


@dataclasses.dataclass
class PaddedProblem:
    """One problem lowered to its shape class (host numpy, edge-major).

    Edges are camera-sorted and padded to `shape.n_edge` with mask-0
    slots; cameras/points are zero-padded to the bucket with the pad
    region flagged in `cam_fixed` / `pt_fixed`.  `n_cam/n_pt/n_edge`
    remember the REAL sizes for slicing results back out.
    """

    shape: ShapeClass
    cameras: np.ndarray  # [n_cam_bucket, cd]
    points: np.ndarray  # [n_pt_bucket, pd]
    obs: np.ndarray  # [n_edge_bucket, od]
    cam_idx: np.ndarray  # [n_edge_bucket] int32
    pt_idx: np.ndarray  # [n_edge_bucket] int32
    mask: np.ndarray  # [n_edge_bucket] dtype 0/1
    cam_fixed: np.ndarray  # [n_cam_bucket] bool, True on padding
    pt_fixed: np.ndarray  # [n_pt_bucket] bool, True on padding
    n_cam: int
    n_pt: int
    n_edge: int
    # The camera-sort permutation the REAL edges took (None if they were
    # already sorted): any per-edge side-channel vector — e.g. a
    # FaultPlan's edge_nan (robustness/faults.lower_fault_plan) — must
    # ride the same reorder to land on the same physical edges.
    perm: Optional[np.ndarray] = None


def pad_to_class(cameras: np.ndarray, points: np.ndarray, obs: np.ndarray,
                 cam_idx: np.ndarray, pt_idx: np.ndarray,
                 shape: ShapeClass,
                 edge_mask: Optional[np.ndarray] = None,
                 cam_fixed: Optional[np.ndarray] = None,
                 pt_fixed: Optional[np.ndarray] = None) -> PaddedProblem:
    """Lower one problem's host arrays onto its shape class.

    The dtype cast, the stable camera sort (the counting sort of
    `native.sort_edges_by_camera`, as in the JAX package), the edge
    padding, then the bucket's camera/point zero-padding with fixed-mask
    flags on the pad region.  Padded edges repeat the last REAL edge's vertex
    indices (pad_edges), which point at real vertices, so the masked
    residual evaluation stays finite.

    `edge_mask` ([nE], caller's edge order, values in [0, 1]) rides the
    camera-sort permutation and MULTIPLIES into the padding mask —
    exactly `flat_solve(..., edge_mask=)`'s soft-delete/downweight
    semantics, so a triage-repaired problem (robustness/triage.py)
    lowers onto its bucket as pure operands.  `cam_fixed` / `pt_fixed`
    ([Nc]/[Np] bool) OR into the padding-region flags the same way.
    None of the three changes the bucket program.
    """
    from megba_tpu_torch.core.types import is_cam_sorted, pad_edges

    dtype = np.dtype(shape.dtype)
    cameras = np.asarray(cameras).astype(dtype, copy=False)
    points = np.asarray(points).astype(dtype, copy=False)
    obs = np.asarray(obs).astype(dtype, copy=False)
    cam_idx = np.asarray(cam_idx, dtype=np.int32)
    pt_idx = np.asarray(pt_idx, dtype=np.int32)
    n_cam, n_pt, n_edge = cameras.shape[0], points.shape[0], obs.shape[0]
    if n_cam > shape.n_cam or n_pt > shape.n_pt or n_edge > shape.n_edge:
        raise ValueError(
            f"problem ({n_cam} cams, {n_pt} pts, {n_edge} edges) does not "
            f"fit shape class {shape}")
    em = None
    if edge_mask is not None:
        em = np.asarray(edge_mask).astype(dtype, copy=False).reshape(-1)
        if em.shape[0] != n_edge:
            raise ValueError(
                f"edge_mask has {em.shape[0]} entries for a problem "
                f"with {n_edge} edges")

    perm = None
    if not is_cam_sorted(cam_idx):
        perm = sort_edges_by_camera(cam_idx, n_cam)
        cam_idx, pt_idx, obs = cam_idx[perm], pt_idx[perm], obs[perm]
        if em is not None:
            em = em[perm]

    # pad_edges pads to a MULTIPLE of its argument; the bucket size is
    # the multiple here, and n_edge <= shape.n_edge, so the result is
    # exactly one bucket long.
    obs, cam_idx, pt_idx, mask = pad_edges(
        obs, cam_idx, pt_idx, shape.n_edge, dtype=dtype)
    if em is not None:
        # 1*em on the real region, 0 stays 0 on the pad region (the
        # flat_solve identity: 1.0 * {0.0, 1.0} is exact, and fractional
        # downweights ride unchanged).
        mask = mask * np.concatenate(
            [em, np.ones(mask.shape[0] - em.shape[0], dtype)])

    pad_c = shape.n_cam - n_cam
    pad_p = shape.n_pt - n_pt
    if pad_c:
        cameras = np.concatenate(
            [cameras, np.zeros((pad_c, cameras.shape[1]), dtype)])
    if pad_p:
        points = np.concatenate(
            [points, np.zeros((pad_p, points.shape[1]), dtype)])
    cam_fixed_out = np.zeros(shape.n_cam, dtype=bool)
    cam_fixed_out[n_cam:] = True
    if cam_fixed is not None:
        cam_fixed_out[:n_cam] |= np.asarray(cam_fixed, bool).reshape(-1)
    pt_fixed_out = np.zeros(shape.n_pt, dtype=bool)
    pt_fixed_out[n_pt:] = True
    if pt_fixed is not None:
        pt_fixed_out[:n_pt] |= np.asarray(pt_fixed, bool).reshape(-1)
    cam_fixed, pt_fixed = cam_fixed_out, pt_fixed_out

    return PaddedProblem(
        shape=shape, cameras=cameras, points=points, obs=obs,
        cam_idx=cam_idx, pt_idx=pt_idx, mask=mask,
        cam_fixed=cam_fixed, pt_fixed=pt_fixed,
        n_cam=n_cam, n_pt=n_pt, n_edge=n_edge, perm=perm)

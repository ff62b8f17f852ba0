"""Synthetic BAL-like problem generator (numpy).

A copy of `megba_tpu/io/synthetic.py:make_synthetic_bal` that the port
owns, so it imports nothing of the JAX package: for the same arguments it
gives byte-identical arrays.  Problems of any size are generated from a
seed with known ground truth, so no dataset has to be downloaded.

`heavy_tailed_graph` is the port's own: an observation graph alone (no
parameters) whose track lengths have a Zipf tail, with the edge cases
of the fused kernels' slot tiles placed in it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from megba_tpu_torch.io.bal import validate_problem


@dataclasses.dataclass
class SyntheticBAL:
    """Ground-truth + perturbed initial parameters for a synthetic scene."""

    cameras_gt: np.ndarray  # [Nc, 9]
    points_gt: np.ndarray  # [Np, 3]
    cameras0: np.ndarray  # perturbed initial cameras
    points0: np.ndarray  # perturbed initial points
    obs: np.ndarray  # [nE, 2]
    cam_idx: np.ndarray  # [nE] int32
    pt_idx: np.ndarray  # [nE] int32


def rotate_batch(w: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Vectorised NumPy Rodrigues rotation: R(w_i) @ points_i, [n, 3]."""
    theta = np.linalg.norm(w, axis=1, keepdims=True)
    safe = theta > 1e-12
    theta_safe = np.where(safe, theta, 1.0)
    k = w / theta_safe
    cos_t = np.cos(theta)
    sin_t = np.sin(theta)
    dot = np.sum(k * points, axis=1, keepdims=True)
    RX = points * cos_t + np.cross(k, points) * sin_t + k * dot * (1 - cos_t)
    return np.where(safe, RX, points + np.cross(w, points))


def project_batch_depth(
    cameras: np.ndarray, points: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorised NumPy BAL projection with the camera-frame depth.

    cameras [n, 9] x points [n, 3] -> (uv [n, 2], z [n]) where z is the
    camera-frame third coordinate BEFORE the -P/P.z divide: the BAL
    convention puts visible scene at z < 0, so z >= 0 is a cheirality
    violation (point behind — or exactly on — the camera plane).
    """
    w, t = cameras[:, 0:3], cameras[:, 3:6]
    f, k1, k2 = cameras[:, 6], cameras[:, 7], cameras[:, 8]
    P = rotate_batch(w, points) + t
    with np.errstate(divide="ignore", invalid="ignore"):
        p = -P[:, 0:2] / P[:, 2:3]
        n = np.sum(p * p, axis=1)
        uv = (f * (1 + k1 * n + k2 * n * n))[:, None] * p
    return uv, P[:, 2]


def _project_batch(cameras: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Vectorised NumPy projection: cameras [n,9] x points [n,3] -> [n,2]."""
    return project_batch_depth(cameras, points)[0]


def camera_centers(cameras: np.ndarray) -> np.ndarray:
    """Camera centers C = -R^T t for [Nc, >=6] blocks laid out
    [angle-axis(3), translation(3), ...]."""
    return -rotate_batch(-cameras[:, 0:3], cameras[:, 3:6])


LOCALITY_MODES = (None, "ring", "grid")


def _locality_assign(
    anchors: np.ndarray,
    pts_xy: np.ndarray,
    kf: int,
    kc: int,
    n_hi: int,
):
    """k-nearest-anchor windowed visibility: [Np, 2] point positions vs
    [Nc, 2] camera anchors -> (cam_idx, pt_idx) edge streams.

    Each point keeps its `kc` nearest cameras sorted nearest-first, the
    tail points beyond `n_hi` drop down to their `kf` nearest — the
    fractional obs-per-point rule of the base generator, applied in
    DISTANCE order so dropping observations never breaks locality.
    """
    num_points = pts_xy.shape[0]
    num_cameras = anchors.shape[0]
    kc = min(kc, num_cameras)
    kf = min(kf, kc)
    # Chunk the [chunk, Nc] distance/argpartition work over points: a
    # full [Np, Nc] matrix is ~14 GB f64 at venice scale and ~480 GB at
    # BAL-Final — the same host-RAM blowup the base generator's chunked
    # projection loop guards against.  ~5e7 elements per chunk keeps
    # the transient a few hundred MB at any supported scale.
    chunk = max(1, int(50_000_000 // max(num_cameras, 1)))
    near = np.empty((num_points, kc), np.int64)
    # Per-camera running nearest point (for the missing-camera fixup
    # below) — accumulated chunk-wise so no full column is ever needed.
    nearest_pt_d2 = np.full(num_cameras, np.inf)
    nearest_pt = np.zeros(num_cameras, np.int64)
    for lo in range(0, num_points, chunk):
        hi = min(lo + chunk, num_points)
        d2 = np.sum((pts_xy[lo:hi, None, :] - anchors[None, :, :]) ** 2,
                    axis=2)
        if kc < num_cameras:
            nc = np.argpartition(d2, kc - 1, axis=1)[:, :kc]
        else:
            nc = np.broadcast_to(np.arange(num_cameras),
                                 (hi - lo, kc)).copy()
        order = np.argsort(np.take_along_axis(d2, nc, axis=1), axis=1,
                           kind="stable")
        near[lo:hi] = np.take_along_axis(nc, order, axis=1)  # nearest 1st
        cmin = np.argmin(d2, axis=0)
        cd2 = d2[cmin, np.arange(num_cameras)]
        better = cd2 < nearest_pt_d2
        nearest_pt_d2[better] = cd2[better]
        nearest_pt[better] = cmin[better] + lo
    keep = np.ones((num_points, kc), dtype=bool)
    if kc > kf:
        keep[n_hi:, kf:] = False
    cam_idx = near[keep]
    pt_idx = np.broadcast_to(
        np.arange(num_points)[:, None], (num_points, kc))[keep]
    # Guarantee every camera appears: attach a missing camera to its
    # NEAREST point (not a random one — a long-range edge would puncture
    # the banded structure this mode exists to produce).
    missing = np.setdiff1d(np.arange(num_cameras), cam_idx,
                           assume_unique=False)
    if missing.size:
        cam_idx = np.concatenate([cam_idx, missing])
        pt_idx = np.concatenate([pt_idx, nearest_pt[missing]])
    return cam_idx, pt_idx


def make_synthetic_bal(
    num_cameras: int = 4,
    num_points: int = 24,
    obs_per_point: float = 3,
    pixel_noise: float = 0.5,
    param_noise: float = 1e-2,
    seed: int = 0,
    dtype: np.dtype = np.float64,
    n_orphan_points: int = 0,
    n_behind_camera: int = 0,
    n_disconnect: int = 0,
    locality: Optional[str] = None,
) -> SyntheticBAL:
    """Build a well-posed synthetic scene.

    Points live in a unit ball at the origin; cameras sit ~5 units up the
    +z axis with small random rotations, looking down (BAL convention:
    scene depth is negative in the camera frame, matching the -P/P.z
    projection).  Each point is observed by `obs_per_point` distinct
    cameras; every camera gets at least one observation.

    `obs_per_point` may be fractional: a `frac(obs_per_point)` share of
    points gets `ceil` observations, the rest `floor`, so the total edge
    count tracks `num_points * obs_per_point` — this is how the bench
    matches the real BAL datasets' observation counts while keeping the
    point count exact.

    Degeneracy injection (pre-flight triage test fixtures — each knob
    appends a deterministic pathology the robustness/triage.py checks
    must catch; all draws come from the SAME rng, strictly after the
    base scene's draws, so every knob at 0 reproduces the unmodified
    scene byte-for-byte and the make_fleet prefix-stability contract is
    untouched):

    - `n_orphan_points`: points observed by exactly ONE camera (deg-1
      — the predicted-singular-Hll pathology), with a garbage initial
      estimate placed far along the viewing ray (the failed-
      triangulation model: a single ray fixes bearing, not depth).
    - `n_behind_camera`: points placed BEHIND the rig (world z ~ +6,
      cameras look down from z ~ -5), each observed by two cameras —
      every such edge is a cheirality violation at the initial
      estimate.
    - `n_disconnect`: a disconnected island of `n_disconnect` extra
      cameras observing `4 * n_disconnect` extra points that no main
      camera sees (gauge-deficient second component).  With
      n_disconnect = 1 the island's points are additionally deg-1.

    Locality modes (`locality="ring"` / `"grid"`; same strictly-after-
    the-base-draws contract as the degeneracy knobs, so `locality=None`
    reproduces the historical scene byte-for-byte): the base generator
    assigns each point's cameras as `(base + j*stride) mod Nc` — an
    EXPANDER camera graph with no cluster structure, which real BAL
    scenes (street-level ladybug rigs, photo-tourism venice) do not
    have.  A locality mode instead stations cameras on a spatial
    layout (a closed ring of arc anchors, or a ceil(sqrt(Nc))-wide
    grid), scatters points NEAR the camera track, and gives every
    point WINDOWED visibility: its `obs_per_point` nearest cameras.
    Camera co-observation is then banded/blocked — cameras share
    points only with spatial neighbours — producing exactly the
    cluster-constant slow modes the camera-graph coarse-space
    preconditioners (solver/precond.py TWO_LEVEL / MULTILEVEL) exist
    to remove.  The degeneracy knobs compose on top unchanged.
    """
    if locality not in LOCALITY_MODES:
        raise ValueError(
            f"locality must be one of {LOCALITY_MODES}, got {locality!r}")
    for name, v in (("n_orphan_points", n_orphan_points),
                    ("n_behind_camera", n_behind_camera),
                    ("n_disconnect", n_disconnect)):
        if v < 0:
            raise ValueError(f"{name} must be >= 0, got {v}")
    r = np.random.default_rng(seed)
    obs_per_point = min(float(obs_per_point), float(num_cameras))

    points_gt = r.uniform(-1.0, 1.0, size=(num_points, 3))
    cameras_gt = np.zeros((num_cameras, 9))
    cameras_gt[:, 0:3] = r.normal(scale=0.05, size=(num_cameras, 3))  # small tilt
    cameras_gt[:, 3:5] = r.normal(scale=0.2, size=(num_cameras, 2))  # x/y offset
    cameras_gt[:, 5] = -5.0 + r.normal(scale=0.2, size=num_cameras)  # z: scene in front
    cameras_gt[:, 6] = 500.0 + r.normal(scale=5.0, size=num_cameras)  # focal
    cameras_gt[:, 7] = r.normal(scale=1e-4, size=num_cameras)  # k1
    cameras_gt[:, 8] = r.normal(scale=1e-6, size=num_cameras)  # k2

    # k distinct cameras per point, fully vectorised: (base + j*stride) mod
    # Nc for j < k is duplicate-free whenever stride*k <= Nc.  Fractional
    # obs_per_point: the first n_hi points get kc=ceil observations, the
    # rest kf=floor, so the total matches num_points*obs_per_point.
    kf = max(int(np.floor(obs_per_point)), 1)
    kc = int(np.ceil(obs_per_point))
    n_hi = int(round((obs_per_point - kf) * num_points)) if kc > kf else 0
    base = r.integers(0, num_cameras, size=(num_points, 1))
    max_stride = max(num_cameras // max(kc, 1), 1)
    stride = 1 + r.integers(0, max_stride, size=(num_points, 1))
    grid = (base + np.arange(kc)[None, :] * stride) % num_cameras
    keep = np.ones((num_points, kc), dtype=bool)
    if kc > kf:
        keep[n_hi:, kf:] = False
    cam_idx = grid[keep]
    pt_idx = np.broadcast_to(np.arange(num_points)[:, None], (num_points, kc))[keep]
    # Guarantee every camera appears (random draws may miss some).
    missing = np.setdiff1d(np.arange(num_cameras), cam_idx, assume_unique=False)
    if missing.size:
        cam_idx = np.concatenate([cam_idx, missing])
        pt_idx = np.concatenate(
            [pt_idx, r.integers(0, num_points, size=missing.size)])
    if locality is not None:
        # Locality mode: REPLACE the expander observation assignment
        # with a spatial camera layout + windowed visibility.  The base
        # scene's draws above are kept (and burned) so these draws sit
        # strictly after them — locality=None stays byte-identical, and
        # every locality scene is deterministic in (seed, knobs).
        if locality == "ring":
            # Camera anchors on a closed ring; points scattered in an
            # annulus around the camera track (street-scene shape).
            phi = 2.0 * np.pi * np.arange(num_cameras) / num_cameras
            ring_r = 3.0
            anchors = ring_r * np.stack([np.cos(phi), np.sin(phi)], axis=1)
            psi = r.uniform(0.0, 2.0 * np.pi, size=num_points)
            rad = ring_r + r.uniform(-0.8, 0.8, size=num_points)
            pts_xy = np.stack([rad * np.cos(psi), rad * np.sin(psi)], axis=1)
        else:  # grid (aerial-survey shape)
            g = int(np.ceil(np.sqrt(num_cameras)))
            extent = 6.0
            ii = np.arange(num_cameras)
            anchors = ((np.stack([ii % g, ii // g], axis=1) + 0.5)
                       * (extent / g) - extent / 2.0)
            pts_xy = r.uniform(-extent / 2.0, extent / 2.0,
                               size=(num_points, 2))
        points_gt = np.concatenate(
            [pts_xy, r.uniform(-0.5, 0.5, size=(num_points, 1))], axis=1)
        # Cameras keep their base-drawn tilt/intrinsics/z offset; only
        # the xy translation is re-anchored over the layout (t ~ -center
        # under the small drawn tilts), so each camera looks down at its
        # own neighbourhood of the track.
        cameras_gt = cameras_gt.copy()
        cameras_gt[:, 3:5] -= anchors
        cam_idx, pt_idx = _locality_assign(anchors, pts_xy, kf, kc, n_hi)
    # Chunk the projection: at BAL-Final scale (~29M edges) one shot would
    # materialise ~10 float64 [nE,3] temporaries (~7 GB host RAM).
    n_edge_total = cam_idx.shape[0]
    chunk = 4_000_000
    if n_edge_total <= chunk:
        uv = _project_batch(cameras_gt[cam_idx], points_gt[pt_idx])
    else:
        uv = np.empty((n_edge_total, 2))
        for lo in range(0, n_edge_total, chunk):
            hi = min(lo + chunk, n_edge_total)
            uv[lo:hi] = _project_batch(
                cameras_gt[cam_idx[lo:hi]], points_gt[pt_idx[lo:hi]])
    obs = uv + r.normal(scale=pixel_noise, size=uv.shape)

    # ---- degeneracy injection (knob order: orphan, behind, island) ----
    # Draws happen only inside taken branches, strictly after the base
    # scene's draws: all-zero knobs leave the rng stream — and thus the
    # scene — byte-identical to the knob-free generator.
    orphan_rows: Optional[np.ndarray] = None
    orphan_init: Optional[np.ndarray] = None
    if n_orphan_points:
        gt = r.uniform(-1.0, 1.0, size=(n_orphan_points, 3))
        cam = r.integers(0, num_cameras, size=n_orphan_points)
        uv1 = _project_batch(cameras_gt[cam], gt)
        ob1 = uv1 + r.normal(scale=pixel_noise, size=uv1.shape)
        orphan_rows = points_gt.shape[0] + np.arange(n_orphan_points)
        # Failed-triangulation initial estimate: one ray fixes bearing
        # but not depth, so the "triangulated" depth lands far out along
        # the viewing ray from the observing camera's center.
        centers = -rotate_batch(-cameras_gt[cam, 0:3], cameras_gt[cam, 3:6])
        ray = gt - centers
        ray = ray / np.linalg.norm(ray, axis=1, keepdims=True)
        depth_far = np.linalg.norm(gt - centers, axis=1, keepdims=True) \
            * r.uniform(50.0, 150.0, size=(n_orphan_points, 1))
        orphan_init = centers + depth_far * ray
        points_gt = np.concatenate([points_gt, gt])
        cam_idx = np.concatenate([cam_idx, cam])
        pt_idx = np.concatenate([pt_idx, orphan_rows])
        obs = np.concatenate([obs, ob1])
    if n_behind_camera:
        gt = r.uniform(-1.0, 1.0, size=(n_behind_camera, 3))
        gt[:, 2] = 6.0 + r.uniform(0.0, 1.0, size=n_behind_camera)
        rows = points_gt.shape[0] + np.arange(n_behind_camera)
        c1 = r.integers(0, num_cameras, size=n_behind_camera)
        if num_cameras > 1:
            c2 = (c1 + 1 + r.integers(0, num_cameras - 1,
                                      size=n_behind_camera)) % num_cameras
        else:
            c2 = None
        cams_b = [c1] if c2 is None else [c1, c2]
        for cb in cams_b:
            uvb = _project_batch(cameras_gt[cb], gt)
            obb = uvb + r.normal(scale=pixel_noise, size=uvb.shape)
            cam_idx = np.concatenate([cam_idx, cb])
            pt_idx = np.concatenate([pt_idx, rows])
            obs = np.concatenate([obs, obb])
        points_gt = np.concatenate([points_gt, gt])
    if n_disconnect:
        nis = n_disconnect
        isl = np.zeros((nis, 9))
        isl[:, 0:3] = r.normal(scale=0.05, size=(nis, 3))
        isl[:, 3:5] = r.normal(scale=0.2, size=(nis, 2))
        isl[:, 5] = -5.0 + r.normal(scale=0.2, size=nis)
        isl[:, 6] = 500.0 + r.normal(scale=5.0, size=nis)
        isl[:, 7] = r.normal(scale=1e-4, size=nis)
        isl[:, 8] = r.normal(scale=1e-6, size=nis)
        gt = r.uniform(-1.0, 1.0, size=(4 * nis, 3))
        rows = points_gt.shape[0] + np.arange(4 * nis)
        j = np.arange(4 * nis)
        pairs = [j % nis] if nis == 1 else [j % nis, (j + 1) % nis]
        cam_base = cameras_gt.shape[0]
        for cb in pairs:
            uvi = _project_batch(isl[cb], gt)
            obi = uvi + r.normal(scale=pixel_noise, size=uvi.shape)
            cam_idx = np.concatenate([cam_idx, cam_base + cb])
            pt_idx = np.concatenate([pt_idx, rows])
            obs = np.concatenate([obs, obi])
        cameras_gt = np.concatenate([cameras_gt, isl])
        points_gt = np.concatenate([points_gt, gt])

    order = np.argsort(cam_idx, kind="stable")  # BAL files are cam-sorted
    cam_idx = np.asarray(cam_idx, dtype=np.int32)[order]
    pt_idx = np.asarray(pt_idx, dtype=np.int32)[order]
    obs = np.asarray(obs, dtype=dtype)[order]

    cameras0 = cameras_gt + r.normal(scale=param_noise, size=cameras_gt.shape) * np.array(
        [1, 1, 1, 1, 1, 1, 100.0, 1e-3, 1e-5]
    )
    points0 = points_gt + r.normal(scale=param_noise, size=points_gt.shape)
    if orphan_rows is not None:
        points0[orphan_rows] = orphan_init

    # Same ingestion gate as the BAL parsers: a generator bug can no
    # longer hand the solver what a file would have been refused for.
    # The degeneracy knobs stay within the gate by construction — they
    # inject GEOMETRIC/STRUCTURAL pathologies (deg-1, behind-camera,
    # disconnection: the triage layer's jurisdiction), never the
    # non-finite/duplicate poison the parser boundary rejects.
    validate_problem(cameras0, points0, obs, cam_idx, pt_idx,
                     where=f"make_synthetic_bal(seed={seed})")

    return SyntheticBAL(
        cameras_gt=cameras_gt.astype(dtype),
        points_gt=points_gt.astype(dtype),
        cameras0=cameras0.astype(dtype),
        points0=points0.astype(dtype),
        obs=obs,
        cam_idx=cam_idx,
        pt_idx=pt_idx,
    )


def heavy_tailed_graph(num_cameras: int, num_points: int, seed: int = 0,
                       tile: int = 256, zipf_a: float = 2.0,
                       max_track: int = 4096) -> Tuple[np.ndarray, np.ndarray]:
    """(cam_idx, pt_idx) int32 edge lists, shuffled, of a correctness
    graph for the slot tiles' edge cases: track lengths (observations per
    point) follow a Zipf law of exponent `zipf_a` capped at `max_track`
    (mean ~5.9 at the defaults), cameras are drawn uniformly with
    replacement (so with few cameras a long track sees a camera more than
    once).  The exponent and the cap are chosen to reach long tracks, not
    taken from measured SfM data.

    Points 0, the middle three and the last two have no observation;
    point 1 has one, point 2 exactly `tile` and point 3 3 * `tile` + 17,
    so a slot tile of `tile` slots meets empty segments at the start,
    middle and end of the order, a segment that fills a tile and one
    that spans four.  Needs num_points >= 10."""
    if num_points < 10:
        raise ValueError("heavy_tailed_graph needs num_points >= 10")
    rng = np.random.default_rng(seed)
    lengths = np.minimum(rng.zipf(zipf_a, num_points), max_track)
    mid = num_points // 2
    lengths[[0, mid - 1, mid, mid + 1, -2, -1]] = 0
    lengths[1:4] = (1, tile, 3 * tile + 17)
    pt_idx = np.repeat(np.arange(num_points), lengths)
    cam_idx = rng.integers(0, num_cameras, pt_idx.shape[0])
    order = rng.permutation(pt_idx.shape[0])
    return cam_idx[order].astype(np.int32), pt_idx[order].astype(np.int32)


def long_camera_idx(num_cameras: int, shortest: int = 5000,
                    longest: int = 40000, seed: int = 0) -> np.ndarray:
    """Camera ids (int32, shuffled) of a camera side with long and skewed
    segments: camera c has L_c edges, L_c log-uniform on [`shortest`,
    `longest`] (mean ~16,800 at the defaults).  At 5k-40k observations a
    camera it stands for the cameras of a dense capture, longer than any
    of the BAL-sized synthetics' (~2,800), where a side's longest cameras
    set how its camera sums are split over blocks."""
    rng = np.random.default_rng(seed)
    lengths = np.exp(rng.uniform(np.log(shortest), np.log(longest),
                                 num_cameras)).astype(np.int64)
    cam_idx = np.repeat(np.arange(num_cameras), lengths)
    return cam_idx[rng.permutation(cam_idx.shape[0])].astype(np.int32)

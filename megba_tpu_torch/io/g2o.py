"""g2o text-format pose graphs: read, write, solve.

Counterpart of `megba_tpu/io/g2o.py`, host numpy: the same parser, the
same writer and the same error messages, and `solve_g2o` over the port's
pose-graph driver (models/pgo.py), which runs on the card unless the
caller passes `device="cpu"`.

Supported records
-----------------
- ``VERTEX_SE3:QUAT id x y z qx qy qz qw``
- ``EDGE_SE3:QUAT i j x y z qx qy qz qw  <21 upper-tri info entries>``
- ``VERTEX_SE2 id x y theta``
- ``EDGE_SE2 i j dx dy dtheta  <6 upper-tri info entries>``
- ``EDGE_SE3_PRIOR id x y z qx qy qz qw  <21 upper-tri info entries>``
  (unary pose prior — GPS/INS/surveyed-station anchors; parsed into
  ``G2OGraph.prior_idx/prior_meas/prior_info`` and folded into the
  solve as unary prior factors.  The g2o variant carrying an offset
  PARAMS id is refused with a typed error: silently ignoring a
  non-identity sensor offset would corrupt the anchor.)
- ``VERTEX_SIM3:QUAT id x y z qx qy qz qw s``  (s = scale > 0)
- ``EDGE_SIM3:QUAT i j x y z qx qy qz qw s  <28 upper-tri info entries>``
  (scale-aware pose graphs — monocular loop closing; solved through
  the ``sim3_between`` factor, factors/sim3.py.  Sim(3) and SE(2)/SE(3)
  records cannot be mixed in one file — typed error naming the line.
  The 7x7 information is over our error chart order lifted to the file
  order [t, q, log-scale]; rotation rows carry the same dq = d(aa)/2
  chart factor as SE(3).)
- ``FIX id``  (gauge anchors; default: lowest vertex id)

SE(2) records are lifted into the SE(3) solver: theta becomes a z-axis
rotation, (x, y) an in-plane translation, and the lifted information
matrix gets unit weight on the three out-of-plane error rows — every
edge then constrains relative out-of-plane motion to zero, which is
exactly the planar-rigidity the SE(2) graph encodes.

Information-matrix convention
-----------------------------
g2o orders the SE(3) error as [translation, rotation-(qx,qy,qz)]; our
residual (models/pgo.py:between_residual) is [log_SO3, translation].
The reader permutes rows/columns accordingly and applies the
quaternion-vector -> log-map chart factor (dq ~= d(aa)/2 to first
order): rotation rows AND columns are scaled by 1/2, so
``r_ours^T Omega_ours r_ours == r_g2o^T Omega_g2o r_g2o`` for small
errors.  ``solve_g2o`` hands the solver a matrix square root W of each
Omega (symmetric-eigendecomposition based, so positive-semidefinite
info factors cleanly; ||W r||^2 = r^T Omega r).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, TextIO, Union

import numpy as np

from megba_tpu_torch.core.host_se3 import aa_to_quat, quat_to_aa

# Our residual row order is [rotation (log map), translation]; g2o's is
# [translation, quaternion vector].  _PERM maps our row a to g2o row
# _PERM[a].
_PERM = np.array([3, 4, 5, 0, 1, 2])

# Row/col pairs of the g2o upper-triangular info serialization, row
# major: (0,0) (0,1) ... (0,5) (1,1) ... (5,5).
_TRIU = np.triu_indices(6)


@dataclasses.dataclass
class G2OGraph:
    """A pose graph in the solver's native coordinates.

    poses [N, 6] = [angle_axis, translation] (SE(2) inputs lifted);
    info [nE, 6, 6] is in OUR row order (rotation first, chart-corrected
    — see module docstring); ids holds the original g2o vertex ids in
    index order so writers can round-trip non-contiguous numbering.
    """

    poses: np.ndarray
    edge_i: np.ndarray
    edge_j: np.ndarray
    meas: np.ndarray
    info: np.ndarray
    fixed: np.ndarray
    ids: np.ndarray
    se2: bool = False
    # Whether the source file carried explicit FIX records.  read_g2o
    # defaults fixed[0]=True when none were present (the solver needs a
    # gauge anchor), but write_g2o must not materialize that default as
    # a FIX line the original file never had — external g2o consumers
    # treat FIX as a semantic statement about gauge handling.
    had_fix: bool = True
    # Unary pose priors (EDGE_SE3_PRIOR records): anchored vertex
    # indices (into `poses`), prior poses [P, 6] in our chart, and the
    # chart-corrected [P, 6, 6] information.  Empty on files without
    # prior records.
    prior_idx: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    prior_meas: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 6)))
    prior_info: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 6, 6)))
    # Scale-aware graph (VERTEX/EDGE_SIM3:QUAT): poses/meas are then
    # [*, 7] = [angle_axis, translation, log-scale] and info [*, 7, 7];
    # solve_g2o dispatches the sim3_between factor.
    sim3: bool = False


def _upper_tri_to_full_batch(tri: np.ndarray, n: int = 6) -> np.ndarray:
    """[..., n(n+1)/2] row-major upper-tri values -> [..., n, n] full."""
    rows, cols = np.triu_indices(n)
    m = np.zeros((*tri.shape[:-1], n, n))
    m[..., rows, cols] = tri
    m[..., cols, rows] = tri
    return m


# Vectorised host-side chart maps (shared with the synthetic pose-graph
# generator; see core/host_se3.py for the branch/double-cover details).
_quat_xyzw_to_aa = quat_to_aa
_aa_to_quat_xyzw = aa_to_quat


_CHART_SCALE = np.array([0.5, 0.5, 0.5, 1.0, 1.0, 1.0])


def _info_g2o_to_ours(info_g2o: np.ndarray) -> np.ndarray:
    """Permute [t, q] -> [rot, t] and apply the dq = d(aa)/2 chart.

    Batched: works on [..., 6, 6].
    """
    m = info_g2o[..., _PERM[:, None], _PERM[None, :]]
    return m * _CHART_SCALE[:, None] * _CHART_SCALE[None, :]


def _info_ours_to_g2o(info_ours: np.ndarray) -> np.ndarray:
    inv = np.argsort(_PERM)
    m = info_ours / (_CHART_SCALE[:, None] * _CHART_SCALE[None, :])
    return m[..., inv[:, None], inv[None, :]]


# Sim(3): our residual row order is [rotation log map, translation,
# log-scale]; the file order is [translation, quaternion vector,
# log-scale].  Rotation rows carry the same dq = d(aa)/2 chart factor;
# the scale row is already in log coordinates on both sides.
_PERM7 = np.array([3, 4, 5, 0, 1, 2, 6])
_TRIU7 = np.triu_indices(7)
_CHART_SCALE7 = np.array([0.5, 0.5, 0.5, 1.0, 1.0, 1.0, 1.0])


def _info7_g2o_to_ours(info_g2o: np.ndarray) -> np.ndarray:
    m = info_g2o[..., _PERM7[:, None], _PERM7[None, :]]
    return m * _CHART_SCALE7[:, None] * _CHART_SCALE7[None, :]


def _info7_ours_to_g2o(info_ours: np.ndarray) -> np.ndarray:
    inv = np.argsort(_PERM7)
    m = info_ours / (_CHART_SCALE7[:, None] * _CHART_SCALE7[None, :])
    return m[..., inv[:, None], inv[None, :]]


def _lift_se2_info(info3: np.ndarray) -> np.ndarray:
    """SE(2) info over (x, y, theta) [..., 3, 3] -> our 6x6 [rot, t].

    In-plane entries land on rows [rz(=2), tx(=3), ty(=4)]; the three
    out-of-plane rows (rx, ry, tz) get unit weight so lifted edges pin
    relative out-of-plane motion to zero.
    """
    out = np.tile(np.eye(6), (*info3.shape[:-2], 1, 1))
    # our row indices: theta -> 2 (z rotation), x -> 3, y -> 4
    idx = np.array([3, 4, 2])  # g2o (x, y, theta) -> our rows
    out[..., idx[:, None], idx[None, :]] = info3
    return out


def _assemble_sim3(s_verts, s_e_ids, s_e_vals, s_e_lns, fixed_ids,
                   had_fix) -> "G2OGraph":
    """Batch-assemble a VERTEX/EDGE_SIM3:QUAT graph (poses/meas [*, 7]
    = [angle_axis, translation, log-scale])."""
    if not s_verts:
        raise ValueError("no supported VERTEX records found")
    ids = np.array(sorted(s_verts), dtype=np.int64)
    index = {vid: k for k, vid in enumerate(ids)}

    raw_v = np.asarray([s_verts[vid][0] for vid in ids],
                       np.float64).reshape(-1, 8)
    bad_v = ~np.isfinite(raw_v).all(axis=1)
    if bad_v.any():
        k = int(np.argmax(bad_v))
        vid = int(ids[k])
        raise ValueError(
            f"line {s_verts[vid][1]}: VERTEX {vid} has non-finite "
            "values — a NaN/inf estimate would poison every solver "
            "reduction; fix or drop the record")
    bad_s = raw_v[:, 7] <= 0
    if bad_s.any():
        k = int(np.argmax(bad_s))
        vid = int(ids[k])
        raise ValueError(
            f"line {s_verts[vid][1]}: VERTEX_SIM3:QUAT {vid} has "
            f"non-positive scale {raw_v[k, 7]:g} — a sim(3) scale must "
            "be > 0 (the chart stores log-scale)")
    poses = np.concatenate(
        [_quat_xyzw_to_aa(raw_v[:, 3:7]), raw_v[:, :3],
         np.log(raw_v[:, 7:8])], axis=1)

    n_e = len(s_e_ids)
    for (a, b), ln in zip(s_e_ids, s_e_lns):
        if a not in index or b not in index:
            missing = a if a not in index else b
            raise ValueError(
                f"line {ln}: EDGE_SIM3:QUAT references unknown vertex "
                f"{missing}")
    edge_i = np.asarray([index[i] for i, _ in s_e_ids],
                        np.int32).reshape(n_e)
    edge_j = np.asarray([index[j] for _, j in s_e_ids],
                        np.int32).reshape(n_e)
    if n_e:
        raw_e = np.asarray(s_e_vals, np.float64).reshape(-1, 36)
        bad_e = ~np.isfinite(raw_e).all(axis=1)
        if bad_e.any():
            k = int(np.argmax(bad_e))
            raise ValueError(
                f"line {s_e_lns[k]}: EDGE {s_e_ids[k][0]} -> "
                f"{s_e_ids[k][1]} has non-finite "
                "measurement/information values — a NaN/inf factor "
                "would poison every solver reduction; fix or drop the "
                "record")
        bad_ms = raw_e[:, 7] <= 0
        if bad_ms.any():
            k = int(np.argmax(bad_ms))
            raise ValueError(
                f"line {s_e_lns[k]}: EDGE_SIM3:QUAT {s_e_ids[k][0]} -> "
                f"{s_e_ids[k][1]} has non-positive scale "
                f"{raw_e[k, 7]:g} — a sim(3) scale must be > 0")
        meas = np.concatenate(
            [_quat_xyzw_to_aa(raw_e[:, 3:7]), raw_e[:, :3],
             np.log(raw_e[:, 7:8])], axis=1)
        info = _info7_g2o_to_ours(
            _upper_tri_to_full_batch(raw_e[:, 8:], 7))
    else:
        meas = np.zeros((0, 7))
        info = np.zeros((0, 7, 7))

    fixed = np.zeros(len(ids), bool)
    for vid in fixed_ids:
        if vid in index:
            fixed[index[vid]] = True
    had_fix = had_fix and bool(fixed.any())
    if not fixed.any():
        fixed[0] = True
    return G2OGraph(poses=poses, edge_i=edge_i, edge_j=edge_j, meas=meas,
                    info=info, fixed=fixed, ids=ids, se2=False,
                    had_fix=had_fix, sim3=True)


def _open_text(path: str, mode: str = "rt"):
    """Open a (possibly .gz / .bz2 compressed) text file — public
    pose-graph datasets ship in all three forms."""
    lower = path.lower()
    if lower.endswith(".gz"):
        import gzip

        return gzip.open(path, mode)
    if lower.endswith(".bz2"):
        import bz2

        return bz2.open(path, mode)
    return open(path, mode)


def read_g2o(source: Union[str, TextIO]) -> G2OGraph:
    """Parse a .g2o file (SE3:QUAT or SE2 records; FIX supported;
    .gz/.bz2 transparently decompressed)."""
    if isinstance(source, str):
        with _open_text(source) as f:
            return read_g2o(f)

    # Parse into flat per-tag token lists first; ALL numeric work (float
    # conversion, tri -> full info expansion, permutation/chart, quat ->
    # angle-axis) happens once on batched numpy arrays afterwards — a
    # per-line conversion costs more than the whole batched pass on
    # files with tens of thousands of records.
    verts: dict[int, tuple[bool, list, int]] = {}  # vid -> (se2, toks, ln)
    fixed_ids: set[int] = set()
    e_ids: list[tuple[int, int]] = []
    e_se2: list[bool] = []
    e_vals: list[list] = []  # SE3: 28 tokens; SE2: 9 tokens
    e_lns: list[int] = []  # source line of each edge (error context)
    p_ids: list[int] = []  # EDGE_SE3_PRIOR anchored vertex ids
    p_vals: list[list] = []  # 28 tokens (7 meas + 21 info)
    p_lns: list[int] = []
    s_verts: dict[int, tuple[list, int]] = {}  # sim3 vid -> (toks, ln)
    s_e_ids: list[tuple[int, int]] = []
    s_e_vals: list[list] = []  # 36 tokens (8 meas + 28 info)
    s_e_lns: list[int] = []
    se2_seen = False
    se3_seen = False
    sim3_seen = False
    had_fix = False

    def _no_mix(ln: int, tag: str) -> None:
        # Sim(3) and SE(2)/SE(3) records describe different state
        # manifolds; a mixed file has no single solver to go to.
        if tag.startswith(("VERTEX_SIM3", "EDGE_SIM3")):
            if se3_seen or se2_seen or p_ids:
                raise ValueError(
                    f"line {ln}: {tag} cannot be mixed with "
                    "SE(2)/SE(3) records in one file — split the graph")
        elif sim3_seen:
            raise ValueError(
                f"line {ln}: {tag} cannot be mixed with SIM3 records "
                "in one file — split the graph")

    for ln, line in enumerate(source, 1):
        tok = line.split()
        if not tok or tok[0].startswith("#"):
            continue
        tag = tok[0]
        if tag == "VERTEX_SE3:QUAT":
            _no_mix(ln, tag)
            if len(tok) != 9:
                raise ValueError(
                    f"line {ln}: VERTEX_SE3:QUAT needs 7 values "
                    f"(x y z qx qy qz qw), got {max(0, len(tok) - 2)} "
                    f"({len(tok)} tokens)")
            vid = int(tok[1])
            if vid in verts:
                raise ValueError(f"line {ln}: duplicate VERTEX id {vid}")
            verts[vid] = (False, tok[2:], ln)
            se3_seen = True
        elif tag == "VERTEX_SE2":
            _no_mix(ln, tag)
            if len(tok) != 5:
                raise ValueError(
                    f"line {ln}: VERTEX_SE2 needs 3 values (x y theta), "
                    f"got {max(0, len(tok) - 2)} ({len(tok)} tokens)")
            vid = int(tok[1])
            if vid in verts:
                raise ValueError(f"line {ln}: duplicate VERTEX id {vid}")
            verts[vid] = (True, tok[2:], ln)
            se2_seen = True
        elif tag == "EDGE_SE3:QUAT":
            _no_mix(ln, tag)
            if len(tok) != 3 + 7 + 21:
                raise ValueError(
                    f"line {ln}: EDGE_SE3:QUAT needs 7 measurement + 21 "
                    f"info values, got {max(0, len(tok) - 3)} "
                    f"({len(tok)} tokens)")
            e_ids.append((int(tok[1]), int(tok[2])))
            e_se2.append(False)
            e_vals.append(tok[3:])
            e_lns.append(ln)
            se3_seen = True
        elif tag == "EDGE_SE2":
            _no_mix(ln, tag)
            if len(tok) != 3 + 3 + 6:
                raise ValueError(
                    f"line {ln}: EDGE_SE2 needs 3 measurement + 6 info "
                    f"values, got {max(0, len(tok) - 3)} "
                    f"({len(tok)} tokens)")
            e_ids.append((int(tok[1]), int(tok[2])))
            e_se2.append(True)
            e_vals.append(tok[3:])
            e_lns.append(ln)
            se2_seen = True
        elif tag == "EDGE_SE3_PRIOR":
            _no_mix(ln, tag)
            # Our dialect: 1 vertex id + 7 measurement + 21 info = 29
            # tokens.  The upstream g2o type ALSO carries an offset
            # PARAMS id as token 2 (30 tokens) — refused typed rather
            # than mis-read: swallowing a sensor-offset transform would
            # silently anchor the pose to the wrong frame.
            if len(tok) == 2 + 1 + 7 + 21:
                raise ValueError(
                    f"line {ln}: EDGE_SE3_PRIOR with an offset PARAMS "
                    "id (30-token upstream-g2o form) is not supported "
                    "— bake the sensor offset into the measurement and "
                    "drop the id")
            if len(tok) != 2 + 7 + 21:
                raise ValueError(
                    f"line {ln}: EDGE_SE3_PRIOR needs 7 measurement + "
                    f"21 info values after the vertex id, got "
                    f"{max(0, len(tok) - 2)} ({len(tok)} tokens)")
            p_ids.append(int(tok[1]))
            p_vals.append(tok[2:])
            p_lns.append(ln)
            se3_seen = True
        elif tag == "VERTEX_SIM3:QUAT":
            _no_mix(ln, tag)
            if len(tok) != 10:
                raise ValueError(
                    f"line {ln}: VERTEX_SIM3:QUAT needs 8 values "
                    f"(x y z qx qy qz qw s), got "
                    f"{max(0, len(tok) - 2)} ({len(tok)} tokens)")
            vid = int(tok[1])
            if vid in s_verts:
                raise ValueError(f"line {ln}: duplicate VERTEX id {vid}")
            s_verts[vid] = (tok[2:], ln)
            sim3_seen = True
        elif tag == "EDGE_SIM3:QUAT":
            _no_mix(ln, tag)
            if len(tok) != 3 + 8 + 28:
                raise ValueError(
                    f"line {ln}: EDGE_SIM3:QUAT needs 8 measurement + "
                    f"28 info values, got {max(0, len(tok) - 3)} "
                    f"({len(tok)} tokens)")
            s_e_ids.append((int(tok[1]), int(tok[2])))
            s_e_vals.append(tok[3:])
            s_e_lns.append(ln)
            sim3_seen = True
        elif tag == "FIX":
            had_fix = True
            fixed_ids.update(int(t) for t in tok[1:])
        # Unknown tags (VERTEX_TRACKXYZ, landmark edges, ...) are
        # skipped: partial ingestion of mixed graphs is standard g2o
        # tool behaviour.

    if sim3_seen:
        return _assemble_sim3(s_verts, s_e_ids, s_e_vals, s_e_lns,
                              fixed_ids, had_fix)

    if not verts:
        raise ValueError("no supported VERTEX records found")
    ids = np.array(sorted(verts), dtype=np.int64)
    index = {vid: k for k, vid in enumerate(ids)}

    def split_rows(flags, toks, width_se3, width_se2):
        """Mixed SE3/SE2 token rows -> ([n,7] pose raw, per-kind floats).

        The [n, 7] form is [t(3), quat_xyzw(4)] with SE2 thetas encoded
        as z-axis quaternions.  Float conversion happens in ONE numpy
        call per kind (C-level string parsing).
        """
        flags = np.asarray(flags, bool)
        se3_rows = np.nonzero(~flags)[0]
        se2_rows = np.nonzero(flags)[0]
        se3_raw = np.asarray(
            [toks[k] for k in se3_rows], np.float64).reshape(-1, width_se3)
        se2_raw = np.asarray(
            [toks[k] for k in se2_rows], np.float64).reshape(-1, width_se2)
        raw7 = np.zeros((len(toks), 7))
        raw7[:, 6] = 1.0  # identity quaternion default
        raw7[se3_rows] = se3_raw[:, :7]
        raw7[se2_rows, 0] = se2_raw[:, 0]
        raw7[se2_rows, 1] = se2_raw[:, 1]
        raw7[se2_rows, 5] = np.sin(se2_raw[:, 2] / 2)
        raw7[se2_rows, 6] = np.cos(se2_raw[:, 2] / 2)
        return raw7, se3_raw, se2_raw, se3_rows, se2_rows

    raw_v, _, _, _, _ = split_rows(
        [verts[vid][0] for vid in ids],
        [verts[vid][1] for vid in ids], 7, 3)
    bad_v = ~np.isfinite(raw_v).all(axis=1)
    if bad_v.any():
        k = int(np.argmax(bad_v))
        vid = int(ids[k])
        raise ValueError(
            f"line {verts[vid][2]}: VERTEX {vid} has non-finite "
            "values — a NaN/inf estimate would poison every solver "
            "reduction; fix or drop the record")
    poses = np.concatenate(
        [_quat_xyzw_to_aa(raw_v[:, 3:7]), raw_v[:, :3]], axis=1)

    n_e = len(e_ids)
    try:
        edge_i = np.asarray([index[i] for i, _ in e_ids],
                            np.int32).reshape(n_e)
        edge_j = np.asarray([index[j] for _, j in e_ids],
                            np.int32).reshape(n_e)
    except KeyError as exc:
        raise ValueError(
            f"edge references unknown vertex {exc.args[0]}") from None
    if n_e:
        raw_e, se3_raw, se2_raw, se3_rows, se2_rows = split_rows(
            e_se2, e_vals, 28, 9)
        bad_rows = np.zeros(n_e, bool)
        # The full token payload (measurement AND information entries)
        # must be finite; check per kind, then map back to source lines.
        bad_rows[se3_rows] = ~np.isfinite(se3_raw).all(axis=1)
        bad_rows[se2_rows] = ~np.isfinite(se2_raw).all(axis=1)
        if bad_rows.any():
            k = int(np.argmax(bad_rows))
            raise ValueError(
                f"line {e_lns[k]}: EDGE {e_ids[k][0]} -> {e_ids[k][1]} "
                "has non-finite measurement/information values — a "
                "NaN/inf factor would poison every solver reduction; "
                "fix or drop the record")
        meas = np.concatenate(
            [_quat_xyzw_to_aa(raw_e[:, 3:7]), raw_e[:, :3]], axis=1)
        info = np.zeros((n_e, 6, 6))
        if se3_rows.size:
            info[se3_rows] = _info_g2o_to_ours(
                _upper_tri_to_full_batch(se3_raw[:, 7:], 6))
        if se2_rows.size:
            info[se2_rows] = _lift_se2_info(
                _upper_tri_to_full_batch(se2_raw[:, 3:], 3))
    else:
        meas = np.zeros((0, 6))
        info = np.zeros((0, 6, 6))

    # ---- unary pose priors (EDGE_SE3_PRIOR) --------------------------
    prior_idx = np.zeros(0, np.int32)
    prior_meas = np.zeros((0, 6))
    prior_info = np.zeros((0, 6, 6))
    if p_ids:
        rows = []
        for vid, ln in zip(p_ids, p_lns):
            if vid not in index:
                raise ValueError(
                    f"line {ln}: EDGE_SE3_PRIOR references unknown "
                    f"vertex {vid}")
            rows.append(index[vid])
        prior_idx = np.asarray(rows, np.int32)
        raw_p = np.asarray(p_vals, np.float64).reshape(-1, 28)
        bad_p = ~np.isfinite(raw_p).all(axis=1)
        if bad_p.any():
            k = int(np.argmax(bad_p))
            raise ValueError(
                f"line {p_lns[k]}: EDGE_SE3_PRIOR on vertex "
                f"{p_ids[k]} has non-finite measurement/information "
                "values — a NaN/inf anchor would poison every solver "
                "reduction; fix or drop the record")
        prior_meas = np.concatenate(
            [_quat_xyzw_to_aa(raw_p[:, 3:7]), raw_p[:, :3]], axis=1)
        prior_info = _info_g2o_to_ours(
            _upper_tri_to_full_batch(raw_p[:, 7:], 6))

    fixed = np.zeros(len(ids), bool)
    for vid in fixed_ids:
        if vid in index:
            fixed[index[vid]] = True
    # had_fix must mean "the output's FIX rows came from the file":
    # a FIX that only referenced skipped vertices (mixed graphs with
    # unknown tags) leaves nothing anchored, and the fallback anchor
    # below is ours, not the file's.
    had_fix = had_fix and bool(fixed.any())
    if not fixed.any():
        fixed[0] = True  # gauge anchor, same default as solve_pgo

    return G2OGraph(poses=poses, edge_i=edge_i, edge_j=edge_j, meas=meas,
                    info=info, fixed=fixed, ids=ids,
                    se2=se2_seen and not se3_seen, had_fix=had_fix,
                    prior_idx=prior_idx, prior_meas=prior_meas,
                    prior_info=prior_info)


def write_g2o(dest: Union[str, TextIO], graph: G2OGraph,
              poses: Optional[np.ndarray] = None) -> None:
    """Write SE3:QUAT records (optionally with updated poses).

    Always writes the SE(3) form — lifted SE(2) graphs round-trip
    through it losslessly (z/roll/pitch stay zero at the optimum).
    A .gz/.bz2 destination is compressed transparently.  FIX records
    are written only when the graph carried them (``had_fix``): the
    solver's default gauge anchor (fixed[0]) is an internal choice, and
    materializing it would hand external g2o consumers a FIX the
    original file never declared.
    """
    if isinstance(dest, str):
        with _open_text(dest, "wt") as f:
            write_g2o(f, graph, poses)
        return

    p = np.asarray(graph.poses if poses is None else poses)
    quat_v = _aa_to_quat_xyzw(p[:, :3])
    if graph.sim3:
        for k, vid in enumerate(graph.ids):
            t = p[k, 3:6]
            q = quat_v[k]
            dest.write(
                f"VERTEX_SIM3:QUAT {int(vid)} "
                f"{t[0]:.9g} {t[1]:.9g} {t[2]:.9g} "
                f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g} "
                f"{np.exp(p[k, 6]):.9g}\n")
    else:
        for k, vid in enumerate(graph.ids):
            t = p[k, 3:]
            q = quat_v[k]
            dest.write(
                f"VERTEX_SE3:QUAT {int(vid)} "
                f"{t[0]:.9g} {t[1]:.9g} {t[2]:.9g} "
                f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g}\n")
    if graph.had_fix:
        for k in range(len(graph.ids)):
            if graph.fixed[k]:
                dest.write(f"FIX {int(graph.ids[k])}\n")
    meas_q = _aa_to_quat_xyzw(graph.meas[:, :3])
    if graph.sim3:
        tri_all = _info7_ours_to_g2o(graph.info)[:, _TRIU7[0], _TRIU7[1]]
        for e in range(graph.edge_i.shape[0]):
            m_t = graph.meas[e, 3:6]
            q = meas_q[e]
            tri = " ".join(f"{v:.9g}" for v in tri_all[e])
            dest.write(
                f"EDGE_SIM3:QUAT {int(graph.ids[graph.edge_i[e]])} "
                f"{int(graph.ids[graph.edge_j[e]])} "
                f"{m_t[0]:.9g} {m_t[1]:.9g} {m_t[2]:.9g} "
                f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g} "
                f"{np.exp(graph.meas[e, 6]):.9g} {tri}\n")
        return
    tri_all = _info_ours_to_g2o(graph.info)[:, _TRIU[0], _TRIU[1]]
    for e in range(graph.edge_i.shape[0]):
        m_t = graph.meas[e, 3:]
        q = meas_q[e]
        tri = " ".join(f"{v:.9g}" for v in tri_all[e])
        dest.write(
            f"EDGE_SE3:QUAT {int(graph.ids[graph.edge_i[e]])} "
            f"{int(graph.ids[graph.edge_j[e]])} "
            f"{m_t[0]:.9g} {m_t[1]:.9g} {m_t[2]:.9g} "
            f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g} {tri}\n")
    if graph.prior_idx.shape[0]:
        pq = _aa_to_quat_xyzw(graph.prior_meas[:, :3])
        ptri = _info_ours_to_g2o(graph.prior_info)[:, _TRIU[0], _TRIU[1]]
        for e in range(graph.prior_idx.shape[0]):
            m_t = graph.prior_meas[e, 3:]
            q = pq[e]
            tri = " ".join(f"{v:.9g}" for v in ptri[e])
            dest.write(
                f"EDGE_SE3_PRIOR {int(graph.ids[graph.prior_idx[e]])} "
                f"{m_t[0]:.9g} {m_t[1]:.9g} {m_t[2]:.9g} "
                f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g} {tri}\n")


def sqrt_info_of(graph: G2OGraph) -> Optional[np.ndarray]:
    """Matrix square-root weights W of the edge info matrices.

    ||W r||^2 = r^T Omega r, i.e. W^T W = Omega.  Uses a symmetric
    eigendecomposition rather than Cholesky so positive-SEMIdefinite
    matrices (a zero row = deliberately unconstrained DOF, common in
    partial-sensor exports) factor cleanly instead of crashing; small
    negative eigenvalues from text round-off are clamped to zero.
    Returns None when every info matrix is the identity (the unweighted
    fast path).
    """
    n = graph.info.shape[-1]  # 6 (SE3) or 7 (sim3)
    if np.allclose(graph.info, np.eye(n)[None]):
        return None
    from megba_tpu_torch.core.linalg import psd_sqrt

    return psd_sqrt(graph.info, what="edge")


def solve_g2o(source, option=None, verbose: bool = False,
              init: str = "file",
              prior_ids=None, prior_weight: float = 1e4, device=None):
    """Read (path / file / G2OGraph), solve, return (graph, PGOResult).

    `device` is `solve_pgo`'s: None is `option.device` (the card by
    default), "cpu" the plain PyTorch path, a sequence of devices for
    `option.world_size` > 1.

    `init="spanning_tree"` re-initializes poses by composing
    measurements along a BFS spanning tree from the anchors
    (models/pgo.spanning_tree_init) instead of trusting the file's
    VERTEX estimates — the standard bootstrap for exports with garbage
    or missing initial guesses.

    `prior_ids` (g2o VERTEX ids) anchors those poses at their FILE
    estimates via unary prior factors weighted `prior_weight * I`
    (models/pgo.with_priors) — the surveying workflow of holding known
    stations softly instead of hard-FIXing them.  File-carried
    ``EDGE_SE3_PRIOR`` records ride the same machinery with their OWN
    measured poses and information (W = psd_sqrt(Omega)), composing
    with `prior_ids`.  The returned result's poses are sliced back to
    the graph's own poses (the virtual anchor poses are internal).

    Sim(3) graphs (``graph.sim3``) dispatch the ``sim3_between``
    factor; `prior_ids` and `init="spanning_tree"` are SE(3)-only and
    refused typed there.
    """
    from megba_tpu_torch.models.pgo import (
        solve_pgo, spanning_tree_init, with_priors)

    graph = source if isinstance(source, G2OGraph) else read_g2o(source)
    n = graph.poses.shape[0]
    poses0 = graph.poses
    edge_i, edge_j, meas = graph.edge_i, graph.edge_j, graph.meas
    fixed = graph.fixed
    sqrt_info = sqrt_info_of(graph)
    if graph.sim3:
        if prior_ids is not None and len(prior_ids) > 0:
            raise ValueError(
                "prior_ids anchors via SE(3) unary priors "
                "(models/pgo.with_priors) and is not supported for "
                "sim(3) graphs")
        if init == "spanning_tree":
            raise ValueError(
                "init='spanning_tree' composes SE(3) odometry and is "
                "not supported for sim(3) graphs; use init='file'")
        if init != "file":
            raise ValueError(f"init must be 'file' or 'spanning_tree', "
                             f"got {init!r}")
        result = solve_pgo(poses0, edge_i, edge_j, meas, option,
                           sqrt_info=sqrt_info, fixed=fixed,
                           verbose=verbose, factor="sim3_between",
                           device=device)
        return graph, result
    file_p = int(graph.prior_idx.shape[0])
    user_idx = np.zeros(0, np.int32)
    if prior_ids is not None and len(prior_ids) > 0:
        index = {int(vid): k for k, vid in enumerate(graph.ids)}
        try:
            user_idx = np.array([index[int(v)] for v in prior_ids],
                                np.int32)
        except KeyError as exc:
            raise ValueError(
                f"prior id {exc.args[0]} is not a vertex of this graph"
            ) from None
    if file_p or user_idx.shape[0]:
        # File priors first, then the caller's soft anchors; both ride
        # with_priors as one combined prior set.
        idx = np.concatenate(
            [graph.prior_idx.astype(np.int32), user_idx])
        prior_poses = np.concatenate(
            [graph.prior_meas, graph.poses[user_idx]])
        if file_p:
            from megba_tpu_torch.core.linalg import psd_sqrt

            w_file = psd_sqrt(graph.prior_info, what="prior")
        else:
            w_file = np.zeros((0, 6, 6))
        w_user = np.broadcast_to(
            np.eye(6) * float(prior_weight),
            (user_idx.shape[0], 6, 6))
        prior_W = np.concatenate([w_file, w_user])
        p = idx.shape[0]
        # Priors carry the gauge; the parser's defaulted anchor (a FIX
        # the file never declared) would fight them.  File-declared FIX
        # records are kept.  The default anchor is decided PER CONNECTED
        # COMPONENT: a component some prior reaches gets its gauge from
        # that prior (keeping a hard anchor there would bias the solve
        # toward the file estimate — the exact conflict this path
        # avoids); a component no prior reaches is anchored at one of
        # its OWN poses (the parser's fixed[0] only covers pose 0's
        # component; an unreached component would otherwise keep a free
        # 6-DOF gauge and a singular system).
        if not graph.had_fix:
            from collections import deque

            adj: list[list[int]] = [[] for _ in range(n)]
            for a, b in zip(np.asarray(edge_i), np.asarray(edge_j)):
                adj[int(a)].append(int(b))
                adj[int(b)].append(int(a))
            comp = np.full(n, -1, np.int64)
            n_comp = 0
            for start in range(n):
                if comp[start] >= 0:
                    continue
                comp[start] = n_comp
                queue = deque([start])
                while queue:
                    a = queue.popleft()
                    for b in adj[a]:
                        if comp[b] < 0:
                            comp[b] = n_comp
                            queue.append(b)
                n_comp += 1
            has_prior = np.zeros(n_comp, bool)
            has_prior[comp[idx]] = True
            fixed = np.zeros(n, bool)
            # First member of every component in one pass (labels are
            # assigned in first-occurrence order, so unique's sorted
            # values are 0..n_comp-1 and return_index gives the first
            # pose of each) — a per-component argmax scan would go
            # quadratic on fragmented FIX-less graphs.
            _, first = np.unique(comp, return_index=True)
            fixed[first[~has_prior]] = True
        poses0, edge_i, edge_j, meas, fixed, sqrt_info = with_priors(
            poses0, edge_i, edge_j, meas,
            prior_idx=idx, prior_poses=prior_poses,
            prior_sqrt_info=prior_W,
            fixed=fixed, sqrt_info=sqrt_info)
    if init == "spanning_tree":
        poses0 = spanning_tree_init(poses0, edge_i, edge_j, meas, fixed)
    elif init != "file":
        raise ValueError(f"init must be 'file' or 'spanning_tree', "
                         f"got {init!r}")
    result = solve_pgo(
        poses0, edge_i, edge_j, meas,
        option, sqrt_info=sqrt_info, fixed=fixed,
        verbose=verbose, device=device)
    if result.poses.shape[0] != n:  # drop internal virtual anchors
        result = result._replace(poses=result.poses[:n])
    return graph, result

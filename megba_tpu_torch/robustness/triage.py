"""Pre-flight problem triage: host-side health checks + auto-repair.

Counterpart of `megba_tpu/robustness/triage.py`, the same checks,
repairs, reports and names, in NumPy: it launches nothing and imports
no CUDA code.  The on-device guards (RobustOption) pay device time, or
a whole failed solve, to discover that a problem was broken on arrival.
The edge-wise BA formulation makes those failure modes statically
predictable from the observation graph and the initial estimate, on
the host:

- a point observed by fewer than two cameras has a (near-)singular Hll
  block — multiplicative LM damping scales its diagonal, it cannot fill
  the single-ray null space, so the Schur complement inherits the
  conditioning blow-up the PCG guards later fight;
- a disconnected camera component carries its own unanchored gauge —
  the system is structurally rank-deficient no matter the data;
- behind-camera / near-plane observations poison the FIRST
  linearisation (the -P/P.z projection divides by ~0), before any
  guard has an accepted state to roll back to;
- non-finite parameters or observations NaN-poison every reduced
  scalar the solver computes;
- duplicate (cam, pt) edges double-count a factor;
- near-zero-parallax points make depth unobservable (near-singular Hll
  again, just through geometry instead of degree);
- extreme initial reprojection residuals are the gross outliers that
  stall the first trust-region steps.

This module detects all of the above in one structural pass (NumPy over
the index arrays) plus one vectorised geometric pass through the
factor's host projection hooks (io/synthetic.project_batch_depth for
BAL), and either REJECTs the problem (typed `ProblemRejected` carrying
the `HealthReport`, before any tensor reaches a device), REPAIRs it
deterministically with machinery the solver already trusts, or WARNs
(report attached, solve unchanged).

Repairs never re-index: every array keeps its shape.

- degenerate points (deg < 2, behind-camera remnants, non-finite) are
  frozen via `pt_fixed` and their edges soft-deleted through the
  `edge_mask` operand (literal-zero contributions to every reduction);
- non-finite parameter blocks are additionally SANITISED to zeros on
  host — the edge mask multiplies residuals, and 0 * NaN is NaN, so a
  masked edge reading NaN params would still poison the cost;
- secondary connected components get one anchor camera each
  (`cam_fixed`), the same anchor-per-component policy the g2o reader
  applies to prior-less pose graphs (io/g2o.py);
- extreme-residual edges are DOWNWEIGHTED through the robust-kernel
  weight (ops/robust.rho_and_weight) folded into the edge mask: the
  mask multiplies r and J, so a mask value of sqrt(w) applies exactly
  the Huber weight w at the initial residual — a static one-shot
  robustification riding an operand the solve already has.
"""

from __future__ import annotations

import dataclasses
import enum
import types
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from megba_tpu_torch.utils.timing import monotonic_s


def _default_bal_hooks():
    """The BAL geometric hooks (host NumPy, io/synthetic) that
    `factor=None` callers get.

    Duck-typed (SimpleNamespace with the `factors.FactorTriage` field
    names) rather than the registry dataclass itself: importing the
    factors package would pull the torch residual modules in.  Callers
    that hold a registered spec pass it via `factor=`; its `triage`
    attribute carries the real `FactorTriage` hooks, which this module
    only reads attributes off.
    """
    from megba_tpu_torch.io.synthetic import camera_centers, project_batch_depth

    def project(cam_blocks, pt_blocks, obs):
        del obs
        return project_batch_depth(cam_blocks, pt_blocks)

    return types.SimpleNamespace(project_depth=project, uv_cols=(0, 2),
                                 camera_centers=camera_centers)


# Chunk size for the geometric pass: bounds the [nE, 3] float64
# temporaries the projection materialises (same budget reasoning as
# io/synthetic's generation chunking).
_GEOM_CHUNK = 4_000_000


class TriageAction(enum.Enum):
    """What to do with a problem that has degenerate findings."""

    REJECT = "reject"  # raise ProblemRejected; nothing reaches a device
    REPAIR = "repair"  # apply deterministic repairs, then solve
    WARN = "warn"  # attach the report, solve the problem as submitted


class CheckKind(enum.Enum):
    """One pre-flight check.  `degenerate` marks the kinds that predict
    a broken/poisoned solve (they drive `TriagePolicy.on_degenerate`);
    advisory kinds only ever annotate the report."""

    NONFINITE_CAMERA = "nonfinite_camera"
    NONFINITE_POINT = "nonfinite_point"
    NONFINITE_OBS = "nonfinite_obs"
    DUPLICATE_EDGE = "duplicate_edge"
    ORPHAN_CAMERA = "orphan_camera"  # degree 0 (advisory: runtime contains it)
    UNDER_CONSTRAINED_POINT = "under_constrained_point"  # deg < min_point_degree
    UNDER_CONSTRAINED_CAMERA = "under_constrained_camera"  # advisory
    DISCONNECTED = "disconnected"  # > 1 connected component (gauge-deficient)
    BEHIND_CAMERA = "behind_camera"  # cheirality violation at the initial estimate
    LOW_PARALLAX = "low_parallax"  # max ray spread below threshold
    EXTREME_RESIDUAL = "extreme_residual"  # initial reprojection outlier


# The kinds whose presence makes the problem "degenerate" — i.e. the
# statically-predicted solve-breakers the policy's on_degenerate action
# applies to.  ORPHAN_CAMERA and UNDER_CONSTRAINED_CAMERA are advisory:
# the system builder already gives edge-less blocks an identity
# (linear_system/builder.py) and damping bounds a weakly-observed
# camera, so neither predicts a failed solve.
DEGENERATE_KINDS = frozenset({
    CheckKind.NONFINITE_CAMERA,
    CheckKind.NONFINITE_POINT,
    CheckKind.NONFINITE_OBS,
    CheckKind.DUPLICATE_EDGE,
    CheckKind.UNDER_CONSTRAINED_POINT,
    CheckKind.DISCONNECTED,
    CheckKind.BEHIND_CAMERA,
    CheckKind.LOW_PARALLAX,
    CheckKind.EXTREME_RESIDUAL,
})


@dataclasses.dataclass(frozen=True)
class TriagePolicy:
    """Pre-flight policy: which checks run, thresholds, and the action.

    `on_degenerate` picks what happens when any degenerate finding
    (DEGENERATE_KINDS) is present: REJECT raises `ProblemRejected`
    before anything touches a device, REPAIR applies the deterministic
    repairs below, WARN attaches the report and solves as submitted.

    Thresholds: `min_point_degree` is the observation count below which
    a point's Hll block is predicted (near-)singular; `min_depth` is
    the cheirality margin (camera-frame z > -min_depth counts as
    behind/on the camera plane — BAL's visible half-space is z < 0);
    `min_parallax_rad` bounds the per-point viewing-ray spread below
    which depth is unobservable; `max_residual_px` flags initial
    reprojection outliers.  `geometric=False` skips the projection pass
    (structural checks only — e.g. when initial estimates are known
    garbage and a spanning-tree-style bootstrap follows).
    """

    on_degenerate: TriageAction = TriageAction.REJECT
    min_point_degree: int = 2
    # Advisory camera floor, in OBSERVATIONS: each observation is 2
    # residual rows, so the default of 5 flags cameras with <= 4
    # observations (8 rows) — fewer rows than the 9 camera dof.
    min_camera_degree: int = 5
    min_depth: float = 1e-6
    min_parallax_rad: float = 1e-3
    max_residual_px: float = 1e4
    structural: bool = True
    geometric: bool = True
    downweight_outliers: bool = True
    exemplar_cap: int = 8

    def __post_init__(self) -> None:
        if self.min_point_degree < 1:
            raise ValueError(
                f"min_point_degree must be >= 1, got {self.min_point_degree}")
        if self.min_depth < 0 or self.min_parallax_rad < 0:
            raise ValueError("min_depth and min_parallax_rad must be >= 0")
        if not self.max_residual_px > 0:
            raise ValueError(
                f"max_residual_px must be > 0, got {self.max_residual_px}")
        if self.exemplar_cap < 1:
            raise ValueError(
                f"exemplar_cap must be >= 1, got {self.exemplar_cap}")


@dataclasses.dataclass
class Finding:
    """One check's outcome: how many offenders, and a bounded sample.

    `exemplars` are indices in the check's own axis (camera / point /
    edge index — see `CheckKind`), capped at `TriagePolicy.exemplar_cap`
    so a million-orphan problem cannot turn its own health report into
    a memory problem."""

    kind: CheckKind
    count: int
    exemplars: List[int]
    detail: str = ""

    @property
    def degenerate(self) -> bool:
        return self.kind in DEGENERATE_KINDS

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind.value, "count": int(self.count),
                "exemplars": [int(i) for i in self.exemplars],
                "degenerate": self.degenerate, "detail": self.detail}


@dataclasses.dataclass
class HealthReport:
    """The pre-flight health record of one problem.

    JSON-round-trippable (rides the REJECT exception); `repair` is
    populated once a repair has been applied."""

    n_cam: int
    n_pt: int
    n_edge: int
    findings: List[Finding]
    n_components: int = 1
    action: Optional[str] = None  # the policy action actually taken
    triage_s: float = 0.0  # host wall clock of the checks
    repair: Optional[Dict[str, int]] = None  # points_fixed / edges_masked / ...
    # Which check families actually ran (TriagePolicy.structural /
    # .geometric): a downstream gate may defer to triage only when the
    # structural pass (which subsumes the duplicate-edge check) really
    # happened.
    structural: bool = True
    geometric: bool = True

    @property
    def degenerate(self) -> bool:
        return any(f.degenerate for f in self.findings)

    def counts(self) -> Dict[str, int]:
        """{check kind: offender count} over the non-empty findings."""
        return {f.kind.value: int(f.count) for f in self.findings}

    def finding(self, kind: CheckKind) -> Optional[Finding]:
        for f in self.findings:
            if f.kind == kind:
                return f
        return None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "n_cam": int(self.n_cam), "n_pt": int(self.n_pt),
            "n_edge": int(self.n_edge),
            "findings": [f.to_dict() for f in self.findings],
            "n_components": int(self.n_components),
            "degenerate": self.degenerate,
            "action": self.action,
            "triage_s": float(self.triage_s),
            "repair": None if self.repair is None else dict(self.repair),
            "structural": bool(self.structural),
            "geometric": bool(self.geometric),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HealthReport":
        return cls(
            n_cam=int(d["n_cam"]), n_pt=int(d["n_pt"]),
            n_edge=int(d["n_edge"]),
            findings=[Finding(kind=CheckKind(f["kind"]),
                              count=int(f["count"]),
                              exemplars=[int(i) for i in f["exemplars"]],
                              detail=f.get("detail", ""))
                      for f in d.get("findings", [])],
            n_components=int(d.get("n_components", 1)),
            action=d.get("action"),
            triage_s=float(d.get("triage_s", 0.0)),
            repair=d.get("repair"),
            structural=bool(d.get("structural", True)),
            geometric=bool(d.get("geometric", True)),
        )

    def summary(self) -> str:
        parts = [f"{f.count} {f.kind.value}" for f in self.findings]
        head = (f"triage: {self.n_cam} cams / {self.n_pt} pts / "
                f"{self.n_edge} edges, {self.n_components} component(s)")
        return head + (": " + ", ".join(parts) if parts else ": clean")


class ProblemRejected(ValueError):
    """Raised when `TriagePolicy(on_degenerate=REJECT)` refuses a
    degenerate problem.  Carries the full `HealthReport` — and the
    contract that NOTHING was dispatched to a device: triage runs
    before lowering, so a rejected problem costs host milliseconds."""

    def __init__(self, report: HealthReport):
        self.report = report
        bad = ", ".join(f"{f.count} {f.kind.value}"
                        for f in report.findings if f.degenerate)
        super().__init__(
            f"problem rejected by pre-flight triage: {bad} "
            f"({report.n_cam} cams / {report.n_pt} pts / "
            f"{report.n_edge} edges)")


@dataclasses.dataclass
class TriageRepair:
    """The deterministic repair derived from a HealthReport.

    Everything is an OPERAND of the existing programs: `edge_mask`
    multiplies into the solve's padding mask (0 = soft-deleted edge,
    (0, 1) = robust downweight), `cam_fixed` / `pt_fixed` freeze
    parameter blocks, and `cameras` / `points` / `obs` are the
    host-sanitised arrays (non-finite values replaced by zeros on
    masked/frozen entries ONLY — a masked edge still multiplies its
    residual by 0, and 0 * NaN is NaN, so poison must be scrubbed at
    the source).  Fields are None when that aspect needed no repair.
    """

    edge_mask: Optional[np.ndarray] = None  # [nE] float64 in [0, 1]
    cam_fixed: Optional[np.ndarray] = None  # [Nc] bool
    pt_fixed: Optional[np.ndarray] = None  # [Np] bool
    cameras: Optional[np.ndarray] = None  # sanitised replacements
    points: Optional[np.ndarray] = None
    obs: Optional[np.ndarray] = None
    points_fixed: int = 0
    cams_fixed: int = 0  # frozen camera blocks (anchors included)
    cams_anchored: int = 0  # the gauge-anchor subset of cams_fixed
    edges_masked: int = 0
    edges_downweighted: int = 0

    @property
    def is_noop(self) -> bool:
        # Keyed on the OPERANDS, not the counters: a repair that only
        # freezes/sanitises a zero-degree non-finite camera has no
        # masked edges or anchors, yet must still be applied (the NaN
        # params would otherwise dispatch unscrubbed).
        return (self.edge_mask is None and self.cam_fixed is None
                and self.pt_fixed is None and self.cameras is None
                and self.points is None and self.obs is None)

    def counters(self) -> Dict[str, int]:
        return {
            "points_fixed": int(self.points_fixed),
            "cams_fixed": int(self.cams_fixed),
            "cams_anchored": int(self.cams_anchored),
            "edges_masked": int(self.edges_masked),
            "edges_downweighted": int(self.edges_downweighted),
        }

    def merge_operands(self, edge_mask=None, cam_fixed=None, pt_fixed=None):
        """Compose this repair with caller-supplied operands: edge masks
        MULTIPLY (a caller-deleted edge stays deleted, a downweight
        stacks), fixed masks OR: the one definition solve.flat_solve
        uses.  Returns (edge_mask, cam_fixed,
        pt_fixed), each None when neither side supplied it."""
        em = self.edge_mask
        if em is not None and edge_mask is not None:
            em = np.asarray(edge_mask, np.float64).reshape(-1) * em
        elif em is None:
            em = edge_mask
        cf = self.cam_fixed
        if cf is not None and cam_fixed is not None:
            cf = np.asarray(cam_fixed, bool).reshape(-1) | cf
        elif cf is None:
            cf = cam_fixed
        pf = self.pt_fixed
        if pf is not None and pt_fixed is not None:
            pf = np.asarray(pt_fixed, bool).reshape(-1) | pf
        elif pf is None:
            pf = pt_fixed
        return em, cf, pf

    def merged_arrays(self, cameras, points, obs):
        """(cameras, points, obs) with this repair's host sanitisation
        applied — the original arrays wherever nothing was scrubbed."""
        return (cameras if self.cameras is None else self.cameras,
                points if self.points is None else self.points,
                obs if self.obs is None else self.obs)


@dataclasses.dataclass
class TriageOutcome:
    """What `triage_problem` decided: the report, the action taken, and
    the repair (None under WARN, or when the problem was clean)."""

    report: HealthReport
    action: TriageAction
    repair: Optional[TriageRepair] = None


def connected_components(cam_idx: np.ndarray, pt_idx: np.ndarray,
                         n_cam: int, n_pt: int,
                         edge_alive: Optional[np.ndarray] = None,
                         ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Connected components of the bipartite camera-point graph.

    Pure-NumPy min-label propagation with path halving: each round
    propagates the minimum component label across every (alive) edge in
    both directions and then short-circuits label chains; rounds are
    O(nE + Nc + Np) and the count is logarithmic in the graph diameter
    for the hub-and-spoke co-visibility graphs BA produces.  Returns
    (n_components, cam_comp, pt_comp) with labels renumbered 0..k-1 in
    first-occurrence (camera-major) order — deterministic, so repair
    anchors are reproducible.  Vertices with no alive edges form their
    own singleton components.
    """
    ci = np.asarray(cam_idx, np.int64)
    pi = np.asarray(pt_idx, np.int64)
    if edge_alive is not None:
        keep = np.asarray(edge_alive, bool)
        ci, pi = ci[keep], pi[keep]
    label = np.arange(n_cam + n_pt, dtype=np.int64)
    pj = pi + n_cam
    while True:
        before = label
        m = np.minimum(label[ci], label[pj])
        nxt = label.copy()
        np.minimum.at(nxt, ci, m)
        np.minimum.at(nxt, pj, m)
        # Path halving: a label is itself a vertex id, so chasing it one
        # step collapses chains exponentially.
        nxt = np.minimum(nxt, nxt[nxt])
        label = nxt
        if np.array_equal(label, before):
            break
    # Renumber to dense 0..k-1.  np.unique sorts by label VALUE, and a
    # component's label is its minimum vertex id, so sorted order IS
    # first-occurrence order over the camera-major vertex axis.
    uniq, dense = np.unique(label, return_inverse=True)
    return int(uniq.shape[0]), dense[:n_cam], dense[n_cam:]


def huber_weight(s: np.ndarray, delta: float) -> np.ndarray:
    """IRLS weight rho'(s) of the Huber kernel over squared norms s.

    Host-NumPy twin of ops/robust.rho_and_weight's HUBER branch (same
    Ceres convention: threshold delta^2 on s, rho'(s) = delta/sqrt(s)
    beyond it); pinned against the jnp kernel by tests/test_triage.py.
    """
    d2 = delta * delta
    sqrt_s = np.sqrt(np.maximum(s, 1e-30))
    return np.where(s <= d2, 1.0, delta / sqrt_s)


def _exemplars(idx: np.ndarray, cap: int) -> List[int]:
    return [int(i) for i in idx[:cap]]


def check_problem(
    cameras: np.ndarray,
    points: np.ndarray,
    obs: np.ndarray,
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    policy: Optional[TriagePolicy] = None,
    edge_mask: Optional[np.ndarray] = None,
    cam_fixed: Optional[np.ndarray] = None,
    pt_fixed: Optional[np.ndarray] = None,
    factor=None,
) -> Tuple[HealthReport, Dict[str, np.ndarray]]:
    """Run every enabled check; return (report, internals).

    `factor` (a registered `factors.FactorSpec`, or None for the
    historical BAL behaviour) REGISTRY-DISPATCHES the checks: the
    geometric pass runs through the spec's `triage` hooks (projection +
    depth for cheirality/outliers, camera centers for parallax) — a
    factor WITHOUT hooks (priors, planar) skips the projective checks
    entirely, because cheirality is meaningless for a non-projective
    residual, and the report records `geometric=False` so downstream
    gates know those checks never ran (advisory absence, not a clean
    bill); the duplicate-edge check honours `spec.unique_edges` (a rig
    repeats (body, point) pairs by construction).  Structural and
    non-finite checks are factor-agnostic and always run.

    `edge_mask` / `cam_fixed` / `pt_fixed` are the caller's OWN solve
    operands, and the checks honour them: a caller-masked (mask <= 0)
    edge is already dead, so it does not count toward degrees,
    connectivity, parallax, duplicates or per-edge geometric findings
    — masking one of a point's two observations makes that point deg-1
    here, exactly as the solver will see it; a caller-fixed point or
    camera has an identity Hessian block and zero gradient, so it is
    never flagged under-constrained/low-parallax/orphan, and a
    component containing a caller-fixed camera already has its gauge.
    Non-finite data is flagged REGARDLESS of masks: the edge mask
    multiplies residuals on device and `0 * NaN` is `NaN`, so a NaN
    behind a caller-masked edge still poisons the cost.

    `internals` carries the full per-axis boolean masks the repair
    planner consumes (the report itself only stores counts + bounded
    exemplars): `bad_edge` (edges to soft-delete), `weight`
    ([nE] float downweight for outlier edges, 1.0 elsewhere),
    `bad_cam` / `bad_pt` (blocks to freeze), `sanitize_cam` /
    `sanitize_pt` / `sanitize_obs` (non-finite entries to scrub),
    `pre_dead` / `pre_fixed_cam` / `pre_fixed_pt` (the caller operands
    above), `cam_comp` / `pt_comp` + `n_components`.

    Host NumPy only: nothing here launches a kernel or touches a
    device.
    """
    policy = policy or TriagePolicy()
    # Factor dispatch: hooks + duplicate-edge semantics off the spec
    # (duck-typed attribute reads — see _default_bal_hooks on why the
    # registry itself is never imported here).
    if factor is None:
        hooks = _default_bal_hooks()
        unique_edges = True
    else:
        hooks = getattr(factor, "triage", None)
        unique_edges = bool(getattr(factor, "unique_edges", True))
    geometric_on = bool(policy.geometric) and hooks is not None
    t0 = monotonic_s()
    cameras = np.asarray(cameras)
    points = np.asarray(points)
    obs = np.asarray(obs)
    ci = np.asarray(cam_idx, np.int64).reshape(-1)
    pi = np.asarray(pt_idx, np.int64).reshape(-1)
    n_cam, n_pt, n_edge = (int(cameras.shape[0]), int(points.shape[0]),
                           int(ci.shape[0]))
    if pi.shape[0] != n_edge or obs.shape[0] != n_edge:
        raise ValueError(
            f"index/observation length mismatch: cam_idx {n_edge}, "
            f"pt_idx {pi.shape[0]}, obs {obs.shape[0]}")
    if n_edge and (ci.min() < 0 or ci.max() >= n_cam
                   or pi.min() < 0 or pi.max() >= n_pt):
        raise ValueError("observation indices out of range")
    pre_dead = np.zeros(n_edge, bool)
    if edge_mask is not None:
        em = np.asarray(edge_mask).reshape(-1)
        if em.shape[0] != n_edge:
            raise ValueError(
                f"edge_mask has {em.shape[0]} entries for a problem "
                f"with {n_edge} edges")
        pre_dead = ~(em > 0)
    pre_fixed_cam = (np.zeros(n_cam, bool) if cam_fixed is None
                     else np.asarray(cam_fixed, bool).reshape(-1))
    pre_fixed_pt = (np.zeros(n_pt, bool) if pt_fixed is None
                    else np.asarray(pt_fixed, bool).reshape(-1))

    findings: List[Finding] = []
    cap = policy.exemplar_cap
    bad_edge = np.zeros(n_edge, bool)  # edges to soft-delete
    weight = np.ones(n_edge, np.float64)  # robust downweight (1 = keep)
    bad_cam = np.zeros(n_cam, bool)  # camera blocks to freeze
    bad_pt = np.zeros(n_pt, bool)  # point blocks to freeze
    san_cam = np.zeros(n_cam, bool)  # non-finite params to scrub
    san_pt = np.zeros(n_pt, bool)
    san_obs = np.zeros(n_edge, bool)

    def add(kind: CheckKind, mask: np.ndarray, detail: str = "") -> None:
        n = int(np.count_nonzero(mask))
        if n:
            findings.append(Finding(
                kind=kind, count=n,
                exemplars=_exemplars(np.nonzero(mask)[0], cap),
                detail=detail))

    # ---- non-finite data (always on: every later check reads it) -----
    nf_cam = ~np.isfinite(cameras).all(axis=1)
    nf_pt = ~np.isfinite(points).all(axis=1)
    nf_obs = ~np.isfinite(obs).all(axis=1)
    add(CheckKind.NONFINITE_CAMERA, nf_cam, "non-finite camera parameters")
    add(CheckKind.NONFINITE_POINT, nf_pt, "non-finite point coordinates")
    add(CheckKind.NONFINITE_OBS, nf_obs, "non-finite pixel observations")
    san_cam |= nf_cam
    san_pt |= nf_pt
    san_obs |= nf_obs
    bad_cam |= nf_cam
    bad_pt |= nf_pt
    # An edge touching poisoned data is dead either way.
    bad_edge |= nf_obs | nf_cam[ci] | nf_pt[pi]

    if policy.structural and n_edge and unique_edges:
        # ---- duplicate (cam, pt) edges: keep the FIRST occurrence ----
        # Factor-gated: families declaring unique_edges=False (rig,
        # priors) encode repeated index pairs deliberately.
        # Caller-masked copies don't double-count a factor, so the scan
        # runs over the caller-alive subset only.
        live = np.nonzero(~pre_dead)[0]
        key = ci[live] * np.int64(n_pt) + pi[live]
        _, first, counts = np.unique(key, return_index=True,
                                     return_counts=True)
        if (counts > 1).any():
            dup_live = np.ones(live.shape[0], bool)
            dup_live[first] = False  # first occurrence of a key survives
            dup = np.zeros(n_edge, bool)
            dup[live[dup_live]] = True
            add(CheckKind.DUPLICATE_EDGE, dup,
                "duplicate (cam, pt) edges (double-counted factors)")
            bad_edge |= dup

    # Scrubbed float64 working copies for BOTH geometric passes (the
    # projection and the parallax rays): NaN params would make every
    # derived check on those edges NaN — they are already flagged
    # above; zero stand-ins keep the passes finite.
    if geometric_on and n_edge:
        cams_f = np.where(san_cam[:, None], 0.0,
                          cameras.astype(np.float64, copy=False))
        pts_f = np.where(san_pt[:, None], 0.0,
                         points.astype(np.float64, copy=False))
        ob_f = np.where(san_obs[:, None], 0.0,
                        obs.astype(np.float64, copy=False))

    if geometric_on and n_edge:
        uv = np.empty((n_edge, 2))
        depth = np.empty((n_edge,))
        for lo in range(0, n_edge, _GEOM_CHUNK):
            hi = min(lo + _GEOM_CHUNK, n_edge)
            uv[lo:hi], depth[lo:hi] = hooks.project_depth(
                cams_f[ci[lo:hi]], pts_f[pi[lo:hi]], ob_f[lo:hi])

        # ---- cheirality: behind (or on) the camera plane -------------
        # BAL-convention visible half-space is z < 0 (every projective
        # hook returns the camera-frame depth in that convention);
        # z >= -min_depth means the -P/P.z projection is about to
        # divide by ~0 or the point sits behind the camera — either way
        # the first linearisation is poisoned.  Already-dead edges
        # (flagged above, or caller-masked) are excluded so nothing
        # double-reports.
        behind = (depth >= -policy.min_depth) & ~bad_edge & ~pre_dead
        add(CheckKind.BEHIND_CAMERA, behind,
            "point behind/on camera plane at the initial estimate")
        bad_edge |= behind

        # ---- extreme initial reprojection residuals ------------------
        lo_c, hi_c = hooks.uv_cols
        with np.errstate(invalid="ignore", over="ignore"):
            rnorm = np.linalg.norm(uv - ob_f[:, lo_c:hi_c], axis=1)
        extreme = (~np.isfinite(rnorm) | (rnorm > policy.max_residual_px)
                   ) & ~bad_edge & ~pre_dead
        add(CheckKind.EXTREME_RESIDUAL, extreme,
            f"initial reprojection residual > {policy.max_residual_px:g} px")
        if policy.downweight_outliers:
            # Huber weight at the initial residual, delta = the outlier
            # threshold: the NumPy twin of ops/robust.rho_and_weight's
            # HUBER branch (w'(s) = delta/sqrt(s) beyond delta^2;
            # tests/test_triage.py pins the two against each other so
            # the conventions can never drift).  The edge MASK
            # multiplies r and J, so sqrt of the IRLS weight on the
            # mask applies exactly weight rho'(s) to the factor —
            # the robust-kernel path, folded into an operand the
            # program already has.
            finite = np.isfinite(rnorm)
            s = np.where(finite, rnorm, 0.0) ** 2
            w2 = huber_weight(s, policy.max_residual_px)
            weight = np.where(extreme & finite, np.sqrt(w2), weight)
            # A non-finite residual on an otherwise-alive edge cannot be
            # downweighted meaningfully — soft-delete it.
            bad_edge |= extreme & ~finite
        else:
            bad_edge |= extreme

    # ---- degrees on the SURVIVING graph ------------------------------
    # Structural degree checks run on the post-mask graph (check-flagged
    # AND caller-masked edges both excluded) so a repair composes:
    # masking a duplicate/behind-camera edge can drop a point under the
    # degree floor, and that point must be caught in the same pass (no
    # fixpoint iteration needed: freezing a point never revives an
    # edge).
    alive = ~bad_edge & ~pre_dead
    deg_pt = np.bincount(pi[alive], minlength=n_pt)
    deg_cam = np.bincount(ci[alive], minlength=n_cam)

    if policy.structural:
        orphan_cam = (deg_cam == 0) & ~bad_cam & ~pre_fixed_cam
        add(CheckKind.ORPHAN_CAMERA, orphan_cam,
            "camera with zero (surviving) observations")
        # Caller-fixed points are exempt: a fixed block is an identity
        # in the Hessian with a zero gradient — nothing to go singular.
        under_pt = ((deg_pt < policy.min_point_degree)
                    & ~bad_pt & ~pre_fixed_pt)
        add(CheckKind.UNDER_CONSTRAINED_POINT, under_pt,
            f"point observed by < {policy.min_point_degree} cameras "
            "(predicted-singular Hll block)")
        bad_pt |= under_pt
        under_cam = ((deg_cam > 0)
                     & (deg_cam < policy.min_camera_degree)
                     & ~bad_cam & ~pre_fixed_cam)
        # min_camera_degree is in OBSERVATIONS (2 residual rows each);
        # the default 5 flags cameras whose <= 8 rows cannot determine
        # 9 dof.  Advisory — damping bounds the step.
        add(CheckKind.UNDER_CONSTRAINED_CAMERA, under_cam,
            f"camera observed by < {policy.min_camera_degree} edges "
            "(fewer residual rows than camera dof at the default)")

    # ---- low parallax (geometric, needs surviving degrees, a
    # camera-centers hook AND 3D points for the viewing rays) ----------
    if (geometric_on and n_edge and policy.min_parallax_rad > 0
            and hooks.camera_centers is not None
            and points.shape[1] == 3):
        # Camera centers [Nc, 3] from the factor hook (BAL/radial:
        # C = -R^T t; rig: the body center); cams_f / pts_f are the
        # scrubbed copies hoisted above the projection.
        centers = hooks.camera_centers(cams_f)
        # Per-edge unit viewing rays, accumulated per point; the spread
        # proxy is the max angular deviation from the point's mean ray
        # (>= half the true max pairwise angle, <= the full one).
        ray_sum = np.zeros((n_pt, 3))
        min_cos = np.ones(n_pt)
        for lo in range(0, n_edge, _GEOM_CHUNK):
            hi = min(lo + _GEOM_CHUNK, n_edge)
            a = alive[lo:hi]
            ray = pts_f[pi[lo:hi]] - centers[ci[lo:hi]]
            nrm = np.linalg.norm(ray, axis=1, keepdims=True)
            ray = ray / np.where(nrm > 0, nrm, 1.0)
            np.add.at(ray_sum, pi[lo:hi][a], ray[a])
        mean_nrm = np.linalg.norm(ray_sum, axis=1, keepdims=True)
        mean_ray = ray_sum / np.where(mean_nrm > 0, mean_nrm, 1.0)
        for lo in range(0, n_edge, _GEOM_CHUNK):
            hi = min(lo + _GEOM_CHUNK, n_edge)
            a = alive[lo:hi]
            ray = pts_f[pi[lo:hi]] - centers[ci[lo:hi]]
            nrm = np.linalg.norm(ray, axis=1, keepdims=True)
            ray = ray / np.where(nrm > 0, nrm, 1.0)
            cosdev = np.sum(ray * mean_ray[pi[lo:hi]], axis=1)
            np.minimum.at(min_cos, pi[lo:hi][a], cosdev[a])
        spread = np.arccos(np.clip(min_cos, -1.0, 1.0))
        low_parallax = ((deg_pt >= policy.min_point_degree)
                        & (spread < 0.5 * policy.min_parallax_rad)
                        & ~bad_pt & ~pre_fixed_pt)
        add(CheckKind.LOW_PARALLAX, low_parallax,
            f"viewing-ray spread < {policy.min_parallax_rad:g} rad "
            "(depth unobservable)")
    else:
        low_parallax = np.zeros(n_pt, bool)

    # ---- connectivity (on the surviving graph) -----------------------
    n_components = 1
    cam_comp = np.zeros(n_cam, np.int64)
    pt_comp = np.zeros(n_pt, np.int64)
    if policy.structural:
        n_components, cam_comp, pt_comp = connected_components(
            ci, pi, n_cam, n_pt, edge_alive=alive)
        # Count CAMERA-bearing components: orphan points/cameras are
        # their own singletons and are reported separately, and a
        # frozen-singleton component is not a gauge problem.
        comp_cams = np.bincount(cam_comp[deg_cam > 0],
                                minlength=max(n_components, 1))
        real_comps = int(np.count_nonzero(comp_cams))
        # A component already containing a caller-fixed camera has its
        # gauge (the g2o prior-reached case); only UNANCHORED extra
        # components are gauge-deficient — and if no component is
        # anchored, the largest unanchored one keeps the solver's
        # default (damping) gauge handling, matching the single-
        # component no-op.
        anchored = np.zeros(max(n_components, 1), bool)
        anchored[cam_comp[pre_fixed_cam & (deg_cam > 0)]] = True
        unanchored = [int(c) for c in np.nonzero(comp_cams)[0]
                      if not anchored[c]]
        if real_comps > 1 and unanchored:
            if not anchored.any():
                main = max(unanchored, key=lambda c: comp_cams[c])
                flagged = [c for c in unanchored if c != main]
            else:
                flagged = unanchored
            if flagged:
                reps = [int(np.nonzero((cam_comp == c)
                                       & (deg_cam > 0))[0][0])
                        for c in flagged[:cap]]
                findings.append(Finding(
                    kind=CheckKind.DISCONNECTED,
                    count=len(flagged),
                    exemplars=reps,
                    detail=f"{real_comps} camera components "
                           f"({len(flagged)} without a gauge anchor — "
                           "each carries a free gauge)"))

    report = HealthReport(
        n_cam=n_cam, n_pt=n_pt, n_edge=n_edge, findings=findings,
        n_components=n_components, triage_s=monotonic_s() - t0,
        # `geometric` records what actually RAN: a hook-less factor
        # (priors, planar) reports False even under a geometric policy,
        # so downstream gates never mistake "not applicable" for
        # "checked clean".
        structural=policy.structural, geometric=geometric_on)
    internals = {
        "bad_edge": bad_edge, "weight": weight,
        "bad_cam": bad_cam, "bad_pt": bad_pt,
        "low_parallax": low_parallax,
        "sanitize_cam": san_cam, "sanitize_pt": san_pt,
        "sanitize_obs": san_obs,
        "pre_dead": pre_dead, "pre_fixed_cam": pre_fixed_cam,
        "pre_fixed_pt": pre_fixed_pt,
        "deg_cam": deg_cam, "deg_pt": deg_pt,
        "cam_comp": cam_comp, "pt_comp": pt_comp,
        "n_components": n_components,
    }
    return report, internals


def plan_repair(
    cameras: np.ndarray,
    points: np.ndarray,
    obs: np.ndarray,
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    report: HealthReport,
    internals: Dict[str, np.ndarray],
    policy: Optional[TriagePolicy] = None,
) -> TriageRepair:
    """Derive the deterministic repair for a checked problem.

    Composition order (each step only ever REMOVES constraints, so one
    pass is a fixpoint for everything except camera degrees, which stay
    advisory): (1) soft-delete dead edges (non-finite / duplicate /
    behind-camera) and fold the robust downweight into the mask;
    (2) freeze degenerate points (`pt_fixed`) and soft-delete their
    remaining edges — EXCEPT low-parallax points, which are frozen but
    keep their edges (their projections are consistent; as fixed
    landmarks they still constrain rotation, the classic far-point
    treatment); (3) freeze non-finite cameras and anchor one camera per
    secondary connected component (the g2o anchor-per-component policy);
    (4) scrub non-finite params/obs to zeros on frozen/masked entries
    (the mask MULTIPLIES residuals; 0 * NaN is NaN).
    """
    policy = policy or TriagePolicy()
    pi = np.asarray(pt_idx, np.int64).reshape(-1)

    bad_edge = internals["bad_edge"].copy()
    weight = internals["weight"]
    pt_fixed = internals["bad_pt"].copy()
    cam_fixed = internals["bad_cam"].copy()

    # Low-parallax points: freeze, keep edges (see docstring).  Their
    # full membership rides internals (the report only stores bounded
    # exemplars); internals["bad_pt"] excludes them by construction.
    pt_fixed |= internals["low_parallax"]

    # Degenerate (non-low-parallax) points lose their remaining edges
    # (edges the caller already masked are not re-counted as repairs).
    drop_pt = internals["bad_pt"]
    bad_edge |= drop_pt[pi] & ~internals["pre_dead"]

    points_fixed = int(np.count_nonzero(pt_fixed))

    # Gauge anchoring: one camera per unanchored secondary component
    # (components already holding a caller-fixed camera are skipped,
    # and with no anchors anywhere the largest component keeps the
    # solver's default gauge handling — so a clean single-component
    # problem is untouched).  Mirrors the DISCONNECTED finding's
    # flagged set exactly.
    cams_anchored = 0
    disc = report.finding(CheckKind.DISCONNECTED)
    if disc is not None:
        cam_comp = internals["cam_comp"]
        deg_cam = internals["deg_cam"]
        pre_fixed_cam = internals["pre_fixed_cam"]
        n_comp = max(int(internals["n_components"]), 1)
        comp_cams = np.bincount(cam_comp[deg_cam > 0], minlength=n_comp)
        anchored = np.zeros(n_comp, bool)
        anchored[cam_comp[pre_fixed_cam & (deg_cam > 0)]] = True
        unanchored = [int(c) for c in np.nonzero(comp_cams)[0]
                      if not anchored[c]]
        if not anchored.any() and unanchored:
            unanchored.remove(max(unanchored, key=lambda c: comp_cams[c]))
        for c in unanchored:
            anchor = int(np.nonzero((cam_comp == c) & (deg_cam > 0))[0][0])
            if not cam_fixed[anchor]:
                cam_fixed[anchor] = True
                cams_anchored += 1

    edges_masked = int(np.count_nonzero(bad_edge))
    down = (~bad_edge) & (weight < 1.0)
    edges_downweighted = int(np.count_nonzero(down))

    edge_mask = None
    if edges_masked or edges_downweighted:
        edge_mask = np.where(bad_edge, 0.0, weight)

    # Host sanitisation of non-finite values (frozen blocks and masked
    # edges only — finite data is NEVER rewritten).
    cameras_out = points_out = obs_out = None
    if internals["sanitize_cam"].any():
        cameras_out = np.where(internals["sanitize_cam"][:, None],
                               np.zeros((), cameras.dtype), cameras)
    if internals["sanitize_pt"].any():
        points_out = np.where(internals["sanitize_pt"][:, None],
                              np.zeros((), points.dtype), points)
    if internals["sanitize_obs"].any():
        obs_out = np.where(internals["sanitize_obs"][:, None],
                           np.zeros((), obs.dtype), obs)

    return TriageRepair(
        edge_mask=edge_mask,
        cam_fixed=cam_fixed if cam_fixed.any() else None,
        pt_fixed=pt_fixed if pt_fixed.any() else None,
        cameras=cameras_out, points=points_out, obs=obs_out,
        points_fixed=points_fixed,
        cams_fixed=int(np.count_nonzero(cam_fixed)),
        cams_anchored=cams_anchored,
        edges_masked=edges_masked,
        edges_downweighted=edges_downweighted,
    )


def triage_problem(
    cameras: np.ndarray,
    points: np.ndarray,
    obs: np.ndarray,
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    policy: Optional[TriagePolicy] = None,
    edge_mask: Optional[np.ndarray] = None,
    cam_fixed: Optional[np.ndarray] = None,
    pt_fixed: Optional[np.ndarray] = None,
    factor=None,
) -> TriageOutcome:
    """Check one problem and act on the policy.

    `edge_mask` / `cam_fixed` / `pt_fixed` are the caller's own solve
    operands, honoured by the checks (see `check_problem`) — the
    returned repair composes with them via
    `TriageRepair.merge_operands`.  `factor` (a registered
    `factors.FactorSpec` or None = BAL) registry-dispatches the
    geometric hooks and duplicate-edge semantics (see `check_problem`).

    Returns a `TriageOutcome`; raises `ProblemRejected` (report
    attached) when the problem is degenerate under REJECT.  Clean
    problems take the WARN path regardless of policy: no repair, no
    rewriting, report says clean — so arming triage on healthy traffic
    is a pure no-op apart from the host check pass.
    """
    policy = policy or TriagePolicy()
    report, internals = check_problem(
        cameras, points, obs, cam_idx, pt_idx, policy,
        edge_mask=edge_mask, cam_fixed=cam_fixed, pt_fixed=pt_fixed,
        factor=factor)
    if not report.degenerate:
        report.action = TriageAction.WARN.value
        return TriageOutcome(report=report, action=TriageAction.WARN)
    action = policy.on_degenerate
    report.action = action.value
    if action == TriageAction.REJECT:
        raise ProblemRejected(report)
    if action == TriageAction.WARN:
        return TriageOutcome(report=report, action=action)
    repair = plan_repair(cameras, points, obs, cam_idx, pt_idx,
                         report, internals, policy)
    report.repair = repair.counters()
    return TriageOutcome(report=report, action=action, repair=repair)

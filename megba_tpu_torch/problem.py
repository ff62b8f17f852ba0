"""g2o-compatible Problem / Vertex / Edge user API.

Counterpart of `megba_tpu/problem.py`: the object facade with the
semantics of the reference's user layer (base_problem.h, base_vertex.h,
base_edge.h): `append_vertex` / `append_edge` / `get_vertex` /
`erase_vertex` / `solve`, camera / point vertex kinds, fixed vertices,
per-edge measurements and information matrices, and user-defined
`forward()` residuals.  `solve()` lowers the graph once into flat index
and parameter arrays and hands them to `solve.flat_solve`; the solution
is written back into the vertices' `estimation` arrays.

A custom `forward()` is plain torch on `vertex_estimation(i)` and
`get_measurement()`.  It is evaluated once on the whole edge batch,
feature-major (a camera [cd, nE], a point [pd, nE], the measurement
[od, nE]), through the AUTODIFF engine of ops/residuals.py, so it must
act on the leading axis as the residual functions of this package do.
One engine per problem, never shared: the prototype edge's instance
constants are baked into it.

Pose graphs (PoseVertex + BetweenEdge) are checked as in the JAX
package and lowered into the pose-graph driver, `models/pgo.solve_pgo`,
whose `PGOResult` `solve()` returns.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from megba_tpu_torch.common import (JacobianMode, ProblemOption,
                                    validate_options)
from megba_tpu_torch.ops.residuals import (
    bal_residual,
    build_residual_jacobian_fn,
    make_residual_jacobian_fn,
)


class VertexKind(enum.Enum):
    """Reference BaseVertex kind(), with POSE for the pose-graph family."""

    CAMERA = 0
    POINT = 1
    NONE = 2
    POSE = 3


class BaseVertex:
    """A parameter block (reference BaseVertex)."""

    kind = VertexKind.NONE

    def __init__(self, estimation: np.ndarray, fixed: bool = False):
        self.estimation = np.atleast_1d(
            np.asarray(estimation, dtype=np.float64)).copy()
        self.fixed = bool(fixed)

    @property
    def grad_shape(self) -> int:
        """Differentiable width: 0 when fixed."""
        return 0 if self.fixed else int(self.estimation.size)

    def __repr__(self):
        return (f"{type(self).__name__}(dim={self.estimation.size}, "
                f"fixed={self.fixed})")


class CameraVertex(BaseVertex):
    kind = VertexKind.CAMERA


class PointVertex(BaseVertex):
    kind = VertexKind.POINT


class PoseVertex(BaseVertex):
    """An SE(3) pose [angle_axis (3), translation (3)]: the pose-graph
    family."""

    kind = VertexKind.POSE

    def __init__(self, estimation: np.ndarray, fixed: bool = False):
        super().__init__(estimation, fixed)
        if self.estimation.shape != (6,):
            raise ValueError(
                f"PoseVertex needs 6 parameters [angle_axis, t], got "
                f"shape {self.estimation.shape}")


class BaseEdge:
    """A residual term over its vertices (reference BaseEdge).

    Subclass and override `forward()` for a custom residual model: it
    reads `self.vertex_estimation(i)` and `self.get_measurement()` (the
    whole edge batch, feature-major, while the engine runs it) and
    returns the residual rows.  Without an override the edge is the BAL
    reprojection model.
    """

    def __init__(
        self,
        vertices: Optional[Sequence[BaseVertex]] = None,
        measurement: Optional[np.ndarray] = None,
        information: Optional[np.ndarray] = None,
    ):
        self.vertices: List[BaseVertex] = list(vertices) if vertices else []
        self.measurement = (
            None if measurement is None
            else np.atleast_1d(np.asarray(measurement, np.float64)))
        self.information = (None if information is None
                            else np.asarray(information, np.float64))
        # Set while the engine evaluates forward() on the edge batch.
        self._traced_estimations: Optional[List[torch.Tensor]] = None
        self._traced_measurement: Optional[torch.Tensor] = None

    def append_vertex(self, v: BaseVertex) -> "BaseEdge":
        self.vertices.append(v)
        return self

    def vertex_estimation(self, i: int) -> torch.Tensor:
        """The i-th vertex's parameters; the batch inside forward()."""
        if self._traced_estimations is not None:
            return self._traced_estimations[i]
        return torch.as_tensor(self.vertices[i].estimation)

    def get_measurement(self) -> torch.Tensor:
        if self._traced_measurement is not None:
            return self._traced_measurement
        return torch.as_tensor(self.measurement)

    def forward(self) -> torch.Tensor:
        """Default: the BAL reprojection residual (camera, point)."""
        return bal_residual(self.vertex_estimation(0),
                            self.vertex_estimation(1),
                            self.get_measurement())


class BetweenEdge(BaseEdge):
    """SE(3) between-factor over two PoseVertex: measurement T_i^{-1} T_j
    as [angle_axis (3), translation (3)], information an optional 6 x 6
    matrix.  Its residual is the pose-graph driver's fixed one; a custom
    forward() is not supported."""

    def __init__(self, vertices=None, measurement=None, information=None):
        super().__init__(vertices, measurement, information)
        if self.measurement is not None and self.measurement.shape != (6,):
            raise ValueError(
                f"BetweenEdge measurement must be 6 values "
                f"[angle_axis, t], got shape {self.measurement.shape}")
        if (self.information is not None
                and self.information.shape != (6, 6)):
            raise ValueError(
                f"BetweenEdge information must be 6x6, got shape "
                f"{self.information.shape}")

    def forward(self) -> torch.Tensor:  # pragma: no cover - guard only
        raise NotImplementedError(
            "BetweenEdge uses the PGO pipeline's fixed between-factor "
            "residual; custom forward() is not supported for pose edges")


def _edge_residual_jac_fn(proto: BaseEdge):
    """The AUTODIFF engine of a custom edge's forward(): one prototype
    edge stands in for every edge, so what forward() reads beyond the
    vertex estimations and the measurement is this prototype's; the
    engine belongs to one problem."""

    def residual(camera, point, obs, proto=proto):
        proto._traced_estimations = [camera, point]
        proto._traced_measurement = obs
        try:
            return proto.forward()
        finally:
            proto._traced_estimations = None
            proto._traced_measurement = None

    return build_residual_jacobian_fn(residual_fn=residual,
                                      mode=JacobianMode.AUTODIFF)


class BaseProblem:
    """The user facade (reference BaseProblem): append vertices by id,
    append edges (each a camera vertex and a point vertex with a
    measurement), then `solve()`, which writes the solution back into the
    vertices.  `device` is flat_solve's: None is `option.device` (the
    card by default), "cpu" the plain PyTorch path."""

    def __init__(self, option: Optional[ProblemOption] = None,
                 device: Union[None, str, torch.device] = None):
        self.option = option or ProblemOption()
        validate_options(self.option)
        self.device = device
        self._vertices: Dict[int, BaseVertex] = {}
        self._vertex_ids: set = set()  # id(vertex) for O(1) membership
        self._edges: List[BaseEdge] = []
        self._edge_type: Optional[type] = None
        self._engine: Optional[Callable] = None  # the custom-edge engine
        # LMResult, or a PGOResult after a pose graph's solve.
        self.result = None

    # -- graph construction ------------------------------------------------
    def append_vertex(self, vertex_id: int, vertex: BaseVertex) -> None:
        if vertex_id in self._vertices:
            raise ValueError(f"duplicate vertex id {vertex_id}")
        self._vertices[vertex_id] = vertex
        self._vertex_ids.add(id(vertex))

    def append_edge(self, edge: BaseEdge) -> None:
        # Homogeneous edge types only, like the reference's typeid check.
        if self._edge_type is None:
            self._edge_type = type(edge)
        elif type(edge) is not self._edge_type:
            raise TypeError(
                f"heterogeneous edge types: {type(edge).__name__} vs "
                f"{self._edge_type.__name__}")
        kinds = [v.kind for v in edge.vertices]
        if kinds == [VertexKind.POSE, VertexKind.POSE]:
            if not isinstance(edge, BetweenEdge):
                raise TypeError(
                    "pose-pose edges must be BetweenEdge (the PGO "
                    "pipeline's fixed between-factor residual)")
        elif isinstance(edge, BetweenEdge):
            raise TypeError(
                "BetweenEdge requires two PoseVertex endpoints, got "
                f"{[k.name for k in kinds]}")
        elif kinds != [VertexKind.CAMERA, VertexKind.POINT]:
            raise NotImplementedError(
                "edges must be (CameraVertex, PointVertex) or "
                "(PoseVertex, PoseVertex)")
        for v in edge.vertices:
            if id(v) not in self._vertex_ids:
                raise ValueError("edge references a vertex not in the "
                                 "problem")
        if edge.measurement is None:
            raise ValueError("edge has no measurement")
        self._edges.append(edge)

    def get_vertex(self, vertex_id: int) -> BaseVertex:
        return self._vertices[vertex_id]

    def erase_vertex(self, vertex_id: int) -> None:
        """Remove a vertex and every edge touching it."""
        v = self._vertices.pop(vertex_id)
        self._vertex_ids.discard(id(v))
        self._edges = [e for e in self._edges
                       if all(u is not v for u in e.vertices)]
        self._engine = None
        if not self._edges:
            self._edge_type = None

    # -- lowering + solve --------------------------------------------------
    def _lower(self):
        cams = [(i, v) for i, v in self._vertices.items()
                if v.kind == VertexKind.CAMERA]
        pts = [(i, v) for i, v in self._vertices.items()
               if v.kind == VertexKind.POINT]
        if not cams or not pts or not self._edges:
            raise ValueError("problem needs cameras, points, and edges")
        cam_rank = {id(v): r for r, (_, v) in enumerate(cams)}
        pt_rank = {id(v): r for r, (_, v) in enumerate(pts)}
        cameras = np.stack([v.estimation for _, v in cams])
        points = np.stack([v.estimation for _, v in pts])
        cam_fixed = np.array([v.fixed for _, v in cams])
        pt_fixed = np.array([v.fixed for _, v in pts])
        cam_idx = np.array([cam_rank[id(e.vertices[0])]
                            for e in self._edges], np.int32)
        pt_idx = np.array([pt_rank[id(e.vertices[1])]
                           for e in self._edges], np.int32)
        obs = np.stack([e.measurement for e in self._edges])
        sqrt_info = None
        if any(e.information is not None for e in self._edges):
            od = obs.shape[1]
            infos = np.stack([e.information if e.information is not None
                              else np.eye(od) for e in self._edges])
            # Whitening factor L^T of info = L L^T (Cholesky), so that
            # r~^T r~ = r^T info r, as the JAX package does.
            sqrt_info = np.transpose(np.linalg.cholesky(infos), (0, 2, 1))
        return (cameras, points, obs, cam_idx, pt_idx, cam_fixed, pt_fixed,
                sqrt_info, cams, pts)

    def _lower_pgo(self):
        """The pose graph's arrays, checked as the JAX package checks
        them (information matrices through `core.linalg.psd_sqrt`), with
        the vertices' fixed flags and the (id, vertex) list."""
        poses = [(i, v) for i, v in self._vertices.items()
                 if v.kind == VertexKind.POSE]
        if not poses or not self._edges:
            raise ValueError("pose-graph problem needs poses and edges")
        rank = {id(v): r for r, (_, v) in enumerate(poses)}
        table = np.stack([v.estimation for _, v in poses])
        fixed = np.array([v.fixed for _, v in poses])
        edge_i = np.array([rank[id(e.vertices[0])] for e in self._edges],
                          np.int32)
        edge_j = np.array([rank[id(e.vertices[1])] for e in self._edges],
                          np.int32)
        meas = np.stack([e.measurement for e in self._edges])
        sqrt_info = None
        if any(e.information is not None for e in self._edges):
            from megba_tpu_torch.core.linalg import psd_sqrt

            infos = np.stack([e.information if e.information is not None
                              else np.eye(6) for e in self._edges])
            sqrt_info = psd_sqrt(infos, what="edge")
        return table, edge_i, edge_j, meas, fixed, sqrt_info, poses

    def _solve_pgo(self, verbose: bool):
        from megba_tpu_torch.models.pgo import solve_pgo

        table, edge_i, edge_j, meas, fixed, sqrt_info, poses = \
            self._lower_pgo()
        result = solve_pgo(
            table, edge_i, edge_j, meas, self.option, sqrt_info=sqrt_info,
            # No fixed vertex: solve_pgo's default gauge anchor (the
            # first pose).
            fixed=fixed if fixed.any() else None,
            verbose=verbose, device=self.device)
        out = result.poses.detach().cpu().numpy().astype(np.float64)
        for r, (_, v) in enumerate(poses):
            v.estimation = out[r].copy()
        self.result = result
        return result

    def solve(self, verbose: bool = False):
        """Solve and write back (reference base_problem.cpp:273-278).
        Returns an LMResult for a BA graph; a pose graph (PoseVertex +
        BetweenEdge) goes through the pose-graph driver and returns its
        PGOResult."""
        if self._edges and isinstance(self._edges[0], BetweenEdge):
            return self._solve_pgo(verbose)
        opt = self.option
        (cameras, points, obs, cam_idx, pt_idx,
         cam_fixed, pt_fixed, sqrt_info, cams, pts) = self._lower()

        # The closed form applies to the untouched BAL forward only; a
        # custom forward goes through autodiff.
        custom_forward = (self._edge_type is not None
                          and self._edge_type.forward is not BaseEdge.forward)
        if custom_forward:
            if self._engine is None:
                self._engine = _edge_residual_jac_fn(self._edges[0])
            residual_jac_fn = self._engine
        else:
            residual_jac_fn = make_residual_jacobian_fn(
                mode=opt.jacobian_mode)

        from megba_tpu_torch.solve import flat_solve

        result = flat_solve(residual_jac_fn,
            cameras, points, obs, cam_idx, pt_idx, opt,
            sqrt_info=sqrt_info,
            cam_fixed=cam_fixed if cam_fixed.any() else None,
            pt_fixed=pt_fixed if pt_fixed.any() else None,
            verbose=verbose, device=self.device)

        # Write back (reference base_problem.cpp:249-272).
        cams_out = result.cameras.detach().cpu().numpy().astype(np.float64)
        pts_out = result.points.detach().cpu().numpy().astype(np.float64)
        for r, (_, v) in enumerate(cams):
            v.estimation = cams_out[r].copy()
        for r, (_, v) in enumerate(pts):
            v.estimation = pts_out[r].copy()
        self.result = result
        return result

"""Residual + Jacobian engines (feature-major, PyTorch).

Counterpart of `megba_tpu/ops/residuals.py`.  Engine contract:
fn(cam [cd, nE], pt [pd, nE], obs [od, nE]) ->
  (r [od, nE], Jc [od*cd, nE], Jp [od*pd, nE]) with row o*d+a = dr_o/dx_a.

A residual function here acts on the leading (feature) axis of its
arguments, camera [cd, ...], point [pd, ...], obs [od, ...] -> r [od, ...],
so the same function takes one edge or a whole feature-major batch
(`bal_residual`).  Edges are independent, so the per-edge Jacobians of
the three `JacobianMode`s come straight from the batched function:

- AUTODIFF: one `torch.func.vjp` of the batched residual, its pullback
  `torch.func.vmap`-ed over the od one-hot cotangent rows (each row
  broadcast over all edges): od reverse passes.
- AUTODIFF_FORWARD: `torch.func.jvp` `vmap`-ed over the cd+pd one-hot
  tangent rows (the JetVector direction): one primal pass and cd+pd
  pushforwards.
- ANALYTICAL: the closed form below, each scalar of the derivation one
  [nE] row.

`build_residual_jacobian_fn` returns a `ResidualJacobianFn`, which also
carries the engine's value-only residual: the LM loop costs every trial
point with it (the JAX package relies on dead-code elimination inside
`jit` for the same saving; PyTorch runs eagerly).
`bal_residual_analytical_fm` is that value-only half of the analytical
engine: the same expressions up to the residual.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch

from megba_tpu_torch.common import JacobianMode
from megba_tpu_torch.ops import geo

# (camera [cd, ...], point [pd, ...], obs [od, ...]) -> r [od, ...]
ResidualFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                      torch.Tensor]
Rows = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_SMALL_ANGLE = 1e-12


def bal_residual(camera: torch.Tensor, point: torch.Tensor,
                 obs: torch.Tensor) -> torch.Tensor:
    """The standard BAL reprojection residual, camera [9, ...],
    point [3, ...], obs [2, ...] -> [2, ...]: rotate, translate,
    perspective divide with the BAL minus convention, radial distortion,
    subtract the observation."""
    w = camera[0:3]
    t = camera[3:6]
    f, k1, k2 = camera[6], camera[7], camera[8]
    P = geo.angle_axis_rotate_point(w, point) + t
    p = -P[0:2] / P[2]
    proj = geo.radial_distortion(p, f, k1, k2)
    return proj - obs


def _forward(cam: torch.Tensor, pt: torch.Tensor, obs: torch.Tensor):
    """Rotation rows, projection and residual of the analytical engine."""
    w0, w1, w2 = cam[0], cam[1], cam[2]
    t0, t1, t2 = cam[3], cam[4], cam[5]
    f, k1, k2 = cam[6], cam[7], cam[8]
    x0, x1, x2 = pt[0], pt[1], pt[2]
    one = torch.ones_like(w0)

    theta2 = w0 * w0 + w1 * w1 + w2 * w2
    safe = theta2 > _SMALL_ANGLE
    th2s = torch.where(safe, theta2, one)
    th = torch.sqrt(th2s)
    ct, st = torch.cos(th), torch.sin(th)
    inv_th = 1.0 / th
    e0, e1, e2 = w0 * inv_th, w1 * inv_th, w2 * inv_th
    one_ct = 1.0 - ct

    def W(val_full, val_small):
        return torch.where(safe, val_full, val_small)

    # Rotation matrix (full: ct I + one_ct e e^T + st [e]_x;
    # small angle: I + [w]_x).
    R = (
        W(ct + one_ct * e0 * e0, one),
        W(one_ct * e0 * e1 - st * e2, -w2),
        W(one_ct * e0 * e2 + st * e1, w1),
        W(one_ct * e1 * e0 + st * e2, w2),
        W(ct + one_ct * e1 * e1, one),
        W(one_ct * e1 * e2 - st * e0, -w0),
        W(one_ct * e2 * e0 - st * e1, -w1),
        W(one_ct * e2 * e1 + st * e0, w0),
        W(ct + one_ct * e2 * e2, one),
    )
    R00, R01, R02, R10, R11, R12, R20, R21, R22 = R
    RX0 = R00 * x0 + R01 * x1 + R02 * x2
    RX1 = R10 * x0 + R11 * x1 + R12 * x2
    RX2 = R20 * x0 + R21 * x1 + R22 * x2

    P0, P1, P2 = RX0 + t0, RX1 + t1, RX2 + t2
    iz = 1.0 / P2
    px = -P0 * iz
    py = -P1 * iz
    n = px * px + py * py
    rd = 1.0 + k1 * n + k2 * n * n
    r0 = f * rd * px - obs[0]
    r1 = f * rd * py - obs[1]
    return dict(safe=safe, th2s=th2s, R=R, P0=P0, P1=P1, iz=iz, px=px,
                py=py, n=n, rd=rd, r=torch.stack([r0, r1]))


def bal_residual_analytical_fm(cam: torch.Tensor, pt: torch.Tensor,
                               obs: torch.Tensor) -> torch.Tensor:
    """Residual rows [2, nE] of the analytical engine, without Jacobians."""
    return _forward(cam, pt, obs)["r"]


def bal_residual_jacobian_analytical_fm(
    cam: torch.Tensor, pt: torch.Tensor, obs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hand-derived residual + full Jacobian for the BAL model, row form.

    cam [9, nE], pt [3, nE], obs [2, nE] ->
      (r [2, nE], Jc [18, nE], Jp [6, nE]).
    Rotation derivative d(R(w)x)/dw is the Gallego & Yezzi (2015) closed
    form with the small-angle limit -[x]_x.
    """
    fw = _forward(cam, pt, obs)
    safe, th2s = fw["safe"], fw["th2s"]
    R00, R01, R02, R10, R11, R12, R20, R21, R22 = fw["R"]
    P0, P1, iz = fw["P0"], fw["P1"], fw["iz"]
    px, py, n, rd = fw["px"], fw["py"], fw["n"], fw["rd"]
    w0, w1, w2 = cam[0], cam[1], cam[2]
    f, k1, k2 = cam[6], cam[7], cam[8]
    x0, x1, x2 = pt[0], pt[1], pt[2]

    def W(val_full, val_small):
        return torch.where(safe, val_full, val_small)

    # d proj / d p = f (rd I + 2 (k1 + 2 k2 n) p p^T)
    c2 = 2.0 * (k1 + 2.0 * k2 * n)
    D00 = f * (rd + c2 * px * px)
    D01 = f * (c2 * px * py)
    D11 = f * (rd + c2 * py * py)

    # d r / d P = D @ [[-iz, 0, P0 iz^2], [0, -iz, P1 iz^2]]
    iz2 = iz * iz
    G00 = -D00 * iz
    G01 = -D01 * iz
    G02 = (D00 * P0 + D01 * P1) * iz2
    G10 = -D01 * iz
    G11 = -D11 * iz
    G12 = (D01 * P0 + D11 * P1) * iz2

    # Jp = G @ R  (dP/dX = R)
    Jp00 = G00 * R00 + G01 * R10 + G02 * R20
    Jp01 = G00 * R01 + G01 * R11 + G02 * R21
    Jp02 = G00 * R02 + G01 * R12 + G02 * R22
    Jp10 = G10 * R00 + G11 * R10 + G12 * R20
    Jp11 = G10 * R01 + G11 * R11 + G12 * R21
    Jp12 = G10 * R02 + G11 * R12 + G12 * R22

    # d(Rx)/dw: M = -(R [x]_x)(w w^T + (R^T - I)[w]_x)/theta^2,
    # small-angle limit -[x]_x.  B = R @ skew(x)
    B00 = R01 * x2 - R02 * x1
    B01 = -R00 * x2 + R02 * x0
    B02 = R00 * x1 - R01 * x0
    B10 = R11 * x2 - R12 * x1
    B11 = -R10 * x2 + R12 * x0
    B12 = R10 * x1 - R11 * x0
    B20 = R21 * x2 - R22 * x1
    B21 = -R20 * x2 + R22 * x0
    B22 = R20 * x1 - R21 * x0
    # C = R^T - I; A = w w^T + C @ skew(w)
    C00, C01, C02 = R00 - 1.0, R10, R20
    C10, C11, C12 = R01, R11 - 1.0, R21
    C20, C21, C22 = R02, R12, R22 - 1.0
    A00 = w0 * w0 + (C01 * w2 - C02 * w1)
    A01 = w0 * w1 + (-C00 * w2 + C02 * w0)
    A02 = w0 * w2 + (C00 * w1 - C01 * w0)
    A10 = w1 * w0 + (C11 * w2 - C12 * w1)
    A11 = w1 * w1 + (-C10 * w2 + C12 * w0)
    A12 = w1 * w2 + (C10 * w1 - C11 * w0)
    A20 = w2 * w0 + (C21 * w2 - C22 * w1)
    A21 = w2 * w1 + (-C20 * w2 + C22 * w0)
    A22 = w2 * w2 + (C20 * w1 - C21 * w0)
    inv_t2 = 1.0 / th2s
    zero = torch.zeros_like(x0)
    M00 = W(-(B00 * A00 + B01 * A10 + B02 * A20) * inv_t2, zero)
    M01 = W(-(B00 * A01 + B01 * A11 + B02 * A21) * inv_t2, x2)
    M02 = W(-(B00 * A02 + B01 * A12 + B02 * A22) * inv_t2, -x1)
    M10 = W(-(B10 * A00 + B11 * A10 + B12 * A20) * inv_t2, -x2)
    M11 = W(-(B10 * A01 + B11 * A11 + B12 * A21) * inv_t2, zero)
    M12 = W(-(B10 * A02 + B11 * A12 + B12 * A22) * inv_t2, x0)
    M20 = W(-(B20 * A00 + B21 * A10 + B22 * A20) * inv_t2, x1)
    M21 = W(-(B20 * A01 + B21 * A11 + B22 * A21) * inv_t2, -x0)
    M22 = W(-(B20 * A02 + B21 * A12 + B22 * A22) * inv_t2, zero)

    # J_w = G @ M
    Jw00 = G00 * M00 + G01 * M10 + G02 * M20
    Jw01 = G00 * M01 + G01 * M11 + G02 * M21
    Jw02 = G00 * M02 + G01 * M12 + G02 * M22
    Jw10 = G10 * M00 + G11 * M10 + G12 * M20
    Jw11 = G10 * M01 + G11 * M11 + G12 * M21
    Jw12 = G10 * M02 + G11 * M12 + G12 * M22

    # Intrinsics columns.
    Jf0, Jf1 = rd * px, rd * py
    Jk10, Jk11 = f * n * px, f * n * py
    Jk20, Jk21 = f * n * n * px, f * n * n * py

    Jc = torch.stack([
        Jw00, Jw01, Jw02, G00, G01, G02, Jf0, Jk10, Jk20,
        Jw10, Jw11, Jw12, G10, G11, G12, Jf1, Jk11, Jk21,
    ])
    Jp = torch.stack([Jp00, Jp01, Jp02, Jp10, Jp11, Jp12])
    return fw["r"], Jc, Jp


@dataclasses.dataclass(frozen=True)
class ResidualJacobianFn:
    """A residual + Jacobian engine: calling it gives (r, Jc, Jp) by the
    engine contract; `residual(cam, pt, obs)` gives the same r alone."""

    jacobian: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Rows]
    residual: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                       torch.Tensor]

    def __call__(self, cam: torch.Tensor, pt: torch.Tensor,
                 obs: torch.Tensor) -> Rows:
        return self.jacobian(cam, pt, obs)


def residual_only(engine: Callable[..., Rows]) -> Callable[..., torch.Tensor]:
    """The value-only residual of an engine: its own when it carries one,
    else the engine's r (a plain callable pays for its Jacobian too)."""
    if isinstance(engine, ResidualJacobianFn):
        return engine.residual
    return lambda cam, pt, obs: engine(cam, pt, obs)[0]


def make_residual_fn(residual_fn: ResidualFn = bal_residual) -> ResidualFn:
    """Vectorised residual evaluation over feature-major per-edge params:
    fn(cam [cd, nE], pt [pd, nE], obs [od, nE]) -> r [od, nE].  The
    JAX package vmaps a one-edge function; a residual function of this
    package acts on the leading axis already, so it is its own batched
    form."""
    return residual_fn


def _autodiff(residual_fn: ResidualFn):
    """Reverse mode: od pullbacks of the batched residual, one per
    one-hot cotangent row.  The basis is exactly one-hot whatever r
    holds: an inf or NaN residual poisons only its own edge's rows."""

    def value_and_jac(cam, pt, obs):
        r, pull = torch.func.vjp(lambda c, p: residual_fn(c, p, obs),
                                 cam, pt)
        od = r.shape[0]
        eye = torch.eye(od, dtype=r.dtype, device=r.device)
        basis = eye.reshape((od, od) + (1,) * (r.dim() - 1)).expand(
            (od,) + tuple(r.shape))
        Jc, Jp = torch.func.vmap(pull)(basis)  # [od, cd, nE], [od, pd, nE]
        return (r, Jc.reshape((-1,) + tuple(cam.shape[1:])),
                Jp.reshape((-1,) + tuple(pt.shape[1:])))

    return value_and_jac


def _autodiff_forward(residual_fn: ResidualFn):
    """Forward mode: cd+pd pushforwards along the one-hot tangent rows
    (each broadcast over all edges); under vmap the primal runs once."""

    def value_and_jac(cam, pt, obs):
        cd, pd = cam.shape[0], pt.shape[0]
        eye = torch.eye(cd + pd, dtype=cam.dtype, device=cam.device)
        basis = eye.reshape((cd + pd, cd + pd) + (1,) * (cam.dim() - 1))
        basis = basis.expand((cd + pd, cd + pd) + tuple(cam.shape[1:]))

        def push(t):
            return torch.func.jvp(lambda c, p: residual_fn(c, p, obs),
                                  (cam, pt), (t[:cd], t[cd:]))

        r, J = torch.func.vmap(push, out_dims=(None, 0))(basis)
        od = r.shape[0]
        # J[a, o] = dr_o/dx_a -> rows o*cd+a and o*pd+b.
        Jc = J[:cd].transpose(0, 1).reshape((od * cd,) + tuple(r.shape[1:]))
        Jp = J[cd:].transpose(0, 1).reshape((od * pd,) + tuple(r.shape[1:]))
        return r, Jc, Jp

    return value_and_jac


def build_residual_jacobian_fn(
    residual_fn: ResidualFn = bal_residual,
    mode: JacobianMode = JacobianMode.AUTODIFF,
    analytical_fn: Optional[Callable[..., Rows]] = None,
) -> ResidualJacobianFn:
    """Build the vectorised residual + Jacobian engine (uncached).

    AUTODIFF (reverse mode) and AUTODIFF_FORWARD (forward mode) compute
    the same Jacobian of `residual_fn`; ANALYTICAL uses a closed-form
    row-form function, by default the BAL one above, and needs
    `analytical_fn` for any other residual.  Per-problem closures go
    through this function; `make_residual_jacobian_fn` is the memoised
    front for long-lived residual functions.
    """
    if mode == JacobianMode.ANALYTICAL:
        fn = analytical_fn
        if fn is None:
            if residual_fn is not bal_residual:
                raise ValueError(
                    "ANALYTICAL mode needs analytical_fn for custom residuals")
            return ResidualJacobianFn(bal_residual_jacobian_analytical_fm,
                                      bal_residual_analytical_fm)
        return ResidualJacobianFn(fn, residual_only(fn))
    if mode == JacobianMode.AUTODIFF_FORWARD:
        return ResidualJacobianFn(_autodiff_forward(residual_fn), residual_fn)
    if mode == JacobianMode.AUTODIFF:
        return ResidualJacobianFn(_autodiff(residual_fn), residual_fn)
    raise ValueError(f"unknown jacobian mode {mode!r}")


@functools.lru_cache(maxsize=64)
def _cached_engine(residual_fn, mode, analytical_fn) -> ResidualJacobianFn:
    return build_residual_jacobian_fn(residual_fn, mode, analytical_fn)


def make_residual_jacobian_fn(
    residual_fn: ResidualFn = bal_residual,
    mode: JacobianMode = JacobianMode.AUTODIFF,
    analytical_fn: Optional[Callable[..., Rows]] = None,
) -> ResidualJacobianFn:
    """Memoised `build_residual_jacobian_fn`: one engine configuration,
    however it is spelled (positional or keyword), returns the identical
    engine.  Only pass long-lived residual functions (module level);
    a per-problem closure would stay pinned in the cache."""
    return _cached_engine(residual_fn, mode, analytical_fn)


def apply_sqrt_info_residual(r: torch.Tensor,
                             sqrt_info: Optional[torch.Tensor]) -> torch.Tensor:
    """Pre-whiten residual rows r [od, nE] by sqrt_info [od*od, nE]."""
    if sqrt_info is None:
        return r
    od = r.shape[0]
    return torch.stack([
        sum(sqrt_info[o * od + j] * r[j] for j in range(od))
        for o in range(od)
    ])


def apply_sqrt_info(
    r: torch.Tensor,
    Jc: torch.Tensor,
    Jp: torch.Tensor,
    sqrt_info: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pre-whiten residuals and Jacobians by the sqrt information matrix.

    sqrt_info is [od*od, nE] (row o*od+j = L_oj per edge); with
    information Sigma^-1 = L^T L this gives r~ = L r and J~ = L J.
    """
    if sqrt_info is None:
        return r, Jc, Jp
    od = r.shape[0]
    cd = Jc.shape[0] // od
    pd = Jp.shape[0] // od

    def rows(J, d):
        return torch.stack([
            sum(sqrt_info[o * od + j] * J[j * d + a] for j in range(od))
            for o in range(od) for a in range(d)
        ])

    return apply_sqrt_info_residual(r, sqrt_info), rows(Jc, cd), rows(Jp, pd)

"""Robust losses by IRLS reweighting (port of `megba_tpu/ops/robust.py`).

With s = ||r||^2 per edge, the robustified objective Sum rho(s) is
minimised by weighting each edge's residual and Jacobian rows with
w = sqrt(rho'(s)) at every linearisation (no Triggs second-order
correction, as in the JAX package: it can break positive
definiteness).  Every loss has rho(s) ~= s near 0 and rho'(s) <= 1, so
the damped Schur blocks stay SPD.
"""

from __future__ import annotations

from typing import Tuple

import torch

from megba_tpu_torch.common import RobustKind


def rho_and_weight(s: torch.Tensor, kind: RobustKind,
                   delta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rho(s), sqrt(rho'(s))) elementwise over squared norms s >= 0.

    Huber (on the squared norm, Ceres's HuberLoss with delta^2 the
    threshold on s): rho(s) = s for s <= delta^2, else
    2 delta sqrt(s) - delta^2.  Cauchy: rho(s) = delta^2 log(1 + s/delta^2).
    """
    d2 = delta * delta
    if kind == RobustKind.NONE:
        return s, torch.ones_like(s)
    if kind == RobustKind.HUBER:
        sqrt_s = torch.sqrt(torch.clamp(s, min=1e-30))
        inside = s <= d2
        rho = torch.where(inside, s, 2.0 * delta * sqrt_s - d2)
        # rho'(s) = 1 inside, delta / sqrt(s) outside.
        w2 = torch.where(inside, torch.ones_like(s), delta / sqrt_s)
        return rho, torch.sqrt(w2)
    if kind == RobustKind.CAUCHY:
        rho = d2 * torch.log1p(s / d2)
        w2 = 1.0 / (1.0 + s / d2)  # rho'(s)
        return rho, torch.sqrt(w2)
    raise ValueError(f"unknown robust kind {kind}")


def robustify(
    r: torch.Tensor,
    Jc: torch.Tensor,
    Jp: torch.Tensor,
    kind: RobustKind,
    delta: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reweight (r, Jc, Jp) per edge and return rho per edge too.

    Feature-major: the information- and mask-weighted residual rows
    r [od, nE] and Jacobian rows Jc [od*cd, nE] / Jp [od*pd, nE]; the
    returned rho [nE] sums to the robustified cost.
    """
    s = (r * r).sum(0)
    rho, w = rho_and_weight(s, kind, delta)
    wm = w[None, :]
    return r * wm, Jc * wm, Jp * wm, rho

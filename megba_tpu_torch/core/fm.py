"""Feature-major ("fm") edge-array layout helpers, in PyTorch.

Every per-edge and per-vertex array is stored feature-major, `[F, N]`
with the long axis minor, as in `megba_tpu/core/fm.py`.  Flattened blocks
follow the same row convention: `J[o * d + a]` is d r_o / d x_a.

On the GPU the layout keeps each feature row contiguous, so a thread per
edge reads neighbouring addresses across a warp (coalesced loads).
"""

from __future__ import annotations

import torch

# Kept for parity with the JAX package, whose lowering pads the edge axis
# to this multiple.  The port's CSR plans need no padding (ops/segtiles.py).
EDGE_QUANTUM = 2048


def gather_fm(params: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-edge gather: [F, N] params, [nE] indices -> [F, nE]."""
    return params.index_select(1, idx)


def segsum_fm(data: torch.Tensor, idx: torch.Tensor,
              num_segments: int) -> torch.Tensor:
    """Scatter-add of [F, nE] rows into [F, num_segments], in a fixed
    order: the edges are stably sorted by index and each segment summed
    in edge order (`torch.segment_reduce`), so two runs on the card are
    bitwise equal, where `index_add_`'s CUDA atomics are not."""
    idx = idx.long()
    order = torch.sort(idx, stable=True).indices
    counts = torch.bincount(idx, minlength=num_segments)
    seg_ptr = torch.zeros(num_segments + 1, dtype=torch.int64,
                          device=data.device)
    torch.cumsum(counts, 0, out=seg_ptr[1:])
    rows = data.index_select(1, order)
    if rows.shape[1] == 0:
        return torch.zeros((data.shape[0], num_segments), dtype=data.dtype,
                           device=data.device)
    offsets = seg_ptr.expand(data.shape[0], num_segments + 1).contiguous()
    return torch.segment_reduce(rows, "sum", offsets=offsets, axis=1,
                                unsafe=True)


def coupling_rows(Jc: torch.Tensor, Jp: torch.Tensor, od: int) -> torch.Tensor:
    """Per-edge coupling block rows W = Jc^T Jp: [cd*pd, n], row a*pd+b."""
    cd = Jc.shape[0] // od
    pd = Jp.shape[0] // od
    return torch.stack([
        sum(Jc[o * cd + a] * Jp[o * pd + b] for o in range(od))
        for a in range(cd) for b in range(pd)
    ])


def block_matvec_fm(H: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Row-form block-diagonal matvec: H [d*d, N] times x [d, N] -> [d, N]."""
    d = x.shape[0]
    return torch.stack(
        [sum(H[i * d + j] * x[j] for j in range(d)) for i in range(d)])


def block_inv_fm(H: torch.Tensor) -> torch.Tensor:
    """Row-form batched inverse of [d*d, N] SPD blocks, d in {1, 2, 3}
    (closed-form adjugate, the same arithmetic as the JAX package)."""
    dd = H.shape[0]
    if dd == 1:
        return 1.0 / H
    if dd == 4:
        a, b, c, e = H[0], H[1], H[2], H[3]
        det = a * e - b * c
        return torch.stack([e, -b, -c, a]) / det
    if dd == 9:
        a, b, c = H[0], H[1], H[2]
        d_, e, f = H[3], H[4], H[5]
        g, h, i = H[6], H[7], H[8]
        A = e * i - f * h
        B = c * h - b * i
        C = b * f - c * e
        D = f * g - d_ * i
        E = a * i - c * g
        F = c * d_ - a * f
        G = d_ * h - e * g
        Hc = b * g - a * h
        I = a * e - b * d_
        det = a * A + b * D + c * G
        return torch.stack([A, B, C, D, E, F, G, Hc, I]) / det
    raise NotImplementedError(f"block_inv_fm: unsupported block size {dd}")


def damp_rows_fm(H: torch.Tensor, region: torch.Tensor) -> torch.Tensor:
    """LM damping on [d*d, N] rows: diagonal rows scale by (1 + 1/region)."""
    dd = H.shape[0]
    d = int(round(dd ** 0.5))
    diag = torch.tensor([1.0 if r % (d + 1) == 0 else 0.0 for r in range(dd)],
                        dtype=H.dtype, device=H.device)
    factor = 1.0 + diag / region
    return H * factor[:, None]

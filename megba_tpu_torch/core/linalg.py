"""Small host-side (numpy) linear-algebra helpers.

A copy of `megba_tpu/core/linalg.py`: the Problem facade turns
information matrices into square-root weights with `psd_sqrt`.
"""

from __future__ import annotations

import numpy as np


def psd_sqrt(info: np.ndarray, what: str = "element") -> np.ndarray:
    """Matrix square-root weights W with W^T W = info, batched [..., n, n].

    A symmetric eigendecomposition rather than a Cholesky factor, so a
    positive-SEMIdefinite matrix (a zero row: a deliberately unconstrained
    degree of freedom) factors cleanly; small negative eigenvalues from
    text round-off are clamped to zero.  Raises ValueError naming the
    first offending batch element for an indefinite input.
    """
    info = np.asarray(info)
    w, v = np.linalg.eigh(info)  # info = V diag(w) V^T
    floor = -1e-9 * np.maximum(w.max(axis=-1, keepdims=True), 1.0)
    bad = np.nonzero((w < floor).reshape(-1, w.shape[-1]).any(axis=-1))[0]
    if bad.size:
        flat_w = w.reshape(-1, w.shape[-1])
        raise ValueError(
            f"{what} {int(bad[0])} (of {flat_w.shape[0]}) has an "
            f"indefinite information matrix (eigenvalues "
            f"{flat_w[bad[0]]})")
    # W = diag(sqrt(w)) V^T satisfies W^T W = info.
    return np.sqrt(np.maximum(w, 0.0))[..., :, None] * np.swapaxes(
        v, -1, -2)

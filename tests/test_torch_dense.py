"""The port's dense solves (solver/dense.py) vs the JAX package's, float64.

- `dense_filtered_factor` / `dense_filtered_solve`: the filtered
  pseudo-inverse A^+ = Q diag(inv) Q^T and its solve at 1e-12 relative,
  with equal `ok`, on spectra with kept, repeated, sub-floor, zero and
  negative eigenvalues (eigenvectors and their signs may differ between
  LAPACK implementations, A^+ does not: Q is never compared);
- a NaN, an infinite and an all-zero matrix give `ok=False` and a zero
  factor without raising, as in JAX;
- `dense_reference_solve` against JAX's at 1e-12, on IMPLICIT and EXPLICIT
  systems.

CPU only.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import megba_tpu.common as jc
from megba_tpu.solver import dense as jdense

from megba_tpu_torch.convert import schur_system_to_torch
from megba_tpu_torch.solver import dense as tdense

from tests.test_solver import build_test_system

FLOOR = 1e-5  # solver/precond._COARSE_EIG_FLOOR


def _spectrum_matrix(eigs, seed):
    rng = np.random.default_rng(seed)
    n = len(eigs)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.asarray(eigs, float)) @ Q.T
    return 0.5 * (A + A.T)


def _pinv(factor):
    Q, inv = (np.asarray(x) for x in factor)
    return (Q * inv) @ Q.T


_SPECTRA = {
    "spd": np.geomspace(1e3, 1.0, 12),
    # A repeated top eigenvalue, two modes under the floor (1e-5 of the
    # largest), an exact null mode and a slightly negative one.
    "filtered": [50.0, 50.0, 50.0, 7.0, 3.0, 1.0, 0.2, 3e-5, 1e-7, 0.0,
                 -1e-9, 2.0],
    # A repeated eigenvalue well inside the kept range beside a cluster
    # far under the floor.
    "clustered": [1.0] * 5 + [1e-3] * 3 + [1e-9] * 4,
}


@pytest.mark.parametrize("name", list(_SPECTRA))
def test_dense_filtered_factor_and_solve_match_jax(name):
    A = _spectrum_matrix(_SPECTRA[name], seed=len(name))
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    tf, tok = tdense.dense_filtered_factor(torch.from_numpy(A), FLOOR)
    jf, jok = jdense.dense_filtered_factor(jnp.asarray(A), FLOOR)
    assert bool(tok) == bool(jok) is True
    want = _pinv(jf)
    np.testing.assert_allclose(_pinv(tf), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    got_x = tdense.dense_filtered_solve(tf, torch.from_numpy(b)).numpy()
    want_x = np.asarray(jdense.dense_filtered_solve(jf, jnp.asarray(b)))
    np.testing.assert_allclose(got_x, want_x, rtol=1e-12,
                               atol=1e-12 * np.abs(want_x).max())
    # The filter drops exactly the modes at or under the floor.
    lam = np.asarray(_SPECTRA[name], float)
    kept = int((lam > FLOOR * lam.max()).sum())
    assert int((tf[1] != 0).sum()) == kept


@pytest.mark.parametrize("poison", ["nan", "inf", "zero"])
def test_poisoned_matrix_gives_not_ok_without_raising(poison):
    A = _spectrum_matrix(_SPECTRA["spd"], seed=3)
    if poison == "zero":
        A = np.zeros_like(A)
    else:
        A[2, 5] = A[5, 2] = np.nan if poison == "nan" else np.inf
    (Q, inv), ok = tdense.dense_filtered_factor(torch.from_numpy(A), FLOOR)
    _, jok = jdense.dense_filtered_factor(jnp.asarray(A), FLOOR)
    assert not bool(ok) and not bool(jok)
    assert not Q.any() and torch.isfinite(inv).all()
    x = tdense.dense_filtered_solve((Q, inv), torch.ones(A.shape[0],
                                                         dtype=torch.float64))
    assert not x.any()


@pytest.mark.parametrize("kind", ["IMPLICIT", "EXPLICIT"])
def test_dense_reference_solve_matches_jax(kind):
    jsys, _, jJc, jJp, ci, pi = build_test_system(
        seed=1, num_cameras=3, num_points=10,
        compute_kind=jc.ComputeKind[kind])
    region = 100.0
    want = jdense.dense_reference_solve(jsys, jJc, jJp, ci, pi,
                                        jnp.asarray(region))
    got = tdense.dense_reference_solve(
        schur_system_to_torch(jsys, device="cpu"),
        torch.from_numpy(np.array(jJc)), torch.from_numpy(np.array(jJp)),
        torch.from_numpy(np.array(ci)), torch.from_numpy(np.array(pi)),
        torch.tensor(region, dtype=torch.float64))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max())

"""The co-observation edge order (`EdgeOrder.COOBS`) in the port vs the JAX
package, float64.

The synthetic scenes come camera-sorted and point-ascending within a
camera, where COOBS is nearly the identity, so every solve here first
shuffles the edges with a seeded permutation: NATURAL and COOBS then lay
out different slot orders.

- `coobservation_edge_order` equal to JAX's;
- `flat_solve` with COOBS on a shuffled scene against JAX's COOBS solve
  at rtol 1e-9 (trial costs, accept pattern, counts), and against the
  port's NATURAL solve at rtol 1e-6 (final cost);
- with `sqrt_info`, `edge_mask` and a fault plan, all carried through the
  same permutation, against JAX's.

CPU only.
"""

import numpy as np
import pytest

import megba_tpu.common as jc
from megba_tpu.ops import segtiles as jseg
from megba_tpu.robustness import faults as jfaults

import megba_tpu_torch as mt
from megba_tpu_torch.convert import fault_plan_to_torch
from megba_tpu_torch.ops import segtiles as tseg

from test_torch_guards import _jax_solve, _options, _scene
from test_torch_guards import compare_robust

COOBS = dict(edge_order=mt.EdgeOrder.COOBS)


def _shuffled(seed=11):
    """The parity scene with its edges in a seeded random order."""
    s = _scene()
    perm = np.random.default_rng(seed).permutation(s.obs.shape[0])
    return (s.cameras0, s.points0, s.obs[perm], s.cam_idx[perm],
            s.pt_idx[perm])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coobservation_edge_order_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 500
    ci = rng.integers(0, 9, n).astype(np.int32)
    pi = rng.integers(0, 60, n).astype(np.int32)
    got = tseg.coobservation_edge_order(ci, pi)
    np.testing.assert_array_equal(got, jseg.coobservation_edge_order(ci, pi))
    key = ci[got].astype(np.int64) * 1000 + pi[got]
    assert (np.diff(key) >= 0).all()


@pytest.mark.parametrize("kind,fused", [("IMPLICIT", False),
                                        ("EXPLICIT", False),
                                        ("IMPLICIT", True)])
def test_coobs_flat_solve_matches_jax(kind, fused):
    args = _shuffled()
    jopt, topt = _options(False, kind, fused, **COOBS)
    jres = _jax_solve(args, jopt)
    tres = mt.flat_solve(*args, topt, device="cpu")
    compare_robust(jres, tres)
    _, natural = _options(False, kind, fused)
    nres = mt.flat_solve(*args, natural, device="cpu")
    np.testing.assert_allclose(float(tres.cost), float(nres.cost),
                               rtol=1e-6)
    # A different slot order: the sums differ in their last bits.
    assert not np.array_equal(tres.trace.cost.numpy(),
                              nres.trace.cost.numpy())


def test_coobs_carries_sqrt_info_mask_and_fault_plan():
    args = _shuffled(5)
    n = args[2].shape[0]
    rng = np.random.default_rng(4)
    extra = dict(
        sqrt_info=np.tril(0.3 * rng.standard_normal((n, 2, 2))) + np.eye(2),
        edge_mask=(rng.random(n) > 0.05).astype(np.float64))
    plan = jfaults.make_nan_burst(n, [3, 40], start=0, stop=1)
    jopt, topt = _options(True, **COOBS)
    jres = _jax_solve(args, jopt, fault_plan=plan, **extra)
    tres = mt.flat_solve(*args, topt, device="cpu",
                         fault_plan=fault_plan_to_torch(plan), **extra)
    t = compare_robust(jres, tres)
    assert tres.status == mt.SolveStatus.RECOVERED
    assert t["trace"]["recovery"][0]
    # The same solve in NATURAL order reaches the same cost.
    _, natural = _options(True)
    nres = mt.flat_solve(*args, natural, device="cpu",
                         fault_plan=fault_plan_to_torch(plan), **extra)
    np.testing.assert_allclose(float(tres.cost), float(nres.cost),
                               rtol=1e-6)
    assert jc.EdgeOrder.COOBS.value == mt.EdgeOrder.COOBS.value

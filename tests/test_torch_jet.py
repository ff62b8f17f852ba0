"""The port's `Jet` (JetVector-style forward-mode dual numbers) vs
`torch.func.jvp` and vs the JAX package's `Jet`, float64.

Each operator runs on jets with random values and random gradient rows
(N = 3 gradient slots over n = 40 items); its value and gradient are
held to `torch.func.jvp` of the same function along the same tangents
(rtol 1e-13) and to the JAX `Jet` on the same inputs (rtol 1e-14).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megba_tpu.ops.jet import Jet as JJet
from megba_tpu.ops.jet import seed_jets as j_seed_jets

from megba_tpu_torch import Jet, seed_jets

# One intra-op thread: the suite runs several test processes a core,
# and the port's small operations lose more to thread hand-offs
# than they gain.
torch.set_num_threads(1)

N, n = 3, 40

# name -> (jet op, the same function on tensors); x and y are the two
# operands, c a Python scalar.
C = 1.7
OPS = {
    "add": (lambda x, y: x + y, lambda x, y: x + y),
    "add_scalar": (lambda x, y: x + C, lambda x, y: x + C),
    "radd_scalar": (lambda x, y: C + x, lambda x, y: C + x),
    "sub": (lambda x, y: x - y, lambda x, y: x - y),
    "sub_scalar": (lambda x, y: x - C, lambda x, y: x - C),
    "rsub_scalar": (lambda x, y: C - x, lambda x, y: C - x),
    "mul": (lambda x, y: x * y, lambda x, y: x * y),
    "mul_scalar": (lambda x, y: x * C, lambda x, y: x * C),
    "rmul_scalar": (lambda x, y: C * x, lambda x, y: C * x),
    "div": (lambda x, y: x / y, lambda x, y: x / y),
    "div_scalar": (lambda x, y: x / C, lambda x, y: x / C),
    "rdiv_scalar": (lambda x, y: C / x, lambda x, y: C / x),
    "neg": (lambda x, y: -x, lambda x, y: -x),
    "abs": (lambda x, y: x.abs(), lambda x, y: x.abs()),
    "sqrt": (lambda x, y: (x * x + 1.0).sqrt(),
             lambda x, y: torch.sqrt(x * x + 1.0)),
    "sin": (lambda x, y: x.sin(), lambda x, y: torch.sin(x)),
    "cos": (lambda x, y: x.cos(), lambda x, y: torch.cos(x)),
    "chain": (lambda x, y: ((x * y).sin() + y.cos() / (x.abs() + 2.0)) * 3.0,
              lambda x, y: (torch.sin(x * y) + torch.cos(y)
                            / (x.abs() + 2.0)) * 3.0),
}


def _inputs():
    rng = np.random.default_rng(0)
    xv, yv = rng.standard_normal(n), rng.standard_normal(n) + 3.0
    xg, yg = rng.standard_normal((N, n)), rng.standard_normal((N, n))
    return xv, yv, xg, yg


@pytest.mark.parametrize("name", list(OPS))
def test_jet_op_matches_jvp_and_jax(name):
    jet_op, fn = OPS[name]
    xv, yv, xg, yg = _inputs()
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    got = jet_op(Jet(t(xv), t(xg)), Jet(t(yv), t(yg)))
    assert isinstance(got, Jet) and got.grad.shape == (N, n)

    def push(gx, gy):
        return torch.func.jvp(fn, (t(xv), t(yv)), (gx, gy))

    value, grad = torch.func.vmap(push, out_dims=(None, 0))(t(xg), t(yg))
    np.testing.assert_allclose(got.value.numpy(), value.numpy(), rtol=1e-13,
                               atol=1e-14)
    np.testing.assert_allclose(got.grad.numpy(), grad.numpy(), rtol=1e-13,
                               atol=1e-13)
    want = jet_op(JJet(jnp.asarray(xv), jnp.asarray(xg)),
                  JJet(jnp.asarray(yv), jnp.asarray(yg)))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-14, atol=0)
    np.testing.assert_allclose(got.grad.numpy(), np.asarray(want.grad),
                               rtol=1e-14, atol=1e-15)


def test_constant_variable_and_seed_jets():
    v = torch.arange(5, dtype=torch.float64)
    c = Jet.constant(v, 4)
    assert c.n_grad == 4 and not c.grad.any()
    x = Jet.variable(v, 4, 2)
    np.testing.assert_array_equal(
        x.grad.numpy(), np.asarray(JJet.variable(jnp.asarray(v.numpy()), 4,
                                                 2).grad))
    vals = [np.linspace(0.5, 1.5, 6) * (i + 1) for i in range(3)]
    jets, jjets = seed_jets(vals), j_seed_jets(vals)
    for a, b in zip(jets, jjets):
        assert a.n_grad == 3 and a.value.dtype == torch.float64
        np.testing.assert_array_equal(a.value.numpy(), np.asarray(b.value))
        np.testing.assert_array_equal(a.grad.numpy(), np.asarray(b.grad))
    # The seeded gradients form the identity: a function of the jets
    # carries its whole Jacobian, here of f(a, b, c) = a * b / c.
    f = jets[0] * jets[1] / jets[2]
    a, b, cc = (torch.from_numpy(v) for v in vals)
    np.testing.assert_allclose(
        f.grad.numpy(),
        torch.stack([b / cc, a / cc, -a * b / cc ** 2]).numpy(), rtol=1e-14)

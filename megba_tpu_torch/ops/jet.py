"""Vectorised forward-mode dual numbers, the JetVector-style API (PyTorch).

Counterpart of `megba_tpu/ops/jet.py`: a `Jet` holds one scalar slot of
all edges at once, `value [n]` and `grad [N, n]` (grad-major), and
supports +, -, *, / (jet with jet or scalar, both orders), unary minus,
abs, sqrt, sin and cos.  A constant is `Jet.constant` (zero gradient),
a differentiation variable `Jet.variable` (one-hot gradient), and
`seed_jets` seeds one variable per scalar parameter.

The solver does not route through this class: its AUTODIFF_FORWARD
engine is `torch.func.jvp` under `vmap` (ops/residuals.py).  It is the
building block for code written against JetVector, and each op is held
against `torch.func.jvp` in the tests.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import torch

Scalar = Union[float, int, torch.Tensor]


@dataclasses.dataclass
class Jet:
    """A batch of dual numbers: value [n], grad [N, n]."""

    value: torch.Tensor
    grad: torch.Tensor

    @staticmethod
    def constant(value, n_grad: int) -> "Jet":
        """A jet with zero derivative."""
        value = torch.as_tensor(value)
        return Jet(value, torch.zeros((n_grad,) + tuple(value.shape),
                                      dtype=value.dtype, device=value.device))

    @staticmethod
    def variable(value, n_grad: int, index: int) -> "Jet":
        """A differentiation variable: its gradient is one-hot at `index`."""
        value = torch.as_tensor(value)
        grad = torch.zeros((n_grad,) + tuple(value.shape), dtype=value.dtype,
                           device=value.device)
        grad[index] = 1.0
        return Jet(value, grad)

    @property
    def n_grad(self) -> int:
        return self.grad.shape[0]

    def _coerce(self, other) -> "Jet":
        if isinstance(other, Jet):
            return other
        value = torch.as_tensor(other, dtype=self.value.dtype,
                                device=self.value.device)
        return Jet.constant(value.expand(self.value.shape), self.n_grad)

    def __add__(self, other) -> "Jet":
        o = self._coerce(other)
        return Jet(self.value + o.value, self.grad + o.grad)

    __radd__ = __add__

    def __sub__(self, other) -> "Jet":
        o = self._coerce(other)
        return Jet(self.value - o.value, self.grad - o.grad)

    def __rsub__(self, other) -> "Jet":
        o = self._coerce(other)
        return Jet(o.value - self.value, o.grad - self.grad)

    def __mul__(self, other) -> "Jet":
        o = self._coerce(other)
        return Jet(self.value * o.value,
                   self.grad * o.value + o.grad * self.value)

    __rmul__ = __mul__

    def __truediv__(self, other) -> "Jet":
        o = self._coerce(other)
        inv = 1.0 / o.value
        return Jet(self.value * inv,
                   (self.grad - o.grad * (self.value * inv)) * inv)

    def __rtruediv__(self, other) -> "Jet":
        return self._coerce(other) / self

    def __neg__(self) -> "Jet":
        return Jet(-self.value, -self.grad)

    def abs(self) -> "Jet":
        return Jet(self.value.abs(), self.grad * torch.sign(self.value))

    def sqrt(self) -> "Jet":
        root = torch.sqrt(self.value)
        return Jet(root, self.grad * (0.5 / root))

    def sin(self) -> "Jet":
        return Jet(torch.sin(self.value), self.grad * torch.cos(self.value))

    def cos(self) -> "Jet":
        return Jet(torch.cos(self.value), -self.grad * torch.sin(self.value))


def seed_jets(values: Sequence, dtype=None) -> list:
    """One `Jet` variable per scalar parameter: `values` is a list of [n]
    tensors, each one parameter for all n edges; the returned jets'
    gradients form the identity."""
    n_grad = len(values)
    return [Jet.variable(torch.as_tensor(v, dtype=dtype), n_grad, i)
            for i, v in enumerate(values)]

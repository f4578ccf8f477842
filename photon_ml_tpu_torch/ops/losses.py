"""Pointwise GLM losses: l(z, y), dl/dz, d2l/dz2, on tensors.

Port of ``photon_ml_tpu/ops/losses.py:36-169``. Each loss is a
:class:`PointwiseLoss` of three plain functions over whole margin tensors;
the formulas are the JAX package's, and the CUDA kernel
(``csrc/fused_value_gradient.cu``) evaluates the same ones per row:

- logistic:       l = log1p_exp(z) - y z,  l' = sigmoid(z) - y
- squared:        l = (z - y)^2 / 2,        l' = z - y
- poisson:        l = exp(z) - y z,         l' = exp(z) - y
- smoothed hinge: Rennie's piecewise form with y_pm = 2y - 1
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor

#: Integer codes the CUDA kernel takes for each loss (template dispatch).
LOSS_CODES = {"logistic": 0, "squared": 1, "poisson": 2,
              "smoothed_hinge": 3}


def log1p_exp(x: Tensor) -> Tensor:
    """Stable log(1 + exp(x)) = max(x, 0) + log1p(exp(-|x|)) — the
    ``jnp.logaddexp(0, x)`` of ``losses.py:36-43`` written out."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def sigmoid(x: Tensor) -> Tensor:
    """Branch-wise stable sigmoid (``losses.py:46-53``)."""
    e = torch.exp(-x.abs())
    return torch.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    """Bundle of pointwise loss derivatives (``losses.py:56-66``)."""

    name: str
    loss: Callable[[Tensor, Tensor], Tensor]
    d1: Callable[[Tensor, Tensor], Tensor]
    d2: Callable[[Tensor, Tensor], Tensor]

    def loss_and_d1(self, z: Tensor, y: Tensor) -> tuple[Tensor, Tensor]:
        return self.loss(z, y), self.d1(z, y)

    @property
    def code(self) -> int:
        return LOSS_CODES[self.name]


def _logistic_loss(z, y):
    return log1p_exp(z) - y * z


def _logistic_d1(z, y):
    return sigmoid(z) - y


def _logistic_d2(z, y):
    s = sigmoid(z)
    return s * (1.0 - s)


logistic_loss = PointwiseLoss("logistic", _logistic_loss, _logistic_d1,
                              _logistic_d2)


def _squared_loss(z, y):
    d = z - y
    return 0.5 * d * d


squared_loss = PointwiseLoss(
    "squared", _squared_loss, lambda z, y: z - y,
    lambda z, y: torch.ones_like(z))

poisson_loss = PointwiseLoss(
    "poisson",
    lambda z, y: torch.exp(z) - y * z,
    lambda z, y: torch.exp(z) - y,
    lambda z, y: torch.exp(z),
)


def _hinge_t(z, y):
    return (2.0 * y - 1.0) * z


def _smoothed_hinge_loss(z, y):
    t = _hinge_t(z, y)
    zero = torch.zeros_like(t)
    return torch.where(t >= 1.0, zero,
                       torch.where(t <= 0.0, 0.5 - t, 0.5 * (1.0 - t) ** 2))


def _smoothed_hinge_d1(z, y):
    t = _hinge_t(z, y)
    y_pm = 2.0 * y - 1.0
    dldt = torch.where(t >= 1.0, torch.zeros_like(t),
                       torch.where(t <= 0.0, -torch.ones_like(t), t - 1.0))
    return y_pm * dldt


def _smoothed_hinge_d2(z, y):
    t = _hinge_t(z, y)
    return torch.where((t > 0.0) & (t < 1.0), torch.ones_like(t),
                       torch.zeros_like(t))


smoothed_hinge_loss = PointwiseLoss(
    "smoothed_hinge", _smoothed_hinge_loss, _smoothed_hinge_d1,
    _smoothed_hinge_d2)

LOSSES: dict[str, PointwiseLoss] = {
    l.name: l
    for l in (logistic_loss, squared_loss, poisson_loss, smoothed_hinge_loss)
}


def get_loss(name: str) -> PointwiseLoss:
    try:
        return LOSSES[name]
    except KeyError:
        raise ValueError(f"unknown loss '{name}'; known: {sorted(LOSSES)}") from None

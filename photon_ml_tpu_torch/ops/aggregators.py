"""GLM objective: value+gradient, Hessian-vector, Hessian-diagonal.

Port of ``photon_ml_tpu/ops/aggregators.py:35-220`` without the mesh
collectives (``axis_name``/``qpsum`` wait for the multi-GPU slice).

- ``_pallas_sums`` (``:35-55``): a 2-D dense batch that passes the gate
  goes through the fused CUDA kernel; everything else takes the two-pass
  torch form below (``:85-91``), the JAX package's own non-Pallas path.
- 3-D ``[E, N, D]`` batches (the random-effect entity blocks) run the same
  formulas with a leading lane axis: coefficients ``[E, D]``, values
  ``[E]`` — what ``jax.vmap`` of the 2-D function computes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.data.batch import DenseBatch
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.pallas_kernels import (
    fused_value_gradient_sums,
    pallas_supported,
)

Tensor = torch.Tensor


def _pallas_sums(loss: PointwiseLoss, w_eff: Tensor, margin_shift: Tensor,
                 batch) -> Optional[tuple[Tensor, Tensor, Tensor]]:
    """Fused (value, vector_sum, prefactor_sum) when the gate admits the
    batch; None when the two-pass form should run instead."""
    if not isinstance(batch, DenseBatch) or batch.X.dim() != 2:
        return None
    n, d = batch.X.shape
    if not pallas_supported(n, d, batch.X.dtype, batch.X.device):
        return None
    return fused_value_gradient_sums(
        loss, batch.X, batch.labels, batch.offsets, batch.weights, w_eff,
        margin_shift, device=batch.X.device)


def value_and_gradient(loss: PointwiseLoss, norm: NormalizationContext,
                       coef: Tensor, batch) -> tuple[Tensor, Tensor]:
    """Weighted loss value and gradient in normalized coefficient space."""
    w_eff, margin_shift = norm.effective_coefficients(coef)
    sums = _pallas_sums(loss, w_eff, margin_shift, batch)
    if sums is not None:
        value, vector_sum, prefactor_sum = sums
    else:
        z = batch.margins(w_eff, margin_shift)
        l, d1 = loss.loss_and_d1(z, batch.labels)
        value = (batch.weights * l).sum(-1)
        r = batch.weights * d1
        vector_sum = batch.weighted_feature_sum(r)
        prefactor_sum = r.sum(-1)
    return value, norm.reconstruct_gradient(vector_sum, prefactor_sum)


def hessian_vector(loss: PointwiseLoss, norm: NormalizationContext,
                   coef: Tensor, vector: Tensor, batch) -> Tensor:
    """Gauss-Newton Hessian-vector product H v (``aggregators.py:98-123``)."""
    w_eff, margin_shift = norm.effective_coefficients(coef)
    v_eff, v_shift = norm.effective_coefficients(vector)
    z = batch.margins(w_eff, margin_shift)
    zv = batch.margins(v_eff, v_shift) - batch.offsets
    r = batch.weights * loss.d2(z, batch.labels) * zv
    return norm.reconstruct_gradient(batch.weighted_feature_sum(r),
                                     r.sum(-1))


def hessian_diagonal(loss: PointwiseLoss, norm: NormalizationContext,
                     coef: Tensor, batch) -> Tensor:
    """Diagonal of the Gauss-Newton Hessian (``aggregators.py:126-154``)."""
    w_eff, margin_shift = norm.effective_coefficients(coef)
    z = batch.margins(w_eff, margin_shift)
    r = batch.weights * loss.d2(z, batch.labels)
    diag = batch.hadamard_square_sum(r)
    if norm.shifts is not None:
        lin_sum = batch.weighted_feature_sum(r)
        scalar_sum = r.sum(-1).unsqueeze(-1)
        diag = diag - 2.0 * norm.shifts * lin_sum \
            + norm.shifts ** 2 * scalar_sum
    if norm.factors is not None:
        diag = diag * norm.factors ** 2
    return diag


@dataclasses.dataclass(frozen=True)
class GLMObjective:
    """GLM objective over a batch with the L2 mixin folded in
    (``aggregators.py:157-220``): + lambda/2 ||w||^2 on the value,
    + lambda w on the gradient, + lambda v on Hv, + lambda on the diagonal."""

    loss: PointwiseLoss
    norm: NormalizationContext = NormalizationContext()
    l2_lambda: float = 0.0
    has_hessian: bool = True

    def value(self, coef: Tensor, batch) -> Tensor:
        return self.calculate(coef, batch)[0]

    def gradient(self, coef: Tensor, batch) -> Tensor:
        return self.calculate(coef, batch)[1]

    def calculate(self, coef: Tensor, batch) -> tuple[Tensor, Tensor]:
        value, grad = value_and_gradient(self.loss, self.norm, coef, batch)
        value = value + 0.5 * self.l2_lambda * (coef * coef).sum(-1)
        grad = grad + self.l2_lambda * coef
        return value, grad

    def hessian_vector(self, coef: Tensor, vector: Tensor, batch) -> Tensor:
        hv = hessian_vector(self.loss, self.norm, coef, vector, batch)
        return hv + self.l2_lambda * vector

    def hessian_diagonal(self, coef: Tensor, batch) -> Tensor:
        return hessian_diagonal(self.loss, self.norm, coef, batch) \
            + self.l2_lambda

    def with_l2(self, l2_lambda: float) -> "GLMObjective":
        return dataclasses.replace(self, l2_lambda=l2_lambda)

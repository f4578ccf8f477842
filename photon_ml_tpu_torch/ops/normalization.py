"""Feature normalization algebra on tensors.

Port of ``photon_ml_tpu/ops/normalization.py:54-162``
(``NormalizationContext``; building one from a feature summary waits for
the slice that ports ``stat/summary.py``). Training data is never
transformed; margins use effective coefficients and the gradient is
rebuilt from raw-feature sums:

    w_eff        = w * factors
    margin_shift = -(w_eff . shifts)
    grad_j       = factors_j * (sum_i w_i l'_i x_ij - shifts_j sum_i w_i l'_i)

Coefficients may carry a leading lane axis (``[L, D]``, one row per
entity); every operation acts on the last axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """Optional per-feature ``factors``/``shifts`` (``[D]`` tensors or
    ``None`` for the identity); ``intercept_index`` is never shifted and
    keeps factor 1 (``normalization.py:54-69``)."""

    factors: Optional[Tensor] = None
    shifts: Optional[Tensor] = None
    intercept_index: Optional[int] = None

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def effective_coefficients(self, coef: Tensor) -> tuple[Tensor, Tensor]:
        """(w_eff, margin_shift); margin_shift has coef's lane shape."""
        w_eff = coef if self.factors is None else coef * self.factors
        if self.shifts is None:
            margin_shift = torch.zeros(coef.shape[:-1], dtype=coef.dtype,
                                       device=coef.device)
        else:
            margin_shift = -(w_eff * self.shifts).sum(-1)
        return w_eff, margin_shift

    def reconstruct_gradient(self, vector_sum: Tensor,
                             prefactor_sum: Tensor) -> Tensor:
        g = vector_sum
        if self.shifts is not None:
            g = g - self.shifts * prefactor_sum.unsqueeze(-1)
        if self.factors is not None:
            g = g * self.factors
        return g

    def transform_model_coefficients(self, coef: Tensor) -> Tensor:
        """Normalized-space model -> original-space model."""
        if self.is_identity:
            return coef
        w = coef if self.factors is None else coef * self.factors
        if self.shifts is not None and self.intercept_index is not None:
            w = w.clone()
            w[..., self.intercept_index] -= (w * self.shifts).sum(-1)
        elif self.shifts is not None:
            raise ValueError(
                "STANDARDIZATION requires an intercept column to absorb shifts")
        return w

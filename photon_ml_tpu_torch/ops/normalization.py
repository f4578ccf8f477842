"""Feature normalization algebra on tensors.

Port of ``photon_ml_tpu/ops/normalization.py:44-162``
(``NormalizationType`` and ``NormalizationContext`` with ``identity`` and
``build``, which takes a ``stat/summary.py`` summary). Training data is
never transformed; margins use effective coefficients and the gradient is
rebuilt from raw-feature sums:

    w_eff        = w * factors
    margin_shift = -(w_eff . shifts)
    grad_j       = factors_j * (sum_i w_i l'_i x_ij - shifts_j sum_i w_i l'_i)

Coefficients may carry a leading lane axis (``[L, D]``, one row per
entity); every operation acts on the last axis.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device

Tensor = torch.Tensor


class NormalizationType(enum.Enum):
    """Mirror of normalization/NormalizationType.java."""

    NONE = "NONE"
    SCALE_WITH_STANDARD_DEVIATION = "SCALE_WITH_STANDARD_DEVIATION"
    SCALE_WITH_MAX_MAGNITUDE = "SCALE_WITH_MAX_MAGNITUDE"
    STANDARDIZATION = "STANDARDIZATION"


def _safe_inv(x) -> np.ndarray:
    """1/x where x > 0, else 1 (no scaling of a constant feature)."""
    x = np.asarray(x, dtype=np.float64)
    return np.where(x > 0.0, 1.0 / np.maximum(x, 1e-300), 1.0)


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """Optional per-feature ``factors``/``shifts`` (``[D]`` tensors or
    ``None`` for the identity); ``intercept_index`` is never shifted and
    keeps factor 1 (``normalization.py:54-69``)."""

    factors: Optional[Tensor] = None
    shifts: Optional[Tensor] = None
    intercept_index: Optional[int] = None

    @staticmethod
    def identity() -> "NormalizationContext":
        return NormalizationContext()

    @staticmethod
    def build(norm_type: NormalizationType, summary,
              intercept_index: Optional[int] = None,
              device=DEFAULT_DEVICE) -> "NormalizationContext":
        """From a feature summary (``mean``, ``variance``, ``max_magnitude``)
        (``normalization.py:74-127``): 1/std, 1/max|x|, or 1/std with the
        mean as shift for STANDARDIZATION; a zero std or magnitude keeps
        factor 1, and the intercept keeps factor 1 and no shift. The
        factors are f32 on ``device``."""
        if norm_type == NormalizationType.NONE:
            return NormalizationContext(intercept_index=intercept_index)
        shifts = None
        if norm_type == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
            factors = _safe_inv(np.sqrt(np.asarray(summary.variance)))
        elif norm_type == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
            factors = _safe_inv(np.asarray(summary.max_magnitude))
        elif norm_type == NormalizationType.STANDARDIZATION:
            factors = _safe_inv(np.sqrt(np.asarray(summary.variance)))
            shifts = np.asarray(summary.mean, dtype=np.float64).copy()
        else:
            raise ValueError(f"unsupported normalization type {norm_type}")
        if intercept_index is not None:
            factors[intercept_index] = 1.0
            if shifts is not None:
                shifts[intercept_index] = 0.0
        device = resolve_device(device)

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        return NormalizationContext(
            factors=f32(factors),
            shifts=None if shifts is None else f32(shifts),
            intercept_index=intercept_index)

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

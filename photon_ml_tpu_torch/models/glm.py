"""Generalized linear model: coefficients + the task's mean function.

Port of ``photon_ml_tpu/models/glm.py:38-132`` (``Coefficients`` with
``summary`` and ``zeros``, ``GeneralizedLinearModel`` with
``predict_class``, ``validate_coefficients``, ``with_coefficients`` and
``zeros``, ``score_batch``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device

from photon_ml_tpu_torch.ops.losses import sigmoid
from photon_ml_tpu_torch.optimize.config import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Coefficients:
    """Coefficient means + optional variance estimates."""

    means: Tensor
    variances: Optional[Tensor] = None

    @property
    def dim(self) -> int:
        return self.means.shape[-1]

    def score(self, features: Tensor) -> Tensor:
        """x . w for a [N, D] (or [D]) feature tensor."""
        return features @ self.means

    def summary(self) -> str:
        m = self.means.detach().cpu().numpy()
        lines = [f"coefficients: dim={m.shape[-1]} "
                 f"l2norm={np.linalg.norm(m):.6g} "
                 f"nnz={int(np.sum(m != 0))}"]
        if self.variances is not None:
            v = self.variances.detach().cpu().numpy()
            lines.append(f"variances: mean={v.mean():.6g} max={v.max():.6g}")
        return "\n".join(lines)

    @staticmethod
    def zeros(dim: int, dtype=torch.float32,
              device=DEFAULT_DEVICE) -> "Coefficients":
        return Coefficients(means=torch.zeros(
            dim, dtype=dtype, device=resolve_device(device)))


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    """A GLM: coefficients + task-determined mean function."""

    coefficients: Coefficients
    task: TaskType

    def compute_score(self, features: Tensor, offsets=0.0) -> Tensor:
        return self.coefficients.score(features) + offsets

    def mean(self, margins: Tensor) -> Tensor:
        if self.task == TaskType.LOGISTIC_REGRESSION:
            return sigmoid(margins)
        if self.task == TaskType.POISSON_REGRESSION:
            return torch.exp(margins)
        return margins

    def predict(self, features: Tensor, offsets=0.0) -> Tensor:
        return self.mean(self.compute_score(features, offsets))

    def predict_class(self, features: Tensor, threshold: float = 0.5,
                      offsets=0.0) -> Tensor:
        """0/1 classes (the BinaryClassifier trait): the mean against
        ``threshold`` for logistic regression, the margin against 0 for
        the smoothed-hinge SVM."""
        if self.task not in (TaskType.LOGISTIC_REGRESSION,
                             TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
            raise ValueError(f"{self.task} is not a classifier")
        if self.task == TaskType.LOGISTIC_REGRESSION:
            return (self.predict(features, offsets)
                    >= threshold).to(torch.int32)
        return (self.compute_score(features, offsets) >= 0.0).to(torch.int32)

    def validate_coefficients(self) -> bool:
        """No NaN/Inf among the means (one host read)."""
        return bool(torch.isfinite(self.coefficients.means).all())

    def with_coefficients(self, coefficients: Coefficients
                          ) -> "GeneralizedLinearModel":
        return dataclasses.replace(self, coefficients=coefficients)

    @staticmethod
    def zeros(dim: int, task: TaskType, dtype=torch.float32,
              device=DEFAULT_DEVICE) -> "GeneralizedLinearModel":
        return GeneralizedLinearModel(
            Coefficients.zeros(dim, dtype, device), task)


def score_batch(model: GeneralizedLinearModel, batch) -> Tensor:
    """Margins of a whole batch including its stored offsets."""
    w = model.coefficients.means
    return batch.margins(w, torch.zeros((), dtype=w.dtype, device=w.device))

"""Generalized linear model: coefficients + the task's mean function.

Port of ``photon_ml_tpu/models/glm.py:38-132`` (``Coefficients``,
``GeneralizedLinearModel``, ``score_batch``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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


def score_batch(model: GeneralizedLinearModel, batch) -> Tensor:
    """Margins of a whole batch including its stored offsets."""
    w = model.coefficients.means
    return batch.margins(w, torch.zeros((), dtype=w.dtype, device=w.device))

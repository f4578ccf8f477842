"""Single-GLM training over a regularization-weight grid with warm starts.

Port of ``photon_ml_tpu/training.py`` (``TrainedModel`` and
``train_glm_grid``; reference ModelTraining.scala:103-215): the weights
are sorted descending and each fit starts from the previous weight's
optimum in the problem's normalized coefficient space; a start given in
``initial_by_weight`` for a weight takes precedence over that warm start.
Every fit runs on the batch's device through
``GLMOptimizationProblem.run``, so above the kernel's gate each objective
evaluation is one launch of the fused kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import torch

from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.optimize.common import (
    BoxConstraints,
    OptimizationResult,
)
from photon_ml_tpu_torch.optimize.config import (
    GLMOptimizationConfiguration,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
    TaskType,
)
from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainedModel:
    regularization_weight: float
    model: GeneralizedLinearModel  # raw feature space
    result: OptimizationResult  # trajectory and convergence reason


def train_glm_grid(
    batch,
    task: TaskType,
    regularization_weights: Sequence[float],
    optimizer_type: OptimizerType = OptimizerType.LBFGS,
    regularization_context: RegularizationContext = RegularizationContext(
        RegularizationType.L2),
    max_iterations: int = 80,
    tolerance: float = 1e-6,
    normalization: NormalizationContext = NormalizationContext(),
    box: Optional[BoxConstraints] = None,
    compute_variances: bool = False,
    warm_start: bool = True,
    l1_mask: Optional[Tensor] = None,
    initial_by_weight: Optional[Mapping[float, object]] = None,
    track_iterates: bool = False,
) -> list[TrainedModel]:
    """One GLM per regularization weight, in descending order of weight,
    each warm-started from the last; returns them in that order."""
    weights = sorted({float(w) for w in regularization_weights},
                     reverse=True)
    if not weights:
        raise ValueError("at least one regularization weight is required")
    out: list[TrainedModel] = []
    init = None
    for lam in weights:
        problem = GLMOptimizationProblem(
            config=GLMOptimizationConfiguration(
                max_iterations=max_iterations, tolerance=tolerance,
                regularization_weight=lam, optimizer_type=optimizer_type,
                regularization_context=regularization_context),
            task=task, normalization=normalization, box=box,
            compute_variances=compute_variances, l1_mask=l1_mask,
            track_iterates=track_iterates)
        start = init
        if initial_by_weight is not None and lam in initial_by_weight:
            start = torch.as_tensor(initial_by_weight[lam],
                                    device=batch.X.device)
        model, result = problem.run(batch, initial=start)
        out.append(TrainedModel(lam, model, result))
        if warm_start:
            init = result.coefficients
    return out

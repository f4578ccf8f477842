"""Full-model metric maps for a regularization grid, and the best weight.

Port of ``photon_ml_tpu/evaluation/model_evaluation.py:44-163``
(``_metric_names``, ``evaluate_model_grid``, ``evaluate_model``,
``select_best_model``; reference Evaluation.scala:32-152 and
ModelSelection.scala). The margins of the whole grid are one
``[L, D] x [D, N]`` ``torch.matmul`` plus the batch's offsets (a plain
product, which the JAX package leaves to XLA as well); every metric of
``evaluation/metrics.py`` then runs per model on the device, in
``_metric_names`` order, and the ``[num_metrics, L]`` result comes back in
one host fetch. The metrics take the margins, labels and weights in f64,
as ``evaluation/evaluators.py`` does: the AUC's segment sums are atomic
adds in no fixed order on the card, and in f32 their rounding moved a
262,144-row AUC by 4e-5 from one evaluation of the same model to the next
on an H100 (``chip_smoke.py`` phase 11 (a)).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from photon_ml_tpu_torch.evaluation import metrics
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.optimize.config import TaskType

# Metric name constants (Evaluation.scala:32-39).
MEAN_ABSOLUTE_ERROR = "MEAN_ABSOLUTE_ERROR"
MEAN_SQUARED_ERROR = "MEAN_SQUARED_ERROR"
ROOT_MEAN_SQUARED_ERROR = "ROOT_MEAN_SQUARED_ERROR"
AREA_UNDER_PRECISION_RECALL = "AREA_UNDER_PRECISION_RECALL"
AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS = (
    "AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS")
PEAK_F1_SCORE = "PEAK_F1_SCORE"
DATA_LOG_LIKELIHOOD = "DATA_LOG_LIKELIHOOD"
AKAIKE_INFORMATION_CRITERION = "AKAIKE_INFORMATION_CRITERION"

_LOG_LIKELIHOOD = {
    TaskType.LOGISTIC_REGRESSION: metrics.logistic_log_likelihood,
    TaskType.POISSON_REGRESSION: metrics.poisson_log_likelihood,
    TaskType.LINEAR_REGRESSION: metrics.linear_log_likelihood,
}


def _metric_names(task: TaskType) -> list[str]:
    """The task's metrics in their fixed order (Evaluation.scala:100-152)."""
    names = [MEAN_ABSOLUTE_ERROR, MEAN_SQUARED_ERROR, ROOT_MEAN_SQUARED_ERROR]
    if task == TaskType.LOGISTIC_REGRESSION:
        names += [AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS,
                  AREA_UNDER_PRECISION_RECALL, PEAK_F1_SCORE]
    elif task == TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
        names += [AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS,
                  "SMOOTHED_HINGE_LOSS"]
    if task in _LOG_LIKELIHOOD:
        names += [DATA_LOG_LIKELIHOOD, AKAIKE_INFORMATION_CRITERION]
    return names


def _model_metrics(task: TaskType, labels, z, weights, k: int) -> list:
    """One model's metric tensors in ``_metric_names(task)`` order, in
    f64."""
    f64 = torch.float64
    labels, z, weights = labels.to(f64), z.to(f64), weights.to(f64)
    if task == TaskType.LOGISTIC_REGRESSION:
        p = torch.sigmoid(z)
    elif task == TaskType.POISSON_REGRESSION:
        p = torch.exp(z)
    else:
        p = z
    row = [metrics.mean_absolute_error(labels, p, weights),
           metrics.mean_squared_error(labels, p, weights),
           metrics.root_mean_squared_error(labels, p, weights)]
    if task == TaskType.LOGISTIC_REGRESSION:
        row += [metrics.area_under_roc_curve(labels, z, weights),
                metrics.area_under_pr_curve(labels, z, weights),
                metrics.peak_f1(labels, z, weights)]
    elif task == TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
        row += [metrics.area_under_roc_curve(labels, z, weights),
                metrics.mean_loss(get_loss("smoothed_hinge"), labels, z,
                                  weights)]
    ll_fn = _LOG_LIKELIHOOD.get(task)
    if ll_fn is not None:
        mean_ll = ll_fn(labels, z, weights)
        row += [mean_ll, metrics.akaike_information_criterion(
            mean_ll * weights.sum(), k)]
    return row


def evaluate_model_grid(models: Sequence[GeneralizedLinearModel],
                        batch) -> list[dict[str, float]]:
    """Metric maps of a whole grid of models of one task and width on a
    dense batch: one product for the margins, one host fetch."""
    if not models:
        return []
    task = models[0].task
    if any(m.task != task for m in models):
        raise ValueError("evaluate_model_grid requires a homogeneous task")
    dim = models[0].coefficients.means.shape
    for i, m in enumerate(models):
        if m.coefficients.means.shape != dim:
            raise ValueError(
                f"evaluate_model_grid requires homogeneous coefficient "
                f"dimensions: model 0 has shape {tuple(dim)} but model {i} "
                f"has {tuple(m.coefficients.means.shape)}")
    X = batch.X.to(batch.acc_dtype)
    W = torch.stack([m.coefficients.means.to(device=X.device, dtype=X.dtype)
                     for m in models])
    margins = torch.matmul(W, X.T) + batch.offsets  # [L, N]
    packed = torch.stack([
        torch.stack(_model_metrics(task, batch.labels, z, batch.weights,
                                   W.shape[1]))
        for z in margins], dim=1).cpu().numpy()
    names = _metric_names(task)
    return [{name: float(packed[j, i]) for j, name in enumerate(names)}
            for i in range(len(models))]


def evaluate_model(model: GeneralizedLinearModel, batch) -> dict[str, float]:
    """One model's metric map (the one-model grid)."""
    return evaluate_model_grid([model], batch)[0]


def select_best_model(
    per_lambda_metrics: Mapping[float, Mapping[str, float]],
    task: TaskType,
) -> float:
    """The winning weight (ModelSelection.scala): the largest AUC for the
    classifiers, the least RMSE for linear regression, the largest
    log-likelihood for Poisson."""
    if not per_lambda_metrics:
        raise ValueError("no models to select from")
    if task in (TaskType.LOGISTIC_REGRESSION,
                TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
        key, best = AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS, max
    elif task == TaskType.LINEAR_REGRESSION:
        key, best = ROOT_MEAN_SQUARED_ERROR, min
    else:
        key, best = DATA_LOG_LIKELIHOOD, max
    return best(per_lambda_metrics,
                key=lambda lam: per_lambda_metrics[lam][key])

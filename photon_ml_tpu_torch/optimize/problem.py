"""GLM optimization problem: objective x L-BFGS x L2 regularization.

Port of ``photon_ml_tpu/optimize/problem.py:71-298``: ``objective``,
``solve``/``run``/``run_lazy`` (the L-BFGS branch), ``publish`` and
``regularization_value(_device)``, and the ``optimizer.gradient`` fault
point on the solver output (``:228``, ``:272``), where a ``nan`` drill
stands for a diverged solve. OWL-QN (L1), TRON, box constraints,
variances and the sharded backend wait for later slices and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops.aggregators import GLMObjective
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.optimize.common import (
    DeferredOptimizationResult,
    OptimizationResult,
    RunHistory,
    solver_x0,
)
from photon_ml_tpu_torch.optimize.config import (
    GLMOptimizationConfiguration,
    OptimizerType,
    TASK_LOSS_NAME,
    TaskType,
)
from photon_ml_tpu_torch.optimize.lbfgs import minimize_lbfgs
from photon_ml_tpu_torch.utils.faults import fault_point

Tensor = torch.Tensor


def _one_lane_vg(x: Tensor, payload) -> tuple[Tensor, Tensor]:
    """The single-lane objective as the lane-batched solver calls it."""
    obj, batch = payload
    f, g = obj.calculate(x[0], batch)
    return f.unsqueeze(0), g.unsqueeze(0)


@dataclasses.dataclass(frozen=True)
class GLMOptimizationProblem:
    """A ready-to-run GLM training problem for one coordinate."""

    config: GLMOptimizationConfiguration
    task: TaskType
    normalization: NormalizationContext = NormalizationContext()

    def __post_init__(self):
        cfg = self.config
        if cfg.optimizer_type != OptimizerType.LBFGS:
            raise NotImplementedError("only L-BFGS is ported so far")
        if cfg.regularization_context.l1_weight(
                cfg.regularization_weight) > 0.0:
            raise NotImplementedError("L1 (OWL-QN) is not ported yet")

    def objective(self) -> GLMObjective:
        cfg = self.config
        return GLMObjective(
            loss=get_loss(TASK_LOSS_NAME[self.task]),
            norm=self.normalization,
            l2_lambda=cfg.regularization_context.l2_weight(
                cfg.regularization_weight),
            has_hessian=self.task != TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)

    def solve(self, obj: GLMObjective, batch, x0: Tensor
              ) -> tuple[Tensor, RunHistory, Tensor]:
        """One-lane L-BFGS -> (x [D], RunHistory [1, ...], progressed [1])."""
        cfg = self.config
        x, history, progressed = minimize_lbfgs(
            _one_lane_vg, x0.unsqueeze(0), (obj, batch),
            max_iter=cfg.max_iterations, tolerance=cfg.tolerance)
        return x[0], history, progressed

    def publish(self, x: Tensor, history: RunHistory, progressed: Tensor
                ) -> tuple[GeneralizedLinearModel, OptimizationResult]:
        """Solver output -> (raw-space model, result record)."""
        cfg = self.config
        result = OptimizationResult.from_history(
            x, history, cfg.max_iterations, cfg.tolerance,
            bool(progressed[0]))
        means = self.normalization.transform_model_coefficients(x)
        return GeneralizedLinearModel(Coefficients(means=means),
                                      self.task), result

    def _x0(self, batch, initial: Optional[Tensor]) -> Tensor:
        return solver_x0(batch.acc_dtype, batch.num_features, initial,
                         batch.X.device)

    def run(self, batch, initial: Optional[Tensor] = None
            ) -> tuple[GeneralizedLinearModel, OptimizationResult]:
        """Train on a batch; returns (model in RAW feature space, result)."""
        x, history, progressed = self.solve(self.objective(), batch,
                                            self._x0(batch, initial))
        x = fault_point("optimizer.gradient", arrays=x)
        return self.publish(x, history, progressed)

    def run_lazy(self, batch, initial: Optional[Tensor] = None
                 ) -> DeferredOptimizationResult:
        """Like :meth:`run` but the history stays on the device until read
        (``problem.py:239-275``)."""
        x, history, progressed = self.solve(self.objective(), batch,
                                            self._x0(batch, initial))
        x = fault_point("optimizer.gradient", arrays=x)
        cfg = self.config
        return DeferredOptimizationResult(x, history, progressed,
                                          cfg.max_iterations, cfg.tolerance)

    def regularization_value_device(self, coef_normalized: Tensor):
        """lambda-weighted L2 penalty as a device scalar; Python ``0.0``
        when the config has none."""
        cfg = self.config
        l2 = cfg.regularization_context.l2_weight(cfg.regularization_weight)
        if l2 > 0:
            return 0.5 * l2 * (coef_normalized * coef_normalized).sum()
        return 0.0

    def regularization_value(self, coef_normalized: Tensor) -> float:
        val = self.regularization_value_device(coef_normalized)
        return val if isinstance(val, float) else float(val)

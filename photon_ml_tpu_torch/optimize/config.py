"""Optimization configuration: types, regularization context, string formats.

PyTorch-port copy of ``photon_ml_tpu/optimize/config.py:25-159`` (that
module is framework-free; the port keeps its own copy so it imports nothing
of the JAX package). Mirrors the reference's configuration surface:

- ``OptimizerType`` / ``RegularizationType`` enums
- ``RegularizationContext`` with the elastic-net split lambda1 = alpha*lambda
  (L1 side, handled by OWL-QN) and lambda2 = (1-alpha)*lambda (L2 mixin)
  (reference: photon-ml/src/main/scala/com/linkedin/photon/ml/optimization/
  RegularizationContext.scala:35-90)
- ``GLMOptimizationConfiguration`` parsed from the GAME CLI string format
  ``maxIter,tolerance,lambda,downSamplingRate,OPTIMIZER,REG_TYPE``
  (GLMOptimizationConfiguration.scala:41-87)
- the optimizer-selection rules of ``OptimizerFactory``
  (OptimizerFactory.scala:40-85): LBFGS + {L1, ELASTIC_NET} -> OWL-QN;
  LBFGS + {L2, NONE} -> plain L-BFGS; TRON + {L2, NONE} -> TRON;
  TRON + L1/ELASTIC_NET -> error.
"""

from __future__ import annotations

import dataclasses
import enum


class OptimizerType(enum.Enum):
    LBFGS = "LBFGS"
    TRON = "TRON"


class RegularizationType(enum.Enum):
    NONE = "NONE"
    L1 = "L1"
    L2 = "L2"
    ELASTIC_NET = "ELASTIC_NET"


class TaskType(enum.Enum):
    """Training task types (reference TaskType.scala)."""

    LOGISTIC_REGRESSION = "LOGISTIC_REGRESSION"
    LINEAR_REGRESSION = "LINEAR_REGRESSION"
    POISSON_REGRESSION = "POISSON_REGRESSION"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "SMOOTHED_HINGE_LOSS_LINEAR_SVM"


TASK_LOSS_NAME = {
    TaskType.LOGISTIC_REGRESSION: "logistic",
    TaskType.LINEAR_REGRESSION: "squared",
    TaskType.POISSON_REGRESSION: "poisson",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: "smoothed_hinge",
}


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    """Regularization type + elastic-net alpha split."""

    reg_type: RegularizationType = RegularizationType.NONE
    alpha: float = 0.5  # elastic-net mixing weight (reference default 0.5)

    def __post_init__(self):
        if not 0.0 <= self.alpha <= 1.0:
            raise ValueError(f"elastic net alpha must be in [0,1]: {self.alpha}")

    def l1_weight(self, reg_weight: float) -> float:
        if self.reg_type == RegularizationType.L1:
            return reg_weight
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return self.alpha * reg_weight
        return 0.0

    def l2_weight(self, reg_weight: float) -> float:
        if self.reg_type == RegularizationType.L2:
            return reg_weight
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return (1.0 - self.alpha) * reg_weight
        return 0.0


@dataclasses.dataclass(frozen=True)
class GLMOptimizationConfiguration:
    """Per-coordinate optimization knobs (GAME CLI string format).

    Format: ``maxIter,tolerance,lambda,downSamplingRate,OPTIMIZER,REG_TYPE``
    e.g. ``50,1e-9,10.0,0.3,LBFGS,L2``
    (GLMOptimizationConfiguration.parseAndBuildFromString :60-87).
    """

    max_iterations: int = 20
    tolerance: float = 1e-5
    regularization_weight: float = 0.0
    down_sampling_rate: float = 1.0
    optimizer_type: OptimizerType = OptimizerType.LBFGS
    regularization_context: RegularizationContext = RegularizationContext()

    def __post_init__(self):
        if self.max_iterations <= 0:
            raise ValueError(f"maxIterations must be positive: {self.max_iterations}")
        if self.tolerance <= 0:
            raise ValueError(f"tolerance must be positive: {self.tolerance}")
        if self.regularization_weight < 0:
            raise ValueError(
                f"regularization weight must be >= 0: {self.regularization_weight}")
        if not 0.0 < self.down_sampling_rate <= 1.0:
            raise ValueError(
                f"downSamplingRate must be in (0,1]: {self.down_sampling_rate}")
        # OptimizerFactory.scala:78-79: TRON has no L1 path.
        if (self.optimizer_type == OptimizerType.TRON
                and self.regularization_context.reg_type
                in (RegularizationType.L1, RegularizationType.ELASTIC_NET)):
            raise ValueError("TRON does not support L1/ELASTIC_NET regularization")

    @staticmethod
    def parse(s: str) -> "GLMOptimizationConfiguration":
        parts = [p.strip() for p in s.split(",")]
        if len(parts) != 6:
            raise ValueError(
                "expected 'maxIter,tol,lambda,downSamplingRate,OPTIMIZER,REG',"
                f" got {s!r}")
        max_iter, tol, lam, rate, opt, reg = parts
        return GLMOptimizationConfiguration(
            max_iterations=int(max_iter),
            tolerance=float(tol),
            regularization_weight=float(lam),
            down_sampling_rate=float(rate),
            optimizer_type=OptimizerType(opt.upper()),
            regularization_context=RegularizationContext(
                RegularizationType(reg.upper())),
        )

    def render(self) -> str:
        return (f"{self.max_iterations},{self.tolerance},"
                f"{self.regularization_weight},{self.down_sampling_rate},"
                f"{self.optimizer_type.value},"
                f"{self.regularization_context.reg_type.value}")

    def with_regularization_weight(self, w: float) -> "GLMOptimizationConfiguration":
        return dataclasses.replace(self, regularization_weight=w)


@dataclasses.dataclass(frozen=True)
class MFOptimizationConfiguration:
    """Matrix-factorization config for factored random effects
    (reference: optimization/game/MFOptimizationConfiguration.scala:20-42;
    string format ``maxNumberIterations,numFactors``)."""

    max_number_iterations: int
    num_factors: int

    @staticmethod
    def parse(s: str) -> "MFOptimizationConfiguration":
        parts = [p.strip() for p in s.split(",")]
        if len(parts) != 2:
            raise ValueError(
                f"expected 'maxNumberIterations,numFactors', got {s!r}")
        return MFOptimizationConfiguration(int(parts[0]), int(parts[1]))

    def render(self) -> str:
        return f"{self.max_number_iterations},{self.num_factors}"

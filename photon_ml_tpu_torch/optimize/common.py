"""Shared optimizer structures: convergence reasons, run history, results.

Port of ``photon_ml_tpu/optimize/common.py:29-119`` and ``:348-403``. The
JAX solvers are single-lane ``lax.while_loop`` programs that the random
effect ``vmap``s; the port's solvers are lane-batched by construction, so
every per-iteration quantity here carries a leading lane axis ``[L]``
(the fixed effect is the one-lane case).

Convergence reasons mirror Optimizer.scala:156-170:

- MaxIterations:            iter >= max_iter
- ObjectiveNotImproving:    the last iteration failed to produce a new state
- FunctionValuesConverged:  |f_k - f_{k-1}| <= tol * |f_0|
- GradientConverged:        ||g_k||_2 <= tol * ||g_0||_2
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor

#: Blocking device->host reads taken inside the solvers (loop-exit tests):
#: one per L-BFGS iteration and one per line-search step. The coordinate
#: descent epilogue counts its own fetches separately.
SOLVER_SYNCS = {"count": 0}


def reset_solver_syncs() -> None:
    SOLVER_SYNCS["count"] = 0


def host_flags(*flags: Tensor) -> list[bool]:
    """Fetch several device booleans in ONE blocking read (counted)."""
    SOLVER_SYNCS["count"] += 1
    return [bool(v) for v in torch.stack(list(flags)).tolist()]


class ConvergenceReason(enum.Enum):
    MAX_ITERATIONS = "MaxIterations"
    OBJECTIVE_NOT_IMPROVING = "ObjectiveNotImproving"
    FUNCTION_VALUES_CONVERGED = "FunctionValuesConverged"
    GRADIENT_CONVERGED = "GradientConverged"


def solver_x0(acc_dtype: torch.dtype, shape, initial: Optional[Tensor],
              device) -> Tensor:
    """Initial solver state: at least ``acc_dtype``; a warm start can only
    upcast (``common.py:59-68``)."""
    if initial is None:
        return torch.zeros(shape, dtype=acc_dtype, device=device)
    initial = torch.as_tensor(initial, device=device)
    return initial.to(torch.promote_types(acc_dtype, initial.dtype))


def finite_step(accepted: Tensor, f: Tensor, g: Tensor) -> Tensor:
    """Per-lane accept flag & a non-finite guard (``common.py:71-90``): a
    NaN/Inf objective or gradient never enters the accepted state."""
    return accepted & torch.isfinite(f) & torch.isfinite(g).all(-1)


class RunHistory(NamedTuple):
    """Per-lane trajectory: ``values[l, k]``/``grad_norms[l, k]`` hold f
    and ||g|| after iteration k (k=0 is the start); later slots are NaN."""

    values: Tensor  # [L, max_iter + 1]
    grad_norms: Tensor  # [L, max_iter + 1]
    num_iterations: Tensor  # [L] int64: last completed iteration index


@dataclasses.dataclass(frozen=True)
class OptimizationResult:
    """Host-side summary of one single-lane solver run."""

    coefficients: Tensor
    value: float
    grad_norm: float
    iterations: int
    convergence_reason: ConvergenceReason
    values: np.ndarray
    grad_norms: np.ndarray

    @staticmethod
    def from_history(coefficients: Tensor, history: RunHistory,
                     max_iter: int, tolerance: float,
                     made_progress_last_iter: bool = True
                     ) -> "OptimizationResult":
        """Summary of lane 0 (the single lane of a fixed-effect solve)."""
        k = int(history.num_iterations[0])
        values = history.values[0].cpu().numpy()[: k + 1]
        grad_norms = history.grad_norms[0].cpu().numpy()[: k + 1]
        reason = _convergence_reason(k, values, grad_norms, max_iter,
                                     tolerance, made_progress_last_iter)
        return OptimizationResult(
            coefficients=coefficients, value=float(values[-1]),
            grad_norm=float(grad_norms[-1]), iterations=k,
            convergence_reason=reason, values=values, grad_norms=grad_norms)


class DeferredOptimizationResult:
    """:class:`OptimizationResult` whose history stays on the device until
    a scalar field is first read (``common.py:158-221``): the coordinate
    update hands its coefficients on without a blocking read."""

    def __init__(self, coefficients: Tensor, history: RunHistory,
                 progressed: Tensor, max_iter: int, tolerance: float):
        self.coefficients = coefficients
        self._history = history
        self._progressed = progressed
        self._max_iter = max_iter
        self._tolerance = tolerance
        self._result: Optional[OptimizationResult] = None

    def _force(self) -> OptimizationResult:
        if self._result is None:
            self._result = OptimizationResult.from_history(
                self.coefficients, self._history, self._max_iter,
                self._tolerance, bool(self._progressed[0]))
            self._history = self._progressed = None
        return self._result

    @property
    def value(self) -> float:
        return self._force().value

    @property
    def grad_norm(self) -> float:
        return self._force().grad_norm

    @property
    def iterations(self) -> int:
        return self._force().iterations

    @property
    def convergence_reason(self) -> ConvergenceReason:
        return self._force().convergence_reason

    @property
    def values(self) -> np.ndarray:
        return self._force().values

    @property
    def grad_norms(self) -> np.ndarray:
        return self._force().grad_norms


def _convergence_reason(k: int, values: np.ndarray, grad_norms: np.ndarray,
                        max_iter: int, tolerance: float,
                        made_progress_last_iter: bool) -> ConvergenceReason:
    """Port of Optimizer.getConvergenceReason (``common.py:348-367``)."""
    if k >= max_iter:
        return ConvergenceReason.MAX_ITERATIONS
    if not made_progress_last_iter:
        return ConvergenceReason.OBJECTIVE_NOT_IMPROVING
    if k >= 1 and abs(values[-1] - values[-2]) <= tolerance * abs(values[0]):
        return ConvergenceReason.FUNCTION_VALUES_CONVERGED
    if grad_norms[-1] <= tolerance * grad_norms[0]:
        return ConvergenceReason.GRADIENT_CONVERGED
    return ConvergenceReason.FUNCTION_VALUES_CONVERGED


def should_continue(it: Tensor, value: Tensor, prev_value: Tensor,
                    grad_norm: Tensor, init_value: Tensor,
                    init_grad_norm: Tensor, max_iter: int, tolerance: float,
                    made_progress: Tensor) -> Tensor:
    """Per-lane loop predicate (``common.py:370-403``, unresumed solves):
    iteration 0 runs unless the start is stationary."""
    not_done = ((it < max_iter) & made_progress
                & ((value - prev_value).abs() > tolerance * init_value.abs())
                & (grad_norm > tolerance * init_grad_norm))
    return ((it == 0) & made_progress & (init_grad_norm > 0.0)) | not_done

"""Shared optimizer structures: convergence reasons, box constraints, run
history, results.

Port of ``photon_ml_tpu/optimize/common.py:29-119`` (``BoxConstraints``
and ``project_box`` included), ``:225-345``
(``LaneCompactionState``, ``padded_lane_count``) and ``:348-403``. The
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


class BoxConstraints(NamedTuple):
    """Elementwise ``[lower, upper]`` bounds, +-inf for a free coordinate
    (``common.py:36-56``; OptimizationUtils.projectCoefficientsToHypercube).
    The bounds are ``[D]`` and broadcast over the lanes of an ``[L, D]``
    solve; they are kept in f64 and cast to the iterate's dtype when
    applied."""

    lower: Tensor
    upper: Tensor

    @staticmethod
    def from_map(dim: int,
                 constraint_map: Optional[dict[int, tuple[float, float]]],
                 device="cpu") -> Optional["BoxConstraints"]:
        """Bounds from ``{index: (lower, upper)}``; None for no map."""
        if not constraint_map:
            return None
        lower = np.full(dim, -np.inf)
        upper = np.full(dim, np.inf)
        for idx, (lo, hi) in constraint_map.items():
            lower[idx], upper[idx] = lo, hi
        return BoxConstraints(torch.as_tensor(lower, device=device),
                              torch.as_tensor(upper, device=device))


def project_box(x: Tensor, box: Optional[BoxConstraints]) -> Tensor:
    """``x`` clipped into the box (``common.py:93-96``); ``x`` itself
    without one."""
    if box is None:
        return x
    return torch.clamp(x, box.lower.to(device=x.device, dtype=x.dtype),
                       box.upper.to(device=x.device, dtype=x.dtype))


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
    # [L, max_iter + 1, D] with ``track_iterates``: row k the accepted
    # iterate after iteration k (row 0 the start), later rows zero;
    # None otherwise
    iterates: Optional[Tensor] = None


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
    iterates: Optional[np.ndarray] = None  # [k + 1, D] when tracked

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
        iterates = (None if history.iterates is None
                    else history.iterates[0, : k + 1].cpu().numpy())
        return OptimizationResult(
            coefficients=coefficients, value=float(values[-1]),
            grad_norm=float(grad_norms[-1]), iterations=k,
            convergence_reason=reason, values=values, grad_norms=grad_norms,
            iterates=iterates)


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

    @property
    def iterates(self) -> Optional[np.ndarray]:
        return self._force().iterates


@dataclasses.dataclass
class LaneCompactionState:
    """Results of a solve run in iteration chunks over a shrinking set of
    lanes (``common.py:225-296,332-333``): after each chunk the lanes that
    converged keep their results here and only the still-active ones are
    gathered and re-dispatched, resumed from their solver carry. The
    buffers stay on the device."""

    coefs: Tensor  # [E, D]
    iterations: Tensor  # [E], summed across chunks
    values: Tensor  # [E], the last chunk's final value
    codes: Tensor  # [E] int8, the last chunk's convergence code

    @staticmethod
    def initial(x0: Tensor, value_dtype: torch.dtype
                ) -> "LaneCompactionState":
        e, dev = int(x0.shape[0]), x0.device
        return LaneCompactionState(
            coefs=x0,
            iterations=torch.zeros(e, dtype=torch.int64, device=dev),
            values=torch.zeros(e, dtype=value_dtype, device=dev),
            codes=torch.zeros(e, dtype=torch.int8, device=dev))

    def absorb(self, idx: Optional[np.ndarray], c: Tensor, it: Tensor,
               v: Tensor, k: Tensor, max_iterations_code: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """Fold one chunk's output into the buffers (``idx`` maps the
        chunk's lanes to global ids; None for the first chunk, which ran
        every lane in order). Returns the global ids and the chunk-local
        positions of the lanes that spent the chunk's budget without
        converging. The mask of those lanes is the chunk's one blocking
        read (counted in ``SOLVER_SYNCS``)."""
        if idx is None:
            self.coefs, self.iterations, self.values, self.codes = \
                c, it, v, k
            idx = np.arange(len(k))
        else:
            # the chunk's lanes past ``len(idx)`` are pad lanes
            n = len(idx)
            c, it, v, k = c[:n], it[:n], v[:n], k[:n]
            rows = torch.as_tensor(idx, device=c.device)
            self.coefs = self.coefs.index_copy(0, rows, c)
            iterations = self.iterations.clone()
            iterations[rows] += it
            self.iterations = iterations
            self.values = self.values.index_copy(0, rows, v)
            self.codes = self.codes.index_copy(0, rows, k)
        SOLVER_SYNCS["count"] += 1
        mask = (k == max_iterations_code).cpu().numpy()
        return idx[mask], np.nonzero(mask)[0]

    def results(self) -> tuple[Tensor, Tensor, Tensor, Tensor]:
        return self.coefs, self.iterations, self.values, self.codes


#: Least lanes x features of a re-dispatched chunk. Below it the
#: gradient's sum over an entity's rows (``data/batch.py``) reduces in
#: another order on the H100, so a lane would round differently than in
#: the dispatch of all lanes (``chip_smoke.py`` phase 9 (b),
#: ``lane_count_dependence``: every lane count with lanes x features
#: >= 128 matched, and only those).
MIN_LANE_ELEMENTS = 128


def padded_lane_count(n: int, lanes: int, features: int) -> int:
    """Lanes a re-dispatched chunk of ``n`` still-active lanes carries,
    out of a block of ``lanes`` lanes of ``features`` features: at least
    ``MIN_LANE_ELEMENTS / features``, and never more than the block. The
    JAX package pads to a power of two for its compile cache
    (``common.py:336-345``); the port pads for bit-exactness only. A pad
    lane copies a real lane, as in the JAX package."""
    return min(lanes, max(int(n), -(-MIN_LANE_ELEMENTS // features)))


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
                    made_progress: Tensor, resumed: bool = False) -> Tensor:
    """Per-lane loop predicate (``common.py:370-403``): iteration 0 of a
    fresh solve runs unless the start is stationary; a resumed chunk's
    first check is the one the uninterrupted loop would run there."""
    not_done = ((it < max_iter) & made_progress
                & ((value - prev_value).abs() > tolerance * init_value.abs())
                & (grad_norm > tolerance * init_grad_norm))
    if resumed:
        return not_done
    return ((it == 0) & made_progress & (init_grad_norm > 0.0)) | not_done

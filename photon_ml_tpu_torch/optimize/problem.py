"""GLM optimization problem: objective x optimizer x regularization.

Port of ``photon_ml_tpu/optimize/problem.py:71-298``: ``objective``,
``solve``/``run``/``run_lazy`` with the optimizer dispatch of
``:123-168`` (:func:`select_solver` and :func:`minimize`, which the
random effect shares: L-BFGS; L-BFGS with an L1 weight goes to OWL-QN
with ``l1 = full(D, l1)``, the elastic net's L2 part staying in the
smooth objective; TRON, refused for the smoothed hinge at construction),
``publish`` with the variance approximation var_j = 1 / (H_jj + 1e-12) on
``run`` only (``run_lazy`` computes none, as in the JAX code), and
``regularization_value(_device)`` with both penalties. The
``optimizer.gradient`` fault point sits on the solver output (``:228``,
``:272``), where a ``nan`` drill stands for a diverged solve. ``box``,
``l1_mask`` and ``track_iterates`` are the JAX problem's (``:71-95``):
the box and the iterates reach all three solvers, and the mask
multiplies OWL-QN's ``l1`` vector (an intercept spared from the L1
penalty).

``shard_weight_update`` and ``collective_quant`` are the JAX problem's
fields (``:91-118``). With a default mesh whose data axis is > 1,
``run`` and ``run_lazy`` route the solve through the shard runner
(``parallel/distributed.run_glm_shard_map``; ``:195-275``) under the span
``optimizer.solve`` with ``backend="shard_map"``, and ``run_lazy``
returns that eager result, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.obs import trace
from photon_ml_tpu_torch.ops.aggregators import GLMObjective
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.optimize.common import (
    BoxConstraints,
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
from photon_ml_tpu_torch.optimize.owlqn import minimize_owlqn
from photon_ml_tpu_torch.optimize.tron import minimize_tron
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, get_default_mesh
from photon_ml_tpu_torch.parallel.quantized_collectives import (
    check_quant_mode,
)
from photon_ml_tpu_torch.utils.faults import fault_point

Tensor = torch.Tensor

VARIANCE_EPSILON = 1e-12


def _one_lane_vg(x: Tensor, payload) -> tuple[Tensor, Tensor]:
    """The single-lane objective as the lane-batched solvers call it."""
    obj, batch = payload
    f, g = obj.calculate(x[0], batch)
    return f.unsqueeze(0), g.unsqueeze(0)


def _one_lane_hvp(x: Tensor, v: Tensor, payload) -> Tensor:
    obj, batch = payload
    return obj.hessian_vector(x[0], v[0], batch).unsqueeze(0)


@dataclasses.dataclass(frozen=True)
class GLMOptimizationProblem:
    """A ready-to-run GLM training problem for one coordinate."""

    config: GLMOptimizationConfiguration
    task: TaskType
    normalization: NormalizationContext = NormalizationContext()
    box: Optional[BoxConstraints] = None
    compute_variances: bool = False
    # multiplies OWL-QN's per-coordinate l1 (0 spares a coordinate)
    l1_mask: Optional[Tensor] = None
    # the accepted iterates in the result (--validate-per-iteration)
    track_iterates: bool = False
    # split the optimizer state and the coefficient update over the
    # mesh's data axis (arXiv 2004.13336); engages on the shard runner
    # with a data axis > 1, not with a box or track_iterates
    shard_weight_update: bool = False
    # wire format of the sharded solve's collectives ("none" | "int8")
    collective_quant: str = "none"

    def __post_init__(self):
        check_quant_mode(self.collective_quant)
        select_solver(self.config, self.task)

    def objective(self) -> GLMObjective:
        cfg = self.config
        return GLMObjective(
            loss=get_loss(TASK_LOSS_NAME[self.task]),
            norm=self.normalization,
            l2_lambda=cfg.regularization_context.l2_weight(
                cfg.regularization_weight),
            has_hessian=self.task != TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
            collective_quant=self.collective_quant)

    def solve(self, obj: GLMObjective, batch, x0: Tensor,
              update_axis_name: Optional[str] = None, vg_fn=None,
              hvp_fn=None, l1_mask: Optional[Tensor] = None
              ) -> tuple[Tensor, RunHistory, Tensor]:
        """One-lane solve, optimizer by the config -> (x [D], RunHistory
        [1, ...], progressed [1]).

        The sharded weight update (``parallel/distributed.py``) passes
        this shard's slice as ``x0``, lane-batched objective callables
        ``vg_fn(x [1, d], payload)`` / ``hvp_fn(x, v, payload)`` that
        gather and slice, the sliced ``l1_mask``, and ``update_axis_name``,
        over which the solver sums every d-vector reduction."""
        cfg = self.config
        mask = self.l1_mask if l1_mask is None else l1_mask
        l1 = torch.full_like(x0, cfg.regularization_context.l1_weight(
            cfg.regularization_weight))
        if mask is not None:
            l1 = l1 * mask.to(device=x0.device, dtype=x0.dtype)
        x, history, progressed = minimize(
            select_solver(cfg, self.task), vg_fn or _one_lane_vg,
            hvp_fn or _one_lane_hvp, x0.unsqueeze(0), (obj, batch), l1,
            cfg.max_iterations, cfg.tolerance, box=self.box,
            track_iterates=self.track_iterates,
            update_axis_name=update_axis_name,
            collective_quant=self.collective_quant)
        return x[0], history, progressed

    def publish(self, x: Tensor, history: RunHistory, progressed: Tensor,
                obj: Optional[GLMObjective] = None, batch=None,
                variances: Optional[Tensor] = None
                ) -> tuple[GeneralizedLinearModel, OptimizationResult]:
        """Solver output -> (raw-space model, result record), with the
        variances when the problem computes them and ``obj``/``batch``
        are given (or ``variances``, computed by a sharded solve)."""
        cfg = self.config
        result = OptimizationResult.from_history(
            x, history, cfg.max_iterations, cfg.tolerance,
            bool(progressed[0]))
        if variances is None and self.compute_variances \
                and obj is not None and batch is not None:
            variances = 1.0 / (obj.hessian_diagonal(x, batch)
                               + VARIANCE_EPSILON)
        means = self.normalization.transform_model_coefficients(x)
        return GeneralizedLinearModel(
            Coefficients(means=means, variances=variances),
            self.task), result

    def _x0(self, batch, initial: Optional[Tensor]) -> Tensor:
        return solver_x0(batch.acc_dtype, batch.num_features, initial,
                         batch.device)

    def run(self, batch, initial: Optional[Tensor] = None
            ) -> tuple[GeneralizedLinearModel, OptimizationResult]:
        """Train on a batch; returns (model in RAW feature space, result).
        With a default mesh whose data axis is > 1 the rows are split over
        it and every shard runs the solver on its own rows
        (``problem.py:195-237``)."""
        mesh = get_default_mesh()
        if mesh is not None and mesh.shape[DATA_AXIS] > 1:
            return self._run_sharded(batch, mesh, initial)
        obj = self.objective()
        x0 = self._x0(batch, initial)
        with trace.span("optimizer.solve", backend="local",
                        optimizer=self.config.optimizer_type.name):
            x, history, progressed = self.solve(obj, batch, x0)
        x = fault_point("optimizer.gradient", arrays=x)
        return self.publish(x, history, progressed, obj, batch)

    def run_lazy(self, batch, initial: Optional[Tensor] = None
                 ) -> DeferredOptimizationResult:
        """Like :meth:`run` but the history stays on the device until read
        (``problem.py:239-275``); the ``optimizer.solve`` span times the
        solve's host side (its loop-exit reads included), the deferred
        result's read is a separate site. On a mesh with a data axis > 1
        this is :meth:`run`'s sharded solve and its eager result."""
        mesh = get_default_mesh()
        if mesh is not None and mesh.shape[DATA_AXIS] > 1:
            return self._run_sharded(batch, mesh, initial)[1]
        obj, x0 = self.objective(), self._x0(batch, initial)
        with trace.span("optimizer.solve", backend="lazy",
                        optimizer=self.config.optimizer_type.name):
            x, history, progressed = self.solve(obj, batch, x0)
        x = fault_point("optimizer.gradient", arrays=x)
        cfg = self.config
        return DeferredOptimizationResult(x, history, progressed,
                                          cfg.max_iterations, cfg.tolerance)

    def _run_sharded(self, batch, mesh, initial: Optional[Tensor]
                     ) -> tuple[GeneralizedLinearModel, OptimizationResult]:
        from photon_ml_tpu_torch.parallel.distributed import (
            run_glm_shard_map,
        )

        with trace.span("optimizer.solve", backend="shard_map",
                        optimizer=self.config.optimizer_type.name):
            model, result = run_glm_shard_map(self, batch, mesh,
                                              initial=initial)
        poisoned = fault_point("optimizer.gradient",
                               arrays=result.coefficients)
        if poisoned is not result.coefficients:
            result = dataclasses.replace(result, coefficients=poisoned)
            model = GeneralizedLinearModel(
                Coefficients(means=self.normalization
                             .transform_model_coefficients(poisoned),
                             variances=model.coefficients.variances),
                self.task)
        return model, result

    def regularization_value_device(self, coef_normalized: Tensor):
        """lambda-weighted L1 + L2 penalty as a device scalar; Python
        ``0.0`` when the config has none."""
        return regularization_penalty(self.config, coef_normalized)

    def regularization_value(self, coef_normalized: Tensor) -> float:
        val = self.regularization_value_device(coef_normalized)
        # photonlint: allow-W101(this IS the host-scalar accessor: one guarded scalar sync per objective evaluation, annotated -> float)
        return val if isinstance(val, float) else float(val)


def select_solver(cfg: GLMOptimizationConfiguration, task: TaskType) -> str:
    """The configuration's solver (``problem.py:97-168``,
    ``random_effect.py:861-872``): "tron" for TRON, which the smoothed
    hinge has no Hessian for (``ValueError``); "owlqn" for L-BFGS with an
    L1 weight; else "lbfgs"."""
    if cfg.optimizer_type == OptimizerType.TRON:
        if task == TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
            raise ValueError("TRON requires a twice-differentiable loss; "
                             "smoothed hinge SVM supports LBFGS/OWLQN only")
        return "tron"
    if cfg.regularization_context.l1_weight(cfg.regularization_weight) > 0.0:
        return "owlqn"
    return "lbfgs"


def minimize(solver: str, value_and_grad_fn, hvp_fn, x0: Tensor, data,
             l1: Tensor, max_iter: int, tolerance: float, resume=None,
             return_carry: bool = False,
             box: Optional[BoxConstraints] = None,
             track_iterates: bool = False,
             update_axis_name: Optional[str] = None,
             collective_quant: str = "none"):
    """Run ``solver`` (a :func:`select_solver` name) on every lane of
    ``x0 [L, D]``: ``l1 [D]`` is OWL-QN's weight, ``hvp_fn`` TRON's
    Hessian-vector product, ``box`` and ``track_iterates`` every solver's.
    Returns ``(x, RunHistory, made_progress)``, and the solver's carry
    after them with ``return_carry``; ``resume`` continues from such a
    carry. ``update_axis_name`` and ``collective_quant`` are the sharded
    weight update's (``optimize/lbfgs.py``)."""
    common = dict(max_iter=max_iter, tolerance=tolerance, resume=resume,
                  return_carry=return_carry, box=box,
                  track_iterates=track_iterates,
                  update_axis_name=update_axis_name,
                  collective_quant=collective_quant)
    if solver == "tron":
        return minimize_tron(value_and_grad_fn, hvp_fn, x0, data, **common)
    if solver == "owlqn":
        return minimize_owlqn(value_and_grad_fn, x0, data, l1=l1, **common)
    return minimize_lbfgs(value_and_grad_fn, x0, data, **common)


def regularization_penalty(cfg: GLMOptimizationConfiguration, coefs: Tensor):
    """l1 * sum|w| + l2 / 2 * sum w^2 of the config as a device scalar;
    Python ``0.0`` when the config has no penalty (``problem.py:277-290``,
    ``random_effect.py:956-968``)."""
    reg = cfg.regularization_context
    l1 = reg.l1_weight(cfg.regularization_weight)
    l2 = reg.l2_weight(cfg.regularization_weight)
    val = 0.0
    if l1 > 0:
        val = val + l1 * coefs.abs().sum()
    if l2 > 0:
        val = val + 0.5 * l2 * (coefs * coefs).sum()
    return val

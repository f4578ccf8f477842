"""Random-effect solver: one lane-batched solve over entity blocks.

Port of ``photon_ml_tpu/game/random_effect.py`` — the ``CONV_*`` codes
(``:67-78``), ``_fit_blocks_impl`` (``:193-296``, the JAX package ``vmap``s
a single-lane solver over entities; here the ``[E, N, D]`` block is one
lane-batched L-BFGS, OWL-QN or TRON solve with the per-lane convergence
classification of ``:258-287``, the same for every solver),
``RandomEffectOptimizationProblem.run``/``_run_bucketed`` (``:739-975``)
and the score exchange ``score_active``/``score_passive``/
``score_random_effect`` (``:978-1058``).

Scatter determinism: each real sample appears at most once per coordinate
and every padded slot carries an exact zero into the discard slot
``num_samples``, so a non-accumulating ``scatter_`` gives the same result
as ``segment_sum`` in any order.

Lane compaction, the chunk auto-tuner and entity sharding wait for later
slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.data.batch import DenseBatch, acc_dtype_for
from photon_ml_tpu_torch.game.dataset import RandomEffectDataset
from photon_ml_tpu_torch.ops.aggregators import GLMObjective
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.optimize.common import solver_x0
from photon_ml_tpu_torch.optimize.config import (
    GLMOptimizationConfiguration,
    TASK_LOSS_NAME,
    TaskType,
)
from photon_ml_tpu_torch.optimize.problem import (
    minimize,
    regularization_penalty,
    select_solver,
)

Tensor = torch.Tensor

CONV_MAX_ITERATIONS = 0
CONV_FUNCTION_VALUES = 1
CONV_GRADIENT = 2
CONV_NOT_PROGRESSED = 3
CONVERGENCE_CODE_NAMES = {
    CONV_MAX_ITERATIONS: "MaxIterations",
    CONV_FUNCTION_VALUES: "FunctionValuesConverged",
    CONV_GRADIENT: "GradientConverged",
    CONV_NOT_PROGRESSED: "ObjectiveNotImproving",
}


def _vg(w: Tensor, payload) -> tuple[Tensor, Tensor]:
    obj, batch = payload
    return obj.calculate(w, batch)


def _hvp(w: Tensor, v: Tensor, payload) -> Tensor:
    obj, batch = payload
    return obj.hessian_vector(w, v, batch)


def _fit_blocks_impl(X: Tensor, labels: Tensor, offsets: Tensor,
                     weights: Tensor, initial: Tensor, obj: GLMObjective,
                     l1: Tensor, solver: str, max_iter: int,
                     tolerance: float
                     ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Solve every entity lane of ``X [E, N, D]`` with ``solver``
    ("lbfgs" / "owlqn" / "tron"; ``l1 [D]`` is OWL-QN's weight); returns
    (coefs [E, D], iterations [E], final values [E], convergence codes
    [E] int8)."""
    batch = DenseBatch(X=X, labels=labels, offsets=offsets, weights=weights)
    x, hist, progressed = minimize(solver, _vg, _hvp, initial, (obj, batch),
                                   l1, max_iter, tolerance)
    k = hist.num_iterations
    rows = torch.arange(k.shape[0], device=k.device)
    final_value = hist.values[rows, k]
    prev_value = hist.values[rows, torch.clamp(k - 1, min=0)]
    # classification in the host order of Optimizer.getConvergenceReason:
    # max-iterations, not-progressed, function values, gradient
    fv = (k >= 1) & ((final_value - prev_value).abs()
                     <= tolerance * hist.values[:, 0].abs())
    gv = hist.grad_norms[rows, k] <= tolerance * hist.grad_norms[:, 0]

    def code(c):
        return torch.full_like(k, c)

    converged = torch.where(
        ~progressed, code(CONV_NOT_PROGRESSED),
        torch.where(fv, code(CONV_FUNCTION_VALUES),
                    torch.where(gv, code(CONV_GRADIENT),
                                code(CONV_FUNCTION_VALUES))))
    codes = torch.where(k >= max_iter, code(CONV_MAX_ITERATIONS), converged)
    return x, k, final_value, codes.to(torch.int8)


@dataclasses.dataclass(frozen=True)
class RandomEffectOptimizationProblem:
    """Per-entity GLM problems for one random-effect coordinate: one config
    for all entities; the per-entity state is the coefficient block."""

    config: GLMOptimizationConfiguration
    task: TaskType

    def objective(self) -> GLMObjective:
        cfg = self.config
        return GLMObjective(
            loss=get_loss(TASK_LOSS_NAME[self.task]),
            l2_lambda=cfg.regularization_context.l2_weight(
                cfg.regularization_weight),
            has_hessian=self.task != TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)

    def run(self, dataset: RandomEffectDataset, offsets,
            initial: Optional[Tensor] = None
            ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
        """Fit all entities; returns (coefficients [E, D_red], iterations,
        final losses, convergence codes). ``offsets`` is the entity-major
        block (a list per bucket when bucketed)."""
        cfg = self.config
        solver = select_solver(cfg, self.task)
        l1 = cfg.regularization_context.l1_weight(cfg.regularization_weight)
        if dataset.buckets is not None:
            return self._run_bucketed(dataset, offsets, initial, solver, l1)
        e, _, d = dataset.X.shape
        acc = acc_dtype_for(dataset.X.dtype)
        x0 = solver_x0(acc, (e, d), initial, dataset.X.device)
        return _fit_blocks_impl(dataset.X, dataset.labels, offsets.to(acc),
                                dataset.weights, x0, self.objective(),
                                torch.full((d,), l1, dtype=acc,
                                           device=x0.device),
                                solver, cfg.max_iterations,
                                float(cfg.tolerance))

    def _run_bucketed(self, dataset: RandomEffectDataset, offsets,
                      initial: Optional[Tensor], solver: str, l1: float):
        """Per-bucket solves assembled into one compact global block in
        bucket-major entity order (``random_effect.py:895-954``)."""
        cfg = self.config
        d_red = dataset.reduced_dim
        acc = acc_dtype_for(dataset.buckets[0].X.dtype)
        obj = self.objective()
        initial_acc = None if initial is None else initial.to(acc)
        outs = []
        for bucket, off_b in zip(dataset.buckets, offsets):
            e_b, _, d_b = bucket.X.shape
            nr, start = bucket.num_real, bucket.entity_start
            dev = bucket.X.device
            if initial_acc is None:
                x0_b = torch.zeros((e_b, d_b), dtype=acc, device=dev)
            else:
                x0_b = torch.nn.functional.pad(
                    initial_acc[start:start + nr, :d_b], (0, 0, 0, e_b - nr))
            outs.append(_fit_blocks_impl(
                bucket.X, bucket.labels, off_b.to(acc), bucket.weights, x0_b,
                obj, torch.full((d_b,), l1, dtype=acc, device=dev), solver,
                cfg.max_iterations, float(cfg.tolerance)))
        pairs = list(zip(dataset.buckets, outs))
        coefs = torch.cat([
            torch.nn.functional.pad(c[:b.num_real],
                                    (0, d_red - int(c.shape[1]))).to(acc)
            for b, (c, _, _, _) in pairs])
        iters = torch.cat([it[:b.num_real] for b, (_, it, _, _) in pairs])
        values = torch.cat([v[:b.num_real].to(acc)
                            for b, (_, _, v, _) in pairs])
        codes = torch.cat([k[:b.num_real] for b, (_, _, _, k) in pairs])
        return coefs, iters, values, codes

    def regularization_value_device(self, coefs: Tensor):
        """Sum over entities of the L1 + L2 penalty as a device scalar;
        Python ``0.0`` when the config has none."""
        return regularization_penalty(self.config, coefs)

    def regularization_value(self, coefs: Tensor) -> float:
        val = self.regularization_value_device(coefs)
        return val if isinstance(val, float) else float(val)


def score_active(X: Tensor, coefs: Tensor, row_ids: Tensor, weights: Tensor,
                 num_samples: int) -> Tensor:
    """Scatter per-entity active-row margins back to the sample axis;
    padded rows (weight 0) land in the discard slot ``num_samples``."""
    margins = torch.einsum("end,ed->en", X.to(torch.float32),
                           coefs.to(torch.float32))
    margins = torch.where(weights > 0, margins, torch.zeros_like(margins))
    flat = margins.new_zeros(num_samples + 1)
    flat.scatter_(0, row_ids.reshape(-1), margins.reshape(-1))
    return flat[:num_samples]


def score_passive(passive_X: Tensor, passive_entity: Tensor, coefs: Tensor,
                  passive_row_ids: Tensor, num_samples: int) -> Tensor:
    """Score passive rows with their entity's model (gather + row dot)."""
    w = coefs[passive_entity]
    margins = (passive_X * w).sum(-1)
    flat = margins.new_zeros(num_samples + 1)
    flat.scatter_(0, passive_row_ids, margins)
    return flat[:num_samples]


def score_random_effect(dataset: RandomEffectDataset,
                        coefs: Tensor) -> Tensor:
    """Full sample-axis score vector (active + passive) for a coordinate;
    ``coefs`` is the compact global block ``[num_entities, reduced_dim]``."""
    n = dataset.num_samples
    if dataset.buckets is not None:
        s = coefs.new_zeros(n, dtype=torch.float32)
        for b in dataset.buckets:
            e_b, _, d_b = b.X.shape
            c_b = coefs.new_zeros((e_b, d_b))
            c_b[:b.num_real] = coefs[b.entity_start:b.entity_start
                                     + b.num_real, :d_b]
            s = s + score_active(b.X, c_b, b.row_ids, b.weights, n)
    else:
        s = score_active(dataset.X, coefs, dataset.row_ids, dataset.weights,
                         n)
    if dataset.num_passive:
        s = s + score_passive(dataset.passive_X, dataset.passive_entity,
                              coefs, dataset.passive_row_ids, n)
    return s

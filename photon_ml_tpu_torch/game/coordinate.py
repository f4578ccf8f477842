"""GAME coordinates: per-coordinate update/score units.

Port of ``photon_ml_tpu/game/coordinate.py:67-423`` — the trackers,
``FixedEffectCoordinate``, ``RandomEffectCoordinate`` and
``FactoredRandomEffectCoordinate``. A coordinate's state is its
coefficient tensor (``[D]`` for the fixed effect in normalized space, the
compact ``[E, D_red]`` block for a random effect), or for a factored
random effect the pair ``(coefs [E, K], B [K, D])``: per-entity
coefficients in a K-dimensional latent space and the shared latent-to-raw
projection.
A fixed effect whose config has a down-sampling rate below 1 samples its
batch at every update (``sampler/samplers.py``) with the key
``PRNGKey(seed + _update_count)``; the count advances on every update,
sampled or not (``:195-201``), and snapshots carry it under
``update_counts``, so a resumed or replayed update draws the same rows.
A random effect accepts such a rate and ignores it, as the JAX coordinate
does (``:252-266`` has no sampler).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from photon_ml_tpu_torch.data.batch import DenseBatch, acc_dtype_for
from photon_ml_tpu_torch.game.dataset import (
    FixedEffectDataset,
    RandomEffectDataset,
)
from photon_ml_tpu_torch.game.models import (
    FactoredRandomEffectModel,
    FixedEffectModel,
    RandomEffectModelInProjectedSpace,
)
from photon_ml_tpu_torch.game.random_effect import (
    CONVERGENCE_CODE_NAMES,
    RandomEffectOptimizationProblem,
    score_random_effect,
)
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.optimize.common import (
    DeferredOptimizationResult,
    OptimizationResult,
)
from photon_ml_tpu_torch.optimize.config import TaskType
from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.sampler.samplers import down_sample
from photon_ml_tpu_torch.utils.prng import PRNGKey, normal

Tensor = torch.Tensor

_CLASSIFICATION_TASKS = (TaskType.LOGISTIC_REGRESSION,
                         TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)


@dataclasses.dataclass
class FixedEffectTracker:
    """Fixed-effect solve record; the history stays on the device until
    :meth:`materialize` (one fetch). A mesh-sharded solve hands in an
    eager ``OptimizationResult``, read already."""

    result: Union[DeferredOptimizationResult, OptimizationResult]

    def materialize(self) -> "FixedEffectTracker":
        if isinstance(self.result, DeferredOptimizationResult):
            self.result._force()
        return self

    def summary(self) -> str:
        return (f"fixed effect: {self.result.convergence_reason.name}, "
                f"{self.result.iterations} iterations")


@dataclasses.dataclass
class RandomEffectTracker:
    """Per-entity iteration counts, final values and convergence codes;
    device tensors until :meth:`materialize` fetches them in one read."""

    iterations: object  # [E]
    final_values: object  # [E]
    convergence_codes: object  # [E] int8
    #: real entities: the arrays are cut to these at materialization (a
    #: single block padded to the entity axis carries empty lanes past
    #: them); None when the arrays are compact already
    num_real: Optional[int] = None

    def materialize(self) -> "RandomEffectTracker":
        """The three per-entity arrays in ONE device-to-host copy (counted
        at site ``tracker.materialize``): widened to f64 on the device,
        which is exact for the counts, the f32 values and the codes, and
        cut back into their dtypes on the host (and to ``num_real``
        entities). Idempotent."""
        if isinstance(self.iterations, torch.Tensor):
            from photon_ml_tpu_torch.utils.sync_telemetry import (
                record_host_fetch,
            )

            arrays = (self.iterations, self.final_values,
                      self.convergence_codes)
            flat = torch.cat([a.reshape(-1).to(torch.float64)
                              for a in arrays]).cpu()
            record_host_fetch(site="tracker.materialize")
            out, at = [], 0
            for a in arrays:
                out.append(flat[at:at + a.numel()].reshape(a.shape)
                           .to(a.dtype).numpy())
                at += a.numel()
            if self.num_real is not None:
                out = [a[:self.num_real] for a in out]
                self.num_real = None
            self.iterations, self.final_values, self.convergence_codes = out
        return self

    def counts_by_convergence(self) -> dict[str, int]:
        """reason name -> entity count (countsByConvergence)."""
        self.materialize()
        codes, counts = np.unique(self.convergence_codes, return_counts=True)
        return {CONVERGENCE_CODE_NAMES[int(c)]: int(n)
                for c, n in zip(codes, counts)}

    def summary(self) -> str:
        it = self.materialize().iterations
        counts = self.counts_by_convergence()
        return (f"random effect: {len(it)} entities, iterations "
                f"min/mean/max = {it.min()}/{it.mean():.1f}/{it.max()}, "
                "convergence " + "/".join(
                    f"{k}={v}" for k, v in sorted(counts.items())))


@dataclasses.dataclass
class FactoredRandomEffectTracker:
    """One (latent per-entity, projection refit) tracker pair per inner
    iteration (``coordinate.py:150-161``)."""

    inner: list

    def materialize(self) -> "FactoredRandomEffectTracker":
        for re_tracker, fe_tracker in self.inner:
            re_tracker.materialize()
            fe_tracker.materialize()
        return self

    def summary(self) -> str:
        return f"factored random effect: {len(self.inner)} inner iterations"


Tracker = Union[FixedEffectTracker, RandomEffectTracker,
                FactoredRandomEffectTracker]


@dataclasses.dataclass
class FixedEffectCoordinate:
    """Global GLM coordinate over the full sample batch."""

    dataset: FixedEffectDataset
    problem: GLMOptimizationProblem
    seed: int = 0
    _update_count: int = 0

    @property
    def num_samples(self) -> int:
        return self.dataset.num_samples

    @property
    def device(self) -> torch.device:
        return self.dataset.batch.device

    def initial_state(self) -> Tensor:
        """Zero f32 coefficients in normalized space."""
        return torch.zeros(self.dataset.batch.num_features,
                           dtype=torch.float32, device=self.device)

    def update(self, coefs: Optional[Tensor], extra_scores: Tensor
               ) -> tuple[Tensor, Tracker]:
        """Re-optimize on the offset-adjusted (and, below rate 1,
        down-sampled) batch; no blocking read of the solve history (it
        stays in the tracker)."""
        batch = self.dataset.with_offsets(extra_scores)
        rate = self.problem.config.down_sampling_rate
        if rate < 1.0:
            batch = down_sample(
                batch, rate, PRNGKey(self.seed + self._update_count),
                is_classification=self.problem.task in _CLASSIFICATION_TASKS)
        self._update_count += 1
        result = self.problem.run_lazy(batch, initial=coefs)
        return result.coefficients, FixedEffectTracker(result)

    def score(self, coefs: Tensor) -> Tensor:
        """Sample-axis margins x.w through the normalization algebra."""
        w_eff, shift = self.problem.normalization.effective_coefficients(
            coefs)
        zero_off = self.dataset.batch._replace(
            offsets=torch.zeros_like(self.dataset.base_offsets))
        return zero_off.margins(w_eff, shift)

    def regularization_value_device(self, coefs: Tensor):
        return self.problem.regularization_value_device(coefs)

    def publish(self, coefs: Tensor) -> FixedEffectModel:
        means = self.problem.normalization.transform_model_coefficients(coefs)
        return FixedEffectModel(
            model=GeneralizedLinearModel(Coefficients(means=means),
                                         self.problem.task),
            feature_shard_id=self.dataset.shard_id)


@dataclasses.dataclass
class RandomEffectCoordinate:
    """Per-entity GLM coordinate; its state is the projected-space block."""

    dataset: RandomEffectDataset
    problem: RandomEffectOptimizationProblem

    @property
    def num_samples(self) -> int:
        return self.dataset.num_samples

    @property
    def device(self) -> torch.device:
        """The dataset's device (its feature blocks may be host memmaps)."""
        return self.dataset.device

    def initial_state(self) -> Tensor:
        return torch.zeros((self.dataset.num_entities,
                            self.dataset.reduced_dim), dtype=torch.float32,
                           device=self.device)

    def update(self, coefs: Optional[Tensor], extra_scores: Tensor
               ) -> tuple[Tensor, Tracker]:
        offsets = self.dataset.offsets_with(extra_scores)
        new_coefs, iters, values, codes = self.problem.run(
            self.dataset, offsets, initial=coefs)
        return new_coefs, RandomEffectTracker(
            iters, values, codes, num_real=len(self.dataset.entity_codes))

    def score(self, coefs: Tensor) -> Tensor:
        return score_random_effect(
            self.dataset, coefs, entity_shards=self.problem.entity_shards,
            collective_quant=self.problem.collective_quant)

    def regularization_value_device(self, coefs: Tensor):
        return self.problem.regularization_value_device(coefs)

    def publish(self, coefs: Tensor) -> RandomEffectModelInProjectedSpace:
        # the empty lanes that pad a single block to the entity axis have
        # no entity: the model keeps the real ones
        return RandomEffectModelInProjectedSpace(
            random_effect_type=self.dataset.config.random_effect_type,
            feature_shard_id=self.dataset.config.feature_shard_id,
            entity_codes=self.dataset.entity_codes,
            coefficients_projected=coefs[:len(self.dataset.entity_codes)],
            projectors=self.dataset.projectors,
            random_projector=self.dataset.random_projector)


def _latent(X: Tensor, B: Tensor) -> Tensor:
    """Rows projected into the latent space, ``X · Bᵀ`` in X's accumulator
    dtype (f32 for f32 blocks; the JAX package's ``einsum("end,kd->enk")``,
    outside any kernel)."""
    acc = acc_dtype_for(X.dtype)
    return torch.matmul(X.to(acc), B.to(acc).T)


@dataclasses.dataclass
class FactoredRandomEffectCoordinate:
    """Alternating latent-space random effect and projection refit
    (``coordinate.py:295-423``; FactoredRandomEffectCoordinate.scala).

    The dataset is identity-projected and single-block (raw
    ``[E, N, D]``). Each update runs ``num_inner_iterations`` of: (1) the
    per-entity solve on the latent block ``X · Bᵀ`` (``problem``, the
    random effect's lane-batched solver, with or without lane
    compaction); (2) the refit of B as one GLM (``latent_problem``) over
    the Kronecker rows ``c_e ⊗ x`` of shape ``[E·N, K·D]``, whose
    coefficient vector is vec(B) — built as an elementwise product and a
    reshape, and solved through the fused kernel like a fixed effect.
    B₀ is ``normal(PRNGKey(seed), (K, D)) / sqrt(K)`` drawn on the host in
    f32 (``utils/prng.py``), the JAX package's bits, so the card and the
    CPU start from the same point.

    On a gang member (a dataset sliced over the processes of the default
    mesh's entity axis) the per-entity solve gathers every slice
    (``game/random_effect.py``), the Kronecker rows are this slice's, and
    the refit runs over a data axis spanning the same processes, so every
    member ends with the same B.
    """

    dataset: RandomEffectDataset
    problem: RandomEffectOptimizationProblem
    latent_problem: GLMOptimizationProblem
    latent_dim: int
    num_inner_iterations: int = 2
    seed: int = 0

    def __post_init__(self):
        if self.dataset.projectors is not None or \
                self.dataset.random_projector is not None:
            raise ValueError(
                "factored coordinate needs an identity-projected dataset")
        if self.dataset.buckets is not None:
            raise ValueError(
                "factored coordinate needs a single-block dataset "
                "(build with num_buckets=1): the latent refit shares one "
                "projection matrix across all entities")

    @property
    def num_samples(self) -> int:
        return self.dataset.num_samples

    @property
    def device(self) -> torch.device:
        return self.dataset.X.device

    def initial_state(self) -> tuple[Tensor, Tensor]:
        k = self.latent_dim
        b0 = normal(PRNGKey(self.seed), (k, self.dataset.reduced_dim),
                    device=self.device) / torch.sqrt(
                        torch.tensor(k, dtype=torch.float32,
                                     device=self.device))
        return (torch.zeros((self.dataset.num_entities, k),
                            dtype=torch.float32, device=self.device), b0)

    def _latent_dataset(self, B: Tensor, passive: bool = False):
        ds = self.dataset
        extra = {}
        if passive and ds.passive_X is not None:
            extra["passive_X"] = _latent(ds.passive_X, B)
        return dataclasses.replace(ds, X=_latent(ds.X, B), projectors=None,
                                   random_projector=None, **extra)

    def kronecker_batch(self, coefs: Tensor, offsets: Tensor) -> DenseBatch:
        """The refit's batch: row ``(e, i)`` is ``c_e ⊗ x_ei``, flattened
        to ``[E·N, K·D]`` with the block's labels, weights and the
        entity-major ``offsets``."""
        ds = self.dataset
        e, n, d = ds.X.shape
        if ds.entity_shard[1] > 1:  # this slice's entities
            coefs = coefs[ds.local_entity_offset:ds.local_entity_offset + e]
        # f32 for bf16 blocks: the product promotes X, as the JAX
        # package's einsum does (``preferred_element_type=f32``)
        kron = (coefs.to(acc_dtype_for(ds.X.dtype))[:, None, :, None]
                * ds.X[:, :, None, :])
        return DenseBatch(X=kron.reshape(e * n, int(coefs.shape[1]) * d),
                          labels=ds.labels.reshape(-1),
                          offsets=offsets.reshape(-1),
                          weights=ds.weights.reshape(-1))

    def update(self, state: Optional[tuple[Tensor, Tensor]],
               extra_scores: Tensor
               ) -> tuple[tuple[Tensor, Tensor], Tracker]:
        coefs, B = state if state is not None else self.initial_state()
        offsets = self.dataset.offsets_with(extra_scores)
        acc = acc_dtype_for(self.dataset.X.dtype)
        coefs, B = coefs.to(acc), B.to(acc)
        inner = []
        for _ in range(self.num_inner_iterations):
            coefs, iters, values, codes = self.problem.run(
                self._latent_dataset(B), offsets, initial=coefs)
            # the lazy solve: the refit's history stays on the device (the
            # JAX package's ``run`` differs only by the variances, which
            # the latent problem does not compute)
            result = self._refit(self.kronecker_batch(coefs, offsets), B)
            B = result.coefficients.reshape(B.shape)
            inner.append((RandomEffectTracker(iters, values, codes),
                          FixedEffectTracker(result)))
        return (coefs, B), FactoredRandomEffectTracker(inner)

    def _refit(self, batch: DenseBatch, B: Tensor):
        """The refit of B over ``batch``: local, or on a gang member over
        a data axis spanning the processes of the entity axis."""
        if self.dataset.entity_shard[1] <= 1:
            return self.latent_problem.run_lazy(batch, initial=B.reshape(-1))
        from photon_ml_tpu_torch.parallel.distributed import (
            run_glm_shard_map,
        )
        from photon_ml_tpu_torch.parallel.mesh import (
            DATA_AXIS,
            ENTITY_AXIS,
            get_default_mesh,
            make_mesh,
        )

        mesh = get_default_mesh()
        devices = mesh.axis_devices(ENTITY_AXIS)
        data_mesh = make_mesh(num_data=len(devices), devices=devices,
                              span=mesh.span_of(ENTITY_AXIS),
                              span_axis=DATA_AXIS)
        return run_glm_shard_map(self.latent_problem, batch, data_mesh,
                                 initial=B.reshape(-1))[1]

    def score(self, state: tuple[Tensor, Tensor]) -> Tensor:
        coefs, B = state
        return score_random_effect(
            self._latent_dataset(B, passive=True), coefs,
            entity_shards=self.problem.entity_shards,
            collective_quant=self.problem.collective_quant)

    def regularization_value_device(self, state: tuple[Tensor, Tensor]):
        coefs, B = state
        return (self.problem.regularization_value_device(coefs)
                + self.latent_problem.regularization_value_device(
                    B.reshape(-1)))

    def publish(self, state: tuple[Tensor, Tensor]
                ) -> FactoredRandomEffectModel:
        coefs, B = state
        return FactoredRandomEffectModel(
            random_effect_type=self.dataset.config.random_effect_type,
            feature_shard_id=self.dataset.config.feature_shard_id,
            entity_codes=self.dataset.entity_codes,
            coefficients_latent=coefs, projection=B)


Coordinate = Union[FixedEffectCoordinate, RandomEffectCoordinate,
                   FactoredRandomEffectCoordinate]

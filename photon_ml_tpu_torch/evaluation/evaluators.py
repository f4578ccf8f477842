"""Evaluator family: global and sharded (per-entity) metrics.

Port of ``photon_ml_tpu/evaluation/evaluators.py`` — ``EvaluatorType``,
``EvaluatorSpec.parse`` (the reference CLI spellings ``AUC``,
``LOGISTIC_LOSS``, ``AUC:userId``, ``precision@5:songId``),
``resolve_entity_ids``, ``evaluate_many`` (``:178``) and the sharded AUC
and precision@k (``:213-261``; reference: evaluation/Evaluator.scala:
24-78, ShardedEvaluator.scala:28). Per-entity metrics are computed for all
entities at once with one sort and segment reductions on the device.

``evaluate_many`` dispatches every metric and then fetches all of them in
ONE device->host copy, counted in ``EVAL_FETCHES``. Metrics are computed
in f64 whatever the scores' dtype (the JAX package computes them in the
scores' dtype). AUC and precision are larger-is-better; RMSE and the mean
losses smaller-is-better.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from photon_ml_tpu_torch.evaluation import metrics
from photon_ml_tpu_torch.ops.losses import get_loss

Tensor = torch.Tensor

#: Blocking device->host fetches taken by evaluate_many.
EVAL_FETCHES = {"count": 0}


class EvaluatorType(enum.Enum):
    AUC = "AUC"
    RMSE = "RMSE"
    LOGISTIC_LOSS = "LOGISTIC_LOSS"
    POISSON_LOSS = "POISSON_LOSS"
    SQUARED_LOSS = "SQUARED_LOSS"
    SMOOTHED_HINGE_LOSS = "SMOOTHED_HINGE_LOSS"
    SHARDED_AUC = "SHARDED_AUC"
    SHARDED_PRECISION_AT_K = "SHARDED_PRECISION_AT_K"


LARGER_IS_BETTER = {
    EvaluatorType.AUC, EvaluatorType.SHARDED_AUC,
    EvaluatorType.SHARDED_PRECISION_AT_K,
}

_LOSS_NAME = {
    EvaluatorType.LOGISTIC_LOSS: "logistic",
    EvaluatorType.POISSON_LOSS: "poisson",
    EvaluatorType.SQUARED_LOSS: "squared",
    EvaluatorType.SMOOTHED_HINGE_LOSS: "smoothed_hinge",
}


@dataclasses.dataclass(frozen=True)
class EvaluatorSpec:
    """Parsed evaluator request (type + sharding id-type + k)."""

    evaluator_type: EvaluatorType
    id_type: Optional[str] = None  # entity id column for sharded evaluators
    k: int = 1  # for precision@k

    @staticmethod
    def parse(s: str) -> "EvaluatorSpec":
        t = s.strip()
        if t.lower().startswith("precision@"):
            body = t.split(":", 1)
            k = int(body[0].split("@", 1)[1])
            if len(body) != 2 or not body[1]:
                raise ValueError(f"precision@k requires an id type: {s!r}")
            return EvaluatorSpec(EvaluatorType.SHARDED_PRECISION_AT_K,
                                 id_type=body[1], k=k)
        if ":" in t:
            head, id_type = t.split(":", 1)
            if head.upper() != "AUC":
                raise ValueError(f"unknown sharded evaluator {s!r}")
            if not id_type:
                raise ValueError(f"sharded AUC requires an id type: {s!r}")
            return EvaluatorSpec(EvaluatorType.SHARDED_AUC, id_type=id_type)
        return EvaluatorSpec(EvaluatorType(t.upper()))

    @property
    def name(self) -> str:
        if self.evaluator_type == EvaluatorType.SHARDED_PRECISION_AT_K:
            return f"precision@{self.k}:{self.id_type}"
        if self.evaluator_type == EvaluatorType.SHARDED_AUC:
            return f"AUC:{self.id_type}"
        return self.evaluator_type.value

    def better_than(self, a: float, b: float) -> bool:
        if self.evaluator_type in LARGER_IS_BETTER:
            return a > b
        return a < b


def _device_metric(spec: EvaluatorSpec, scores: Tensor, labels: Tensor,
                   weights: Optional[Tensor], entity_ids: Optional[Tensor],
                   num_entities: Optional[int]) -> Tensor:
    """One metric as an f64 device scalar, not fetched. The inputs are
    taken to f64 first: on the card a segment sum is a scatter of atomic
    adds in no fixed order, and f32 sums of 1e4-1e5 terms then move a
    metric by ~1e-6 from one evaluation of the same scores to the next."""
    f64 = torch.float64
    scores, labels = scores.to(f64), labels.to(f64)
    weights = None if weights is None else weights.to(f64)
    t = spec.evaluator_type
    if t == EvaluatorType.AUC:
        return metrics.area_under_roc_curve(labels, scores, weights)
    if t == EvaluatorType.RMSE:
        return metrics.root_mean_squared_error(labels, scores, weights)
    if t in _LOSS_NAME:
        return metrics.mean_loss(get_loss(_LOSS_NAME[t]), labels, scores,
                                 weights)
    if entity_ids is None or num_entities is None:
        raise ValueError(f"{spec.name} needs entity_ids + num_entities")
    if t == EvaluatorType.SHARDED_AUC:
        return sharded_auc(labels, scores, entity_ids, num_entities,
                           weights)
    if t == EvaluatorType.SHARDED_PRECISION_AT_K:
        return sharded_precision_at_k(labels, scores, entity_ids,
                                      num_entities, spec.k)
    raise ValueError(f"unhandled evaluator {spec}")


def resolve_entity_ids(specs: list[EvaluatorSpec], id_columns, id_vocabs,
                       device) -> tuple[dict[str, Tensor], dict[str, int]]:
    """Each sharded spec's id column on ``device`` and its vocab size,
    resolved once (shared by the training and scoring drivers)."""
    ids_by_type: dict[str, Tensor] = {}
    num_by_type: dict[str, int] = {}
    for spec in specs:
        if spec.id_type and spec.id_type not in ids_by_type:
            ids_by_type[spec.id_type] = torch.as_tensor(
                id_columns[spec.id_type], dtype=torch.int64, device=device)
            num_by_type[spec.id_type] = len(id_vocabs[spec.id_type])
    return ids_by_type, num_by_type


def evaluate_many(specs: list[EvaluatorSpec], scores: Tensor, labels: Tensor,
                  weights: Optional[Tensor] = None,
                  entity_ids_by_type: Optional[dict[str, Tensor]] = None,
                  num_entities_by_type: Optional[dict[str, int]] = None
                  ) -> dict[str, float]:
    """All requested metrics with ONE blocking device->host fetch."""
    device_vals = []
    for spec in specs:
        eid = nent = None
        if spec.id_type is not None:
            eid = (entity_ids_by_type or {}).get(spec.id_type)
            nent = (num_entities_by_type or {}).get(spec.id_type)
            if eid is None or nent is None:
                raise ValueError(
                    f"evaluator {spec.name!r} needs entity ids for id "
                    f"type {spec.id_type!r}")
        device_vals.append(_device_metric(
            spec, scores, labels, weights, eid, nent))
    fetched = torch.stack(device_vals).tolist() if device_vals else []
    EVAL_FETCHES["count"] += 1
    return {spec.name: float(v) for spec, v in zip(specs, fetched)}


def sharded_auc(labels: Tensor, scores: Tensor, entity_ids: Tensor,
                num_entities: int, weights: Optional[Tensor] = None
                ) -> Tensor:
    """Unweighted mean of per-entity AUCs over entities with both
    classes (the global AUC's segment kernel with real ids)."""
    num_e, pos_e, neg_e = metrics.segment_auc_stats(
        labels, scores, weights, entity_ids, num_entities)
    denom = pos_e * neg_e
    valid = denom > 0.0
    auc_e = num_e / torch.where(valid, denom, torch.ones_like(denom))
    return (torch.where(valid, auc_e, torch.zeros_like(auc_e)).sum()
            / torch.clamp(valid.sum(), min=1))


def sharded_precision_at_k(labels: Tensor, scores: Tensor,
                           entity_ids: Tensor, num_entities: int, k: int
                           ) -> Tensor:
    """Mean per-entity precision among each entity's top-k scores; an
    entity with fewer than k rows uses all of them."""
    order = metrics.lexsort(-scores, entity_ids)
    e_s = entity_ids[order]
    acc = torch.promote_types(scores.dtype, torch.float32)
    pos_s = (labels[order] > 0.5).to(acc)
    n = scores.shape[0]
    idx = torch.arange(n, device=scores.device)
    ent_start = metrics.segment_min(idx, e_s, num_entities)
    in_top = (idx - ent_start[e_s]) < k
    hits_e = metrics.segment_sum(
        torch.where(in_top, pos_s, torch.zeros_like(pos_s)), e_s,
        num_entities)
    cnt_e = metrics.segment_sum(in_top.to(acc), e_s, num_entities)
    has_rows = cnt_e > 0
    prec_e = hits_e / torch.clamp(cnt_e, min=torch.finfo(acc).tiny)
    mean = (torch.where(has_rows, prec_e, torch.zeros_like(prec_e)).sum()
            / torch.clamp(has_rows.sum(), min=1))
    return mean.to(scores.dtype)

"""Metric kernels as PyTorch functions on the device, sort-based and exact.

Port of ``photon_ml_tpu/evaluation/metrics.py:25-234`` (reference:
Evaluation.scala:32-152 and the AUC evaluators): MAE/MSE/RMSE, the
weighted tie-aware ROC AUC through per-entity Mann-Whitney sums, PR AUC,
peak F1, per-datum log-likelihoods, AIC, mean loss and precision@k. Every
metric is a few sorts, cumulative sums and segment reductions on the
tensors' device; nothing is fetched here.

Sorts are stable, so ties order by position as ``jnp.lexsort``/
``jax.lax.top_k`` order them; a segment sum is ``index_add_`` and a
segment minimum ``scatter_reduce_(..., "amin")``.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def _wmean(x: Tensor, weights: Optional[Tensor]) -> Tensor:
    if weights is None:
        return x.mean()
    return (weights * x).sum() / weights.sum()


# --- regression metrics -----------------------------------------------------


def mean_absolute_error(labels: Tensor, predictions: Tensor,
                        weights: Optional[Tensor] = None) -> Tensor:
    return _wmean((predictions - labels).abs(), weights)


def mean_squared_error(labels: Tensor, predictions: Tensor,
                       weights: Optional[Tensor] = None) -> Tensor:
    d = predictions - labels
    return _wmean(d * d, weights)


def root_mean_squared_error(labels: Tensor, predictions: Tensor,
                            weights: Optional[Tensor] = None) -> Tensor:
    return torch.sqrt(mean_squared_error(labels, predictions, weights))


# --- sort and segment helpers ----------------------------------------------


def lexsort(minor: Tensor, major: Tensor) -> Tensor:
    """Indices ordering by ``major``, ties by ``minor``, remaining ties by
    position (``jnp.lexsort((minor, major))``)."""
    o1 = torch.sort(minor, stable=True).indices
    o2 = torch.sort(major[o1], stable=True).indices
    return o1[o2]


def segment_sum(x: Tensor, seg: Tensor, num_segments: int) -> Tensor:
    return x.new_zeros(num_segments).index_add_(0, seg, x)


def segment_min(x: Tensor, seg: Tensor, num_segments: int) -> Tensor:
    """Per-segment minimum; an empty segment holds the dtype's maximum."""
    big = (torch.finfo(x.dtype).max if x.is_floating_point()
           else torch.iinfo(x.dtype).max)
    return x.new_full((num_segments,), big).scatter_reduce_(
        0, seg, x, "amin", include_self=True)


def _exclusive_cumsum(x: Tensor) -> Tensor:
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0)[:-1]])


# --- ROC AUC (exact, weighted, tie-aware) ----------------------------------


def segment_auc_stats(labels: Tensor, scores: Tensor,
                      weights: Optional[Tensor], entity_ids: Tensor,
                      num_entities: int) -> tuple[Tensor, Tensor, Tensor]:
    """Per-entity Mann-Whitney numerator and class weights
    ``(num_e, pos_e, neg_e)``: AUC_e = num_e / (pos_e * neg_e) where both
    classes are present; ties count half (MLlib's curve integration)."""
    w = torch.ones_like(scores) if weights is None else weights
    n = scores.shape[0]
    order = lexsort(scores, entity_ids)
    e_s = entity_ids[order]
    s_s = scores[order]
    pos_s = labels[order] > 0.5
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    wp_s = torch.where(pos_s, w[order], zero)
    wn_s = torch.where(pos_s, zero, w[order])

    # exclusive cumsum of negative weight, made per-entity by subtracting
    # the entity-start value (the entity minimum of a nondecreasing sum)
    cum_n = _exclusive_cumsum(wn_s)
    ent_start = segment_min(cum_n, e_s, num_entities)
    n_below_in_entity = cum_n - ent_start[e_s]

    # tie groups within an entity
    new_group = torch.cat([
        torch.ones(1, dtype=torch.bool, device=scores.device),
        (e_s[1:] != e_s[:-1]) | (s_s[1:] != s_s[:-1])])
    gid = torch.cumsum(new_group.to(torch.int64), 0) - 1
    g_n = segment_sum(wn_s, gid, n)
    g_below = segment_min(n_below_in_entity, gid, n)

    contrib = wp_s * (g_below[gid] + 0.5 * g_n[gid])
    return (segment_sum(contrib, e_s, num_entities),
            segment_sum(wp_s, e_s, num_entities),
            segment_sum(wn_s, e_s, num_entities))


def area_under_roc_curve(labels: Tensor, scores: Tensor,
                         weights: Optional[Tensor] = None) -> Tensor:
    """P(score_pos > score_neg) + 0.5 P(tie), weighted; 0.5 for
    single-class input."""
    ids = torch.zeros(scores.shape[0], dtype=torch.int64,
                      device=scores.device)
    num, pos, neg = segment_auc_stats(labels, scores, weights, ids, 1)
    denom = pos[0] * neg[0]
    auc = num[0] / torch.where(denom > 0.0, denom, torch.ones_like(denom))
    return torch.where(denom > 0.0, auc, torch.full_like(auc, 0.5))


# --- PR AUC and peak F1 -----------------------------------------------------


def _pr_points(labels: Tensor, scores: Tensor, weights: Optional[Tensor]):
    """Precision/recall at every position of the descending score order;
    ``is_boundary`` marks the last element of each tie group."""
    w = torch.ones_like(scores) if weights is None else weights
    pos = labels > 0.5
    order = torch.sort(-scores, stable=True).indices
    s = scores[order]
    wp = torch.where(pos, w, torch.zeros_like(w))[order]
    wt = w[order]
    cum_tp = torch.cumsum(wp, 0)
    cum_pred_pos = torch.cumsum(wt, 0)
    total_pos = wp.sum()
    is_boundary = torch.cat([s[:-1] != s[1:],
                             torch.ones(1, dtype=torch.bool,
                                        device=s.device)])
    one = torch.ones((), dtype=w.dtype, device=w.device)
    precision = cum_tp / torch.where(cum_pred_pos > 0.0, cum_pred_pos, one)
    recall = cum_tp / torch.where(total_pos > 0.0, total_pos, one)
    return precision, recall, is_boundary


def area_under_pr_curve(labels: Tensor, scores: Tensor,
                        weights: Optional[Tensor] = None) -> Tensor:
    """Trapezoidal area under the precision-recall curve, with the MLlib
    initial point (r=0, p=p(first threshold)); every position takes its
    tie group's end values, so within a group the trapezoids are empty."""
    precision, recall, is_boundary = _pr_points(labels, scores, weights)
    n = recall.shape[0]
    idx = torch.arange(n, device=recall.device)
    ends = torch.where(is_boundary, idx, torch.full_like(idx, n - 1))
    next_boundary = torch.flip(
        torch.cummin(torch.flip(ends, [0]), 0).values, [0])
    p_b = precision[next_boundary]
    r_b = recall[next_boundary]
    r_prev = torch.cat([r_b.new_zeros(1), r_b[:-1]])
    p_prev = torch.cat([p_b[:1], p_b[:-1]])
    acc = torch.promote_types(p_b.dtype, torch.float32)
    return ((r_b - r_prev) * 0.5 * (p_b + p_prev)).to(acc).sum()


def peak_f1(labels: Tensor, scores: Tensor,
            weights: Optional[Tensor] = None) -> Tensor:
    """max over thresholds of 2 P R / (P + R)."""
    precision, recall, is_boundary = _pr_points(labels, scores, weights)
    pr_sum = precision + recall
    ok = pr_sum > 0.0
    f1 = torch.where(ok, 2.0 * precision * recall
                     / torch.where(ok, pr_sum, torch.ones_like(pr_sum)),
                     torch.zeros_like(pr_sum))
    return torch.where(is_boundary, f1,
                       torch.full_like(f1, -float("inf"))).max()


# --- per-datum log-likelihoods & AIC ---------------------------------------


def logistic_log_likelihood(labels: Tensor, margins: Tensor,
                            weights: Optional[Tensor] = None) -> Tensor:
    """Mean per-datum Bernoulli log-likelihood (Evaluation.scala:142-152)."""
    ll = -(torch.logaddexp(torch.zeros_like(margins), margins)
           - labels * margins)
    return _wmean(ll, weights)


def poisson_log_likelihood(labels: Tensor, margins: Tensor,
                           weights: Optional[Tensor] = None) -> Tensor:
    """Mean Poisson log-likelihood with the log Gamma(y+1) constant
    (Evaluation.scala:128-140)."""
    ll = labels * margins - torch.exp(margins) - torch.lgamma(labels + 1.0)
    return _wmean(ll, weights)


def linear_log_likelihood(labels: Tensor, margins: Tensor,
                          weights: Optional[Tensor] = None) -> Tensor:
    """Gaussian log-likelihood with unit variance."""
    d = labels - margins
    ll = -0.5 * (d * d + torch.log(torch.full_like(d, 2.0 * torch.pi)))
    return _wmean(ll, weights)


def akaike_information_criterion(total_log_likelihood: Tensor,
                                 num_parameters: int) -> Tensor:
    """AIC = 2k - 2 ln L (Evaluation.scala:100-112)."""
    return 2.0 * num_parameters - 2.0 * total_log_likelihood


# --- mean loss and precision@k ----------------------------------------------


def mean_loss(loss, labels: Tensor, margins: Tensor,
              weights: Optional[Tensor] = None) -> Tensor:
    """Weighted mean pointwise loss (evaluation/*LossEvaluator.scala)."""
    return _wmean(loss.loss(margins, labels), weights)


def precision_at_k(labels: Tensor, scores: Tensor, k: int,
                   valid: Optional[Tensor] = None) -> Tensor:
    """Fraction of positives among the top-k scores; ``valid`` masks
    padded rows out of the top k. Ties go to the lower position."""
    s = scores if valid is None else torch.where(
        valid, scores, torch.full_like(scores, -float("inf")))
    top_idx = torch.sort(s, descending=True, stable=True).indices[:k]
    hit = labels[top_idx] > 0.5
    acc = torch.promote_types(scores.dtype, torch.float32)
    if valid is not None:
        top_valid = valid[top_idx]
        denom = torch.clamp(top_valid.sum(), min=1)
        return (hit & top_valid).sum().to(acc) / denom.to(acc)
    return hit.to(acc).mean().to(scores.dtype)

"""Model diagnostics: Hosmer-Lemeshow, feature importance, independence,
learning curves, bootstrap confidence intervals.

Re-design of the reference's diagnostics suite (reference paths under
photon-ml/src/main/scala/com/linkedin/photon/ml/):

- Hosmer-Lemeshow (diagnostics/hl/HosmerLemeshowDiagnostic.scala:35-60):
  bin predicted probability vs observed positive frequency, χ² over bins.
- Feature importance (diagnostics/featureimportance/): importance =
  |coeff · factor| with factor = E|x_j| (ExpectedMagnitude...scala:42-58)
  or Var(x_j) (Variance...scala:41-55); top-ranked features + decile
  thresholds.
- Prediction-error independence (diagnostics/independence/): Kendall tau
  over (prediction, error) pairs, sample-capped
  (PredictionErrorIndependenceDiagnostic.scala:31-46,
  KendallTauAnalysis.scala:64-88).
- Learning curves (diagnostics/fitting/FittingDiagnostic.scala:48-110):
  rows tagged into NUM_TRAINING_PARTITIONS random buckets, last held out,
  warm-started retrains on growing fractions, per-λ per-metric curves.
- Bootstrap CIs (BootstrapTraining.scala:46-180 +
  diagnostics/bootstrap/BootstrapTrainingDiagnostic.scala): k resamples →
  retrain → percentile summaries of coefficients and metrics.

All computations are vectorized numpy/JAX over columnar data; the
``model_factory`` callbacks mirror the reference's (data, warmStart) →
models contract so the driver can plug in its λ-grid trainer.

A copy of ``photon_ml_tpu/diagnostics/diagnostics.py`` (numpy and scipy only),
importing the port's own modules.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import numpy as np
from scipy import stats as scipy_stats

from photon_ml_tpu_torch.diagnostics.reports import (
    BootstrapReport,
    CoefficientSummary,
    FeatureImportanceReport,
    FittingMetricCurve,
    FittingReport,
    HosmerLemeshowBin,
    HosmerLemeshowReport,
    KendallTauReport,
    PredictionErrorIndependenceReport,
)

# Reference constants.
HL_MIN_EXPECTED_IN_BUCKET = 5.0  # hl/HosmerLemeshowDiagnostic MINIMUM_...
HL_DEFAULT_BINS = 10
MAX_RANKED_FEATURES = 20  # featureimportance/AbstractFeatureImportance...
KT_MAX_SAMPLES = 5000  # independence/PredictionErrorIndependenceDiagnostic
FIT_NUM_TRAINING_PARTITIONS = 10  # fitting/FittingDiagnostic
FIT_MIN_SAMPLES_PER_PARTITION_PER_DIMENSION = 10


# ---------------------------------------------------------------------------
# Hosmer-Lemeshow goodness-of-fit (logistic models)
# ---------------------------------------------------------------------------


def hosmer_lemeshow(labels: np.ndarray, predicted_probs: np.ndarray,
                    num_bins: int = HL_DEFAULT_BINS) -> HosmerLemeshowReport:
    """Equal-width probability bins; χ² of observed vs expected counts for
    positives and negatives per bin; dof = bins - 2."""
    labels = np.asarray(labels, np.float64)
    p = np.clip(np.asarray(predicted_probs, np.float64), 0.0, 1.0)
    edges = np.linspace(0.0, 1.0, num_bins + 1)
    which = np.clip(np.digitize(p, edges[1:-1]), 0, num_bins - 1)

    bins: list[HosmerLemeshowBin] = []
    messages: list[str] = []
    chi2 = 0.0
    for b in range(num_bins):
        mask = which == b
        n_b = int(mask.sum())
        obs_pos = float(labels[mask].sum())
        obs_neg = float(n_b - obs_pos)
        exp_pos = float(p[mask].sum())
        exp_neg = float(n_b) - exp_pos
        bins.append(HosmerLemeshowBin(
            lower=float(edges[b]), upper=float(edges[b + 1]),
            observed_pos=obs_pos, observed_neg=obs_neg,
            expected_pos=exp_pos, expected_neg=exp_neg))
        if exp_pos > 0:
            chi2 += (obs_pos - exp_pos) ** 2 / exp_pos
            if exp_pos < HL_MIN_EXPECTED_IN_BUCKET:
                messages.append(
                    f"bin [{edges[b]:.2f}, {edges[b + 1]:.2f}): expected "
                    f"positive count {exp_pos:.2f} too small for a sound "
                    f"Chi^2 estimate")
        if exp_neg > 0:
            chi2 += (obs_neg - exp_neg) ** 2 / exp_neg
            if exp_neg < HL_MIN_EXPECTED_IN_BUCKET:
                messages.append(
                    f"bin [{edges[b]:.2f}, {edges[b + 1]:.2f}): expected "
                    f"negative count {exp_neg:.2f} too small for a sound "
                    f"Chi^2 estimate")
    dof = max(1, num_bins - 2)
    p_value = float(scipy_stats.chi2.sf(chi2, dof))
    return HosmerLemeshowReport(bins=bins, chi_square=float(chi2),
                                degrees_of_freedom=dof, p_value=p_value,
                                messages=messages)


# ---------------------------------------------------------------------------
# Feature importance
# ---------------------------------------------------------------------------


def feature_importance(
        coefficients: np.ndarray,
        index_map=None,
        factor: Optional[np.ndarray] = None,
        importance_type: str = "expected magnitude",
        max_ranked: int = MAX_RANKED_FEATURES) -> FeatureImportanceReport:
    """importance_j = |w_j * factor_j|; factor defaults to 1 when no summary
    is available (matching the reference's fallback). ``factor`` is
    ``meanAbs`` for expected-magnitude and ``variance`` for variance
    importance."""
    from photon_ml_tpu_torch.io.index_map import split_feature_key

    w = np.asarray(coefficients, np.float64)
    f = np.ones_like(w) if factor is None else np.asarray(factor, np.float64)
    imp = np.abs(w * f)
    order = np.argsort(-imp, kind="stable")

    top = {}
    for idx in order[:max_ranked]:
        key = index_map.key_of(int(idx)) if index_map is not None else None
        name, term = (split_feature_key(key) if key is not None
                      else (str(int(idx)), ""))
        top[(name, term)] = (int(idx), float(imp[idx]))

    deciles = np.percentile(imp, np.arange(10, 100, 10))
    rank_to_importance = {d: float(v)
                          for d, v in zip(range(10, 100, 10), deciles)}
    description = (
        "|E[|x|] * coefficient| (importance of the feature's average "
        "contribution to the margin)"
        if importance_type == "expected magnitude"
        else "|Var(x) * coefficient| (importance weighted by feature "
             "variance)")
    return FeatureImportanceReport(
        importance_type=importance_type,
        importance_description=description,
        feature_importance=top,
        rank_to_importance=rank_to_importance)


# ---------------------------------------------------------------------------
# Kendall-tau prediction-error independence
# ---------------------------------------------------------------------------


def kendall_tau(a: np.ndarray, b: np.ndarray) -> KendallTauReport:
    """Tau-alpha/tau-beta + z-score + p-value
    (independence/KendallTauAnalysis.scala:64-88). Pair counting is
    O(n log n) via scipy; tie counts via vectorized bincounts."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n = len(a)
    total = n * (n - 1) // 2

    # Tie pair counts within each sequence.
    def tie_pairs(x: np.ndarray) -> int:
        _, counts = np.unique(x, return_counts=True)
        return int(np.sum(counts * (counts - 1) // 2))

    ties_a = tie_pairs(a)
    ties_b = tie_pairs(b)
    # joint ties: pairs tied in BOTH sequences
    joint = np.unique(np.stack([a, b], axis=1), axis=0,
                      return_counts=True)[1]
    ties_both = int(np.sum(joint * (joint - 1) // 2))

    # scipy's kendalltau gives tau-b; recover concordant-discordant from it:
    # tau_b = (C - D) / sqrt((total - ties_a) * (total - ties_b))
    tau_b, _ = scipy_stats.kendalltau(a, b)
    if np.isnan(tau_b):
        tau_b = 0.0
    denom = np.sqrt(float(total - ties_a) * float(total - ties_b))
    c_minus_d = int(round(tau_b * denom))
    # C + D = total - ties_a - ties_b + ties_both (pairs untied in both)
    c_plus_d = total - ties_a - ties_b + ties_both
    concordant = (c_plus_d + c_minus_d) // 2
    discordant = c_plus_d - concordant

    tau_alpha = c_minus_d / c_plus_d if c_plus_d > 0 else 0.0
    d = np.sqrt(2.0 * (2.0 * n + 5.0) / (9.0 * n * (n - 1.0))) if n > 1 else 1.0
    z_alpha = tau_alpha / d
    p_value = float(2.0 * scipy_stats.norm.sf(abs(z_alpha)))
    msg = ("Tie handling: tau-alpha does not correct for ties, so the "
           "z score / p value over-estimate independence in the presence "
           "of ties.") if (ties_a or ties_b) else ""
    return KendallTauReport(
        concordant=int(concordant), discordant=int(discordant),
        ties_a=ties_a, ties_b=ties_b, num_items=n,
        tau_alpha=float(tau_alpha), tau_beta=float(tau_b),
        z_alpha=float(z_alpha), p_value=p_value, message=msg)


def prediction_error_independence(
        labels: np.ndarray, predictions: np.ndarray,
        max_samples: int = KT_MAX_SAMPLES,
        seed: int = 0) -> PredictionErrorIndependenceReport:
    """(prediction, error=label-prediction) sample → Kendall tau
    (PredictionErrorIndependenceDiagnostic.scala:31-46)."""
    predictions = np.asarray(predictions, np.float64)
    errors = np.asarray(labels, np.float64) - predictions
    if len(predictions) > max_samples:
        rng = np.random.default_rng(seed)
        idx = rng.choice(len(predictions), size=max_samples, replace=True)
        predictions, errors = predictions[idx], errors[idx]
    return PredictionErrorIndependenceReport(
        predictions=predictions, errors=errors,
        kendall_tau=kendall_tau(predictions, errors))


# ---------------------------------------------------------------------------
# Learning-curve fitting diagnostic
# ---------------------------------------------------------------------------

# model_factory(train_indices, holdout_indices, warm_start: {lambda: coef})
#   -> {lambda: (coefficients, {metric: value_on_train},
#                {metric: value_on_holdout})}
FitModelFactory = Callable[
    [np.ndarray, Optional[np.ndarray], dict],
    dict[float, tuple[np.ndarray, dict, dict]]]


def fitting_diagnostic(
        num_samples: int,
        dimension: int,
        model_factory: FitModelFactory,
        num_partitions: int = FIT_NUM_TRAINING_PARTITIONS,
        seed: int = 0) -> dict[float, FittingReport]:
    """Tag rows into ``num_partitions`` buckets, hold the last out, train on
    growing prefixes with warm starts, and collect per-λ per-metric
    train/test curves (fitting/FittingDiagnostic.scala:48-110)."""
    min_samples = dimension * FIT_MIN_SAMPLES_PER_PARTITION_PER_DIMENSION
    if num_samples <= min_samples:
        return {}

    rng = np.random.default_rng(seed)
    tags = rng.integers(0, num_partitions, size=num_samples)
    holdout = np.flatnonzero(tags == num_partitions - 1)

    curves: dict[float, dict[str, list[tuple[float, float, float]]]] = {}
    warm_start: dict = {}
    for max_tag in range(num_partitions - 1):
        train_idx = np.flatnonzero(tags <= max_tag)
        portion = 100.0 * len(train_idx) / num_samples
        # Test metrics are computed on the held-out partition — rows the
        # model never saw (FittingDiagnostic.scala evaluates metricsTest on
        # the holdout), so the curves can actually show overfitting.
        results = model_factory(train_idx, holdout, warm_start)
        warm_start = {lam: coef for lam, (coef, _, _) in results.items()}
        for lam, (_, train_metrics, test_metrics) in results.items():
            for metric, test_v in test_metrics.items():
                curves.setdefault(lam, {}).setdefault(metric, []).append(
                    (portion, float(train_metrics.get(metric, np.nan)),
                     float(test_v)))

    out: dict[float, FittingReport] = {}
    for lam, by_metric in curves.items():
        metric_curves = {}
        for metric, points in by_metric.items():
            points.sort(key=lambda t: t[0])
            arr = np.asarray(points, np.float64)
            metric_curves[metric] = FittingMetricCurve(
                portions=arr[:, 0], train_values=arr[:, 1],
                test_values=arr[:, 2])
        out[lam] = FittingReport(
            metrics=metric_curves,
            message=f"holdout size: {len(holdout)} rows")
    return out


# ---------------------------------------------------------------------------
# Bootstrap training diagnostic
# ---------------------------------------------------------------------------

# model_factory(train_indices, eval_indices=None, warm_start) ->
#   {lambda: (coefficients, {metric: value})}
BootstrapModelFactory = Callable[
    [np.ndarray, Optional[np.ndarray], dict],
    dict[float, tuple[np.ndarray, dict]]]


def bootstrap_training(
        num_samples: int,
        num_bootstrap_samples: int,
        portion_per_sample: float,
        model_factory: BootstrapModelFactory,
        warm_start: Optional[dict] = None,
        seed: int = 0) -> dict[float, BootstrapReport]:
    """k bootstrap resamples → retrained models → percentile summaries of
    every coefficient and metric; flags coefficients whose IQR straddles 0
    (BootstrapTraining.scala:131-180 + bootstrap diagnostic)."""
    if num_bootstrap_samples <= 1:
        raise ValueError(
            f"Number of bootstrap samples must be > 1, "
            f"got {num_bootstrap_samples}")
    if not 0.0 < portion_per_sample <= 1.0:
        raise ValueError(
            f"portion per bootstrap sample must be in (0, 1], "
            f"got {portion_per_sample}")

    rng = np.random.default_rng(seed)
    per_lambda: dict[float, list[tuple[np.ndarray, dict]]] = {}
    for _ in range(num_bootstrap_samples):
        size = int(round(portion_per_sample * num_samples))
        idx = rng.choice(num_samples, size=size, replace=True)
        for lam, (coef, metrics) in model_factory(
                idx, None, dict(warm_start or {})).items():
            per_lambda.setdefault(lam, []).append(
                (np.asarray(coef, np.float64), metrics))

    out: dict[float, BootstrapReport] = {}
    for lam, replicas in per_lambda.items():
        coef_matrix = np.stack([c for c, _ in replicas])  # [k, D]
        coef_summaries = [CoefficientSummary.from_samples(coef_matrix[:, j])
                          for j in range(coef_matrix.shape[1])]
        straddling = [j for j, s in enumerate(coef_summaries)
                      if s.q1 < 0.0 < s.q3]
        metric_names = sorted({m for _, ms in replicas for m in ms})
        metric_summaries = {
            m: CoefficientSummary.from_samples(
                np.asarray([ms[m] for _, ms in replicas if m in ms]))
            for m in metric_names}
        out[lam] = BootstrapReport(
            coefficient_summaries=coef_summaries,
            metric_summaries=metric_summaries,
            straddling_zero=straddling)
    return out

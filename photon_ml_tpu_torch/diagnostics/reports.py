"""Diagnostic report dataclasses.

Re-design of the reference's per-diagnostic report types (reference paths
under photon-ml/src/main/scala/com/linkedin/photon/ml/diagnostics/):
HosmerLemeshowReport (hl/), FeatureImportanceReport (featureimportance/),
KendallTauReport + PredictionErrorIndependenceReport (independence/),
FittingReport (fitting/), and BootstrapTraining's CoefficientSummary
(BootstrapTraining.scala:46-99).

A copy of ``photon_ml_tpu/diagnostics/reports.py`` (numpy and scipy only),
importing the port's own modules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CoefficientSummary:
    """Distribution summary of one scalar across bootstrap replicas."""

    min: float
    max: float
    mean: float
    std: float
    q1: float
    median: float
    q3: float

    @staticmethod
    def from_samples(x: np.ndarray) -> "CoefficientSummary":
        x = np.asarray(x, dtype=np.float64)
        q1, med, q3 = np.percentile(x, [25, 50, 75])
        return CoefficientSummary(
            min=float(x.min()), max=float(x.max()), mean=float(x.mean()),
            std=float(x.std(ddof=1)) if len(x) > 1 else 0.0,
            q1=float(q1), median=float(med), q3=float(q3))


@dataclasses.dataclass
class HosmerLemeshowBin:
    """One predicted-probability bin (hl/PredictedProbabilityVersus
    ObservedFrequencyHistogramBin analog)."""

    lower: float
    upper: float
    observed_pos: float
    observed_neg: float
    expected_pos: float
    expected_neg: float


@dataclasses.dataclass
class HosmerLemeshowReport:
    bins: list[HosmerLemeshowBin]
    chi_square: float
    degrees_of_freedom: int
    p_value: float
    messages: list[str]


@dataclasses.dataclass
class FeatureImportanceReport:
    importance_type: str  # "expected magnitude" | "variance"
    importance_description: str
    # (name, term) -> (index, importance); top MAX_RANKED_FEATURES
    feature_importance: dict[tuple[str, str], tuple[int, float]]
    # decile rank -> importance threshold
    rank_to_importance: dict[int, float]


@dataclasses.dataclass
class KendallTauReport:
    """independence/KendallTauReport analog."""

    concordant: int
    discordant: int
    ties_a: int
    ties_b: int
    num_items: int
    tau_alpha: float
    tau_beta: float
    z_alpha: float
    p_value: float
    message: str = ""


@dataclasses.dataclass
class PredictionErrorIndependenceReport:
    predictions: np.ndarray
    errors: np.ndarray
    kendall_tau: KendallTauReport


@dataclasses.dataclass
class FittingMetricCurve:
    portions: np.ndarray  # % of training data used
    train_values: np.ndarray
    test_values: np.ndarray


@dataclasses.dataclass
class FittingReport:
    """Learning curves per metric for one lambda (fitting/FittingReport)."""

    metrics: dict[str, FittingMetricCurve]
    message: str = ""


@dataclasses.dataclass
class BootstrapReport:
    """Per-lambda bootstrap aggregations (bootstrap/BootstrapReport)."""

    coefficient_summaries: list[CoefficientSummary]
    metric_summaries: dict[str, CoefficientSummary]
    # (name/index, summary) of coefficients whose CI straddles 0
    straddling_zero: list[int]


@dataclasses.dataclass
class SystemReport:
    """Model-independent preamble (reporting/reports/system): feature summary
    + run configuration."""

    summary_table: Optional[dict[str, np.ndarray]] = None
    params_summary: str = ""

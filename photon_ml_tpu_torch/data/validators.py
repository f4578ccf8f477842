"""Row-level data sanity checks per task type.

A copy of ``photon_ml_tpu/data/validators.py`` (``DataValidationType``
and ``sanity_check_data``; numpy and scipy only), importing the port's
``TaskType``. Re-design of the reference's validators
(reference: photon-ml/src/main/scala/com/linkedin/photon/ml/data/
DataValidators.scala:55-139 and DataValidationType.scala): per-task check
sets (finite labels/offsets/features, binary labels for classifiers,
non-negative labels for Poisson) with FULL / SAMPLE(~10%) / DISABLED modes.

Vectorized over the columnar dataset instead of per-row closures — one
numpy pass plays the role of the reference's RDD ``forall``. Failures are
reported with the check name and offending row indices (the analog of the
reference's per-item logError).
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import numpy as np
import scipy.sparse as sp

from photon_ml_tpu_torch.optimize.config import TaskType

# BinaryClassifier.{positive,negative}ClassLabel in the reference.
POSITIVE_CLASS_LABEL = 1.0
NEGATIVE_CLASS_LABEL = 0.0


class DataValidationType(enum.Enum):
    """data/DataValidationType.scala analog."""

    VALIDATE_FULL = "VALIDATE_FULL"
    VALIDATE_SAMPLE = "VALIDATE_SAMPLE"
    VALIDATE_DISABLED = "VALIDATE_DISABLED"


def _finite_mask(x: np.ndarray) -> np.ndarray:
    return np.isfinite(np.asarray(x, dtype=np.float64))


def finite_labels(labels, offsets, features) -> np.ndarray:
    return _finite_mask(labels)


def non_negative_labels(labels, offsets, features) -> np.ndarray:
    return np.asarray(labels) >= 0


def binary_labels(labels, offsets, features) -> np.ndarray:
    labels = np.asarray(labels)
    return (labels == POSITIVE_CLASS_LABEL) | (labels == NEGATIVE_CLASS_LABEL)


def finite_offsets(labels, offsets, features) -> np.ndarray:
    return _finite_mask(offsets)


def finite_features(labels, offsets, features) -> np.ndarray:
    """Per-row all-finite check over the stored (active) feature values."""
    if sp.issparse(features):
        csr = features.tocsr()
        bad = ~np.isfinite(csr.data)
        out = np.ones(csr.shape[0], dtype=bool)
        if bad.any():
            row_nnz = np.diff(csr.indptr)
            rows = np.repeat(np.arange(csr.shape[0]), row_nnz)
            out[np.unique(rows[bad])] = False
        return out
    return np.isfinite(np.asarray(features, np.float64)).all(axis=1)


Validator = Callable[[np.ndarray, np.ndarray, object], np.ndarray]

# Per-task check sets (DataValidators.scala:25-53). The SVM shares the
# logistic checks, matching sanityCheckData's task dispatch (:103-109).
_VALIDATORS_BY_TASK: dict[TaskType, dict[str, Validator]] = {
    TaskType.LINEAR_REGRESSION: {
        "Finite labels": finite_labels,
        "Finite features": finite_features,
        "Finite offsets": finite_offsets,
    },
    TaskType.LOGISTIC_REGRESSION: {
        "Binary labels": binary_labels,
        "Finite features": finite_features,
        "Finite offsets": finite_offsets,
    },
    TaskType.POISSON_REGRESSION: {
        "Finite labels": finite_labels,
        "Non-negative labels": non_negative_labels,
        "Finite features": finite_features,
        "Finite offsets": finite_offsets,
    },
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: {
        "Binary labels": binary_labels,
        "Finite features": finite_features,
        "Finite offsets": finite_offsets,
    },
}


def sanity_check_data(
        labels: np.ndarray,
        offsets: np.ndarray,
        features,
        task: TaskType,
        validation_type: DataValidationType = DataValidationType.VALIDATE_FULL,
        sample_fraction: float = 0.10,
        seed: int = 0,
        logger: Optional[Callable[[str], None]] = None) -> bool:
    """DataValidators.sanityCheckData analog. Returns True when the data
    passes; failures are reported through ``logger`` with the check name and
    up to 5 offending row indices."""
    if validation_type == DataValidationType.VALIDATE_DISABLED:
        if logger:
            logger("Data validation disabled.")
        return True

    labels = np.asarray(labels)
    offsets = (np.zeros(len(labels)) if offsets is None
               else np.asarray(offsets))
    idx = np.arange(len(labels))
    if validation_type == DataValidationType.VALIDATE_SAMPLE:
        if logger:
            logger("Doing a partial validation on ~10% of the training data")
        rng = np.random.default_rng(seed)
        idx = idx[rng.uniform(size=len(idx)) < sample_fraction]

    sub_features = features[idx] if len(idx) < len(labels) else features
    ok = True
    for name, validator in _VALIDATORS_BY_TASK[task].items():
        mask = validator(labels[idx], offsets[idx], sub_features)
        if not mask.all():
            ok = False
            if logger:
                bad = idx[~mask][:5]
                logger(f"Validation {name} failed on rows {bad.tolist()}")
    if not ok and logger:
        logger("Data validation failed.")
    return ok

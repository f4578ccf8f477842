"""Down-samplers for the fixed-effect coordinate, shapes kept static.

Port of ``photon_ml_tpu/sampler/samplers.py`` (``default_down_sample``,
``binary_classification_down_sample`` and ``down_sample``; reference:
DefaultDownSampler.scala:37, BinaryClassificationDownSampler.scala:36-61).
The batch keeps its shape and the sample is taken through its weights: a
dropped row gets weight 0 and a kept row (for the binary sampler, a kept
negative; positives always stay) gets ``w / rate``. The keep mask is
``uniform(key, weights.shape) < rate`` with the JAX package's bits
(``utils/prng.py``), so one key drops the same rows in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_tpu_torch.data.batch import DenseBatch
from photon_ml_tpu_torch.utils.prng import uniform

Tensor = torch.Tensor


def _check_rate(rate: float) -> None:
    if not 0.0 < rate < 1.0:
        raise ValueError(f"down-sampling rate must be in (0,1), got {rate}")


def _keep(key: np.ndarray, weights: Tensor, rate: float) -> Tensor:
    return uniform(key, weights.shape, weights.device) < rate


def _scaled(weights: Tensor, rate: float) -> Tensor:
    """``weights / rate`` as the JAX package computes it: XLA folds the
    division by the constant rate into a product with its reciprocal in
    the weights' dtype, and so does this, on every device."""
    one, r = (torch.tensor(v, dtype=weights.dtype) for v in (1.0, rate))
    return weights * (one / r).to(weights.device)


def default_down_sample(batch: DenseBatch, rate: float,
                        key: np.ndarray) -> DenseBatch:
    """Uniform down-sampling with 1/rate reweighting (DefaultDownSampler)."""
    _check_rate(rate)
    w = batch.weights
    return batch._replace(weights=torch.where(
        _keep(key, w, rate), _scaled(w, rate), torch.zeros_like(w)))


def binary_classification_down_sample(batch: DenseBatch, rate: float,
                                      key: np.ndarray) -> DenseBatch:
    """Keep positives, sample negatives at ``rate`` with 1/rate reweighting
    (BinaryClassificationDownSampler.scala:36-61)."""
    _check_rate(rate)
    w = batch.weights
    sampled = torch.where(_keep(key, w, rate), _scaled(w, rate),
                          torch.zeros_like(w))
    return batch._replace(weights=torch.where(batch.labels > 0.5, w,
                                              sampled))


def down_sample(batch: DenseBatch, rate: float, key: np.ndarray,
                is_classification: bool) -> DenseBatch:
    """Sampler dispatch (the DownSampler factory): a rate of 1 or more
    returns the batch unchanged."""
    if rate >= 1.0:
        return batch
    if is_classification:
        return binary_classification_down_sample(batch, rate, key)
    return default_down_sample(batch, rate, key)

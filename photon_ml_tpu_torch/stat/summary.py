"""Feature summary statistics: per-column mean, variance, extremes, norms.

Port of ``photon_ml_tpu/stat/summary.py`` (``BasicStatisticalSummary``
and ``summarize``; reference stat/BasicStatistics.scala:28-42). A dense
input is reduced on its device in one pass and fetched once; a scipy
sparse input is summarized from its structure with numpy ``bincount``
(``summary.py:82-114``), never densified: the implicit zeros count in the
mean, the unbiased (n - 1) variance and the extremes, as they do in the
dense form.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from photon_ml_tpu_torch.game.dataset import canonicalized_csr
from photon_ml_tpu_torch.utils.sync_telemetry import record_host_fetch


@dataclasses.dataclass(frozen=True)
class BasicStatisticalSummary:
    mean: np.ndarray
    variance: np.ndarray
    count: int
    num_nonzeros: np.ndarray
    max: np.ndarray
    min: np.ndarray
    norm_l1: np.ndarray
    norm_l2: np.ndarray
    mean_abs: np.ndarray

    @property
    def max_magnitude(self) -> np.ndarray:
        return np.maximum(np.abs(self.max), np.abs(self.min))


_FIELDS = ("mean", "variance", "num_nonzeros", "max", "min", "norm_l1",
           "norm_l2", "mean_abs")


def summarize(X, device=DEFAULT_DEVICE) -> BasicStatisticalSummary:
    """Per-column statistics of an ``[N, D]`` design matrix: a scipy
    sparse matrix on the host, anything else as f32 on ``device`` (a
    tensor stays on its own device)."""
    if sp.issparse(X):
        return _summarize_sparse(X.tocsr())
    if not isinstance(X, torch.Tensor):
        X = torch.as_tensor(np.asarray(X), device=resolve_device(device))
    X = X.to(torch.float32)
    n = X.shape[0]
    var = (torch.var(X, dim=0, correction=1) if n > 1
           else torch.zeros(X.shape[1], dtype=X.dtype, device=X.device))
    stats = torch.stack([
        X.mean(0), var, (X != 0.0).sum(0).to(torch.float32),
        X.amax(0), X.amin(0), X.abs().sum(0), torch.sqrt((X * X).sum(0)),
        X.abs().mean(0)])
    # every statistic comes back in this one fetch
    host = stats.cpu().numpy()
    record_host_fetch(site="stat.summary")
    return BasicStatisticalSummary(
        count=int(n), **{k: host[i] for i, k in enumerate(_FIELDS)})


def _summarize_sparse(csr) -> BasicStatisticalSummary:
    csr = canonicalized_csr(csr)  # duplicates sum, as in the dense form
    n, d = csr.shape
    data = np.asarray(csr.data, dtype=np.float64)
    s1 = np.bincount(csr.indices, weights=data, minlength=d)
    s2 = np.bincount(csr.indices, weights=data * data, minlength=d)
    l1 = np.bincount(csr.indices, weights=np.abs(data), minlength=d)
    mean = s1 / max(n, 1)
    # unbiased: sum((x - mean)^2) = s2 - n mean^2 over all n rows
    var = ((s2 - n * mean * mean) / (n - 1) if n > 1
           else np.zeros_like(mean))
    var = np.maximum(var, 0.0)
    # scipy's sparse max/min count the implicit zeros when nnz < n
    col_max = np.asarray(csr.max(axis=0).todense()).ravel()
    col_min = np.asarray(csr.min(axis=0).todense()).ravel()
    return BasicStatisticalSummary(
        mean=mean.astype(np.float32),
        variance=var.astype(np.float32),
        count=int(n),
        # stored zeros do not count, as X != 0 in the dense form
        num_nonzeros=np.bincount(csr.indices[data != 0],
                                 minlength=d).astype(np.float32),
        max=col_max.astype(np.float32),
        min=col_min.astype(np.float32),
        norm_l1=l1.astype(np.float32),
        norm_l2=np.sqrt(s2).astype(np.float32),
        mean_abs=(l1 / max(n, 1)).astype(np.float32),
    )

"""Device-resident dense batches of labeled GLM data.

Port of ``photon_ml_tpu/data/batch.py:37-79`` (``DenseBatch``) and ``:149``
(``dense_batch``). The JAX package vmaps its solvers over entities, so each
lane sees a 2-D batch; the port writes the entity axis out instead, and the
same methods take the 3-D ``[E, N, D]`` form (``labels``/``offsets``/
``weights`` ``[E, N]``, coefficients ``[E, D]``).

A 2-D batch goes through ``einsum`` (a matrix-vector product). A 3-D batch
is an elementwise product and a ``sum`` over the row's features (margins)
or over the entity's rows (the gradient's sum): a batched GEMM would let
cuBLAS pick its algorithm by the lane count, and on the H100 a lane's
margins then differ in the last bits between a dispatch of all lanes and
a compacted dispatch of a few, while the reduction's order per output does
not depend on the number of outputs. That keeps lane compaction bit-exact
(``game/random_effect.py``).
``EllBatch`` waits for a later slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device

Tensor = torch.Tensor


def acc_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """Accumulator dtype over data of ``dtype``: at least f32, never a
    downcast of f64 (``batch.py:49-55``)."""
    return torch.promote_types(dtype, torch.float32)


class DenseBatch(NamedTuple):
    """Columnar dense design matrix plus per-row metadata."""

    X: Tensor  # [N, D] or [E, N, D]
    labels: Tensor  # [N] or [E, N]
    offsets: Tensor
    weights: Tensor  # 0 for padded rows => they drop out of every sum

    @property
    def num_features(self) -> int:
        return self.X.shape[-1]

    @property
    def acc_dtype(self) -> torch.dtype:
        return acc_dtype_for(self.X.dtype)

    def _X_acc(self) -> Tensor:
        return self.X.to(self.acc_dtype)

    def margins(self, w_eff: Tensor, margin_shift: Tensor) -> Tensor:
        """x_i . w_eff + margin_shift + offset_i."""
        X, w = self._X_acc(), w_eff.to(self.acc_dtype)
        if X.dim() == 3:
            z = (X * w.unsqueeze(-2)).sum(-1)
        else:
            z = torch.einsum("nd,d->n", X, w)
        return z + margin_shift.unsqueeze(-1) + self.offsets

    def weighted_feature_sum(self, row_scalars: Tensor) -> Tensor:
        """sum_i row_scalars_i * x_i — the gradient's vector sum (X^T r)."""
        return _row_weighted_sum(self._X_acc(),
                                 row_scalars.to(self.acc_dtype))

    def hadamard_square_sum(self, row_scalars: Tensor) -> Tensor:
        """sum_i row_scalars_i * x_i**2 — Hessian-diagonal inner sum."""
        X = self._X_acc()
        return _row_weighted_sum(X * X, row_scalars.to(self.acc_dtype))


def _row_weighted_sum(X: Tensor, r: Tensor) -> Tensor:
    """sum over rows of r_i * x_i, per lane for a 3-D ``X``."""
    if X.dim() == 3:
        return (X * r.unsqueeze(-1)).sum(-2)
    return torch.einsum("nd,n->d", X, r)


def dense_batch(X: np.ndarray, labels: np.ndarray,
                offsets: Optional[np.ndarray] = None,
                weights: Optional[np.ndarray] = None,
                dtype: torch.dtype = torch.float32,
                device=DEFAULT_DEVICE) -> DenseBatch:
    """Batch from host arrays on ``device`` (the card unless the caller
    asks for the CPU; raises without CUDA); metadata is at least f32
    (``batch.py:149``)."""
    device = resolve_device(device)
    n = X.shape[0]
    meta = acc_dtype_for(dtype)
    return DenseBatch(
        X=torch.as_tensor(np.asarray(X), device=device).to(dtype),
        labels=torch.as_tensor(np.asarray(labels), device=device).to(meta),
        offsets=(torch.zeros(n, dtype=meta, device=device) if offsets is None
                 else torch.as_tensor(np.asarray(offsets),
                                      device=device).to(meta)),
        weights=(torch.ones(n, dtype=meta, device=device) if weights is None
                 else torch.as_tensor(np.asarray(weights),
                                      device=device).to(meta)),
    )

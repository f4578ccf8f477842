"""GAME models: fixed effect, random effect (raw, projected and factored),
matrix factorization, composite.

Port of ``photon_ml_tpu/game/models.py:51-299``. A random-effect model
loaded from disk carries its raw ``entity_ids`` and scores a dataset
through that dataset's own id vocabulary. Scoring stays on the host with
scipy's CSR products, as in the JAX package, and the result is handed back
as an f32 tensor on the requested device. A random effect scores in
O(nnz) (:func:`rowwise_sparse_dot_gathered`), where the JAX package builds
the dense ``[N, D_raw]`` coefficient rows; the scores are the same bit for
bit. A projected model maps back to raw space through its index maps or
its random projector (``:174-188``), a factored one through its latent
projection (``:257-265``). :class:`MatrixFactorizationModel` (``:195-236``)
scores on the device: a gather of each row's two factor rows and their
row-wise dot, unseen ids scoring 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.dataset import GameDataset
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.projector.projectors import (
    IndexMapProjectors,
    RandomProjector,
)

Tensor = torch.Tensor


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _on(device, a: np.ndarray) -> Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                           device=resolve_device(device))


def _match(keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Row in ``keys`` for each query (len(keys) where absent)."""
    e = len(keys)
    if e == 0 or len(queries) == 0:
        return np.full(len(queries), e, dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    pos = np.clip(np.searchsorted(sorted_keys, queries), 0, e - 1)
    found = sorted_keys[pos] == queries
    return np.where(found, order[pos], e)


def _codes_via_ids(ids: np.ndarray, vocab: np.ndarray,
                   codes: np.ndarray) -> np.ndarray:
    """Model row for each dataset row (dictionary ``codes`` into ``vocab``)
    matched by raw id, compared as python strings (``models.py:63-77``);
    len(ids) where the entity has no model."""
    ids_s = np.asarray([str(x) for x in np.asarray(ids).ravel()],
                       dtype=object)
    vocab_s = np.asarray([str(x) for x in np.asarray(vocab).ravel()],
                         dtype=object)
    return _match(ids_s, vocab_s[np.asarray(codes)])


def rowwise_sparse_dot(mat, w_rows: np.ndarray) -> np.ndarray:
    """Per-row ``sum_j x_ij w_ij`` for CSR ``mat`` against dense per-row
    coefficient rows ``w_rows`` (``models.py:80-90``)."""
    return np.asarray(mat.multiply(w_rows).sum(axis=1)).ravel()


def rowwise_sparse_dot_gathered(mat, table: np.ndarray,
                                local: np.ndarray) -> np.ndarray:
    """:func:`rowwise_sparse_dot` against ``table[local]`` in O(nnz): the
    coefficient is gathered at each stored entry and the products summed
    per row in CSR storage order, the order of the dense form's sum, so
    the result is the same bit for bit without the ``[N, D]`` array."""
    if table.shape[1] != mat.shape[1]:
        raise ValueError(f"inconsistent shapes: {mat.shape} rows against "
                         f"coefficients of width {table.shape[1]}")
    row_of = np.repeat(np.arange(mat.shape[0]), np.diff(mat.indptr))
    prod = mat.data * table[local[row_of], mat.indices]
    summed = sp.csr_matrix((prod, mat.indices, mat.indptr), shape=mat.shape)
    return summed @ np.ones(mat.shape[1], dtype=prod.dtype)


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """GLM over one feature shard."""

    model: GeneralizedLinearModel
    feature_shard_id: str

    def score(self, data: GameDataset, device="cuda") -> Tensor:
        mat = data.feature_shards[self.feature_shard_id]
        return _on(device, mat @ _host(self.model.coefficients.means))

    @property
    def coefficients(self) -> Coefficients:
        return self.model.coefficients


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    """Per-entity coefficient block in RAW shard space; rows of unseen
    entities score 0 (cold start). ``entity_ids`` (the raw id per block
    row) is set on models loaded from disk: they match rows by raw id
    through the dataset's vocabulary instead of by dataset code."""

    random_effect_type: str
    feature_shard_id: str
    entity_codes: np.ndarray
    coefficients: Tensor  # [E, D_raw]
    entity_ids: Optional[np.ndarray] = None

    def _lookup(self, data: GameDataset) -> np.ndarray:
        """Coefficient row of each dataset row (E, a zero row, where the
        entity has no model): by raw id for a model read from disk, else
        by dataset code (``models.py:137-145``)."""
        codes = data.id_columns[self.random_effect_type]
        if self.entity_ids is not None:
            return _codes_via_ids(self.entity_ids,
                                  data.id_vocabs[self.random_effect_type],
                                  codes)
        return _match(self.entity_codes, codes)

    def score(self, data: GameDataset, device="cuda") -> Tensor:
        coefs = _host(self.coefficients)
        if coefs.shape[0] == 0:
            return _on(device, np.zeros(data.num_samples))
        mat = data.feature_shards[self.feature_shard_id]
        padded = np.vstack([coefs, np.zeros((1, coefs.shape[1]),
                                            dtype=coefs.dtype)])
        return _on(device, rowwise_sparse_dot_gathered(
            mat, padded, self._lookup(data)))


@dataclasses.dataclass(frozen=True)
class RandomEffectModelInProjectedSpace:
    """Coefficients in each entity's reduced space + the projector back to
    raw space (``to_raw``): the index maps, the random projector, or
    neither (identity)."""

    random_effect_type: str
    feature_shard_id: str
    entity_codes: np.ndarray
    coefficients_projected: Tensor  # [E, D_red]
    projectors: Optional[IndexMapProjectors] = None
    random_projector: Optional[RandomProjector] = None

    def to_raw(self) -> RandomEffectModel:
        proj = _host(self.coefficients_projected)
        if self.projectors is not None:
            dense = self.projectors.scatter_coefficients(proj).dense()
        elif self.random_projector is not None:
            dense = self.random_projector.project_back(proj)
        else:
            dense = proj
        return RandomEffectModel(
            random_effect_type=self.random_effect_type,
            feature_shard_id=self.feature_shard_id,
            entity_codes=self.entity_codes,
            coefficients=torch.from_numpy(np.ascontiguousarray(dense)))

    def score(self, data: GameDataset, device="cuda") -> Tensor:
        return self.to_raw().score(data, device=device)


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectModel:
    """Per-entity coefficients in a learned latent space + the shared
    latent-to-raw projection: raw coefficients are ``coefs @ B``."""

    random_effect_type: str
    feature_shard_id: str
    entity_codes: np.ndarray
    coefficients_latent: Tensor  # [E, K]
    projection: Tensor  # [K, D_raw]

    def to_raw(self) -> RandomEffectModel:
        dense = _host(self.coefficients_latent) @ _host(self.projection)
        return RandomEffectModel(
            random_effect_type=self.random_effect_type,
            feature_shard_id=self.feature_shard_id,
            entity_codes=self.entity_codes,
            coefficients=torch.from_numpy(np.ascontiguousarray(dense)))

    def score(self, data: GameDataset, device="cuda") -> Tensor:
        return self.to_raw().score(data, device=device)


@dataclasses.dataclass(frozen=True)
class MatrixFactorizationModel:
    """Latent row and column factor tables; a row scores
    ``rowFactor . colFactor`` of its two entities
    (MatrixFactorizationModel.scala:50,141). ``row_ids``/``col_ids`` (the
    raw id of each factor row, set on models read from disk) match rows
    through the dataset's vocabularies; without them the tables are
    indexed by the dataset's codes. An id without a factor row scores 0."""

    row_effect_type: str
    col_effect_type: str
    row_factors: Tensor  # [R, K]
    col_factors: Tensor  # [C, K]
    row_ids: Optional[np.ndarray] = None
    col_ids: Optional[np.ndarray] = None

    @property
    def num_latent_factors(self) -> int:
        return int(self.row_factors.shape[1])

    def score(self, data: GameDataset, device="cuda") -> Tensor:
        device = resolve_device(device)

        def table_rows(effect_type, ids, table):
            # the table's length (its padded zero row) where the id has
            # no factors
            codes = np.asarray(data.id_columns[effect_type])
            if ids is not None:
                codes = _codes_via_ids(ids, data.id_vocabs[effect_type],
                                       codes)
            size = int(table.shape[0])
            return torch.as_tensor(np.where(codes < size, codes, size),
                                   device=device)

        return score_factors(
            self.row_factors, self.col_factors,
            table_rows(self.row_effect_type, self.row_ids, self.row_factors),
            table_rows(self.col_effect_type, self.col_ids, self.col_factors))


def score_factors(row_factors, col_factors, rows: Tensor, cols: Tensor
                  ) -> Tensor:
    """``sum_k rf[rows, k] * cf[cols, k]`` on ``rows``' device, with the
    index one past each table reading a zero row."""
    def padded(t):
        t = torch.as_tensor(t, dtype=torch.float32, device=rows.device)
        return torch.cat([t, t.new_zeros((1, t.shape[1]))])

    return (padded(row_factors)[rows] * padded(col_factors)[cols]).sum(-1)


@dataclasses.dataclass
class GameModel:
    """coordinateId -> model; total score = sum of coordinate scores."""

    models: dict

    def score(self, data: GameDataset, device="cuda") -> Tensor:
        device = resolve_device(device)
        total = torch.zeros(data.num_samples, dtype=torch.float32,
                            device=device)
        for m in self.models.values():
            total = total + m.score(data, device=device)
        return total

    @property
    def coordinate_ids(self) -> list[str]:
        return list(self.models)

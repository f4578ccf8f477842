"""GAME data layer: columnar dataset, fixed-effect batch, entity blocks.

Port of ``photon_ml_tpu/game/dataset.py`` — ``GameDataset`` (``:59-114``),
``csr_to_batch`` and ``build_fixed_effect_dataset`` (``:153-185``; a
shard over ``dense_threshold`` columns becomes an ``EllBatch``),
``balanced_entity_order`` (``:193-234``),
``RandomEffectDataConfiguration`` with its CLI ``parse`` (``:243-313``),
``FixedEffectDataConfiguration`` (``:316-329``), the in-RAM
``build_random_effect_dataset`` (``:333-978``) with its three projections
(the choice at ``:885-900``): INDEX_MAP, RANDOM (the shared Gaussian
matrix of ``projector/projectors.py``, applied to each row on the host,
``:711-712``) and IDENTITY (the raw shard densified in row chunks,
``:465``, ``:713-714``; what the factored coordinate needs), and
``(N, D)`` entity bucketing; ``_PairStatsAccumulator`` (``:503-616``),
``_alloc_rows``, ``build_random_effect_dataset_streamed`` and
``dataset_row_stream`` (``:981-1316``) for one entity-axis shard. The
host-side grouping, reservoir split, projector build and packing are
numpy, identical to the JAX package's; index-map rows are packed by the
host library's ``photon_pack_projected_rows``
(``csrc/host/block_packer.cpp``, ``_fill_feature_rows`` ``:685-716``),
and ``native_pack=False`` packs them by the numpy ``_project_nnz``
scatter instead, the plain version (equal array for array). Only the
device commit differs: blocks become torch tensors on the requested
device. With ``blocks_dir`` the streamed builder's bucket and passive
feature blocks stay ``np.memmap`` files on the host, and the solver and
the scorer (``game/random_effect.py``) copy one at a time to the device;
the other block arrays (labels, offsets, weights, row ids) are small
and go to the device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.data.batch import (
    Batch,
    DenseBatch,
    canonicalized_csr,
    ell_from_csr,
)
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.io.native_loader import pack_projected_rows_native
from photon_ml_tpu_torch.projector.projectors import (
    IndexMapProjectors,
    ProjectorConfig,
    ProjectorType,
    RandomProjector,
    build_random_projector,
)

Tensor = torch.Tensor

DENSE_FEATURE_THRESHOLD = 4096
#: a random-effect block's reduced feature width is padded to a multiple
#: of this (the JAX package's ``pad_dim_multiple`` default)
PAD_DIM_MULTIPLE = 8


@dataclasses.dataclass
class GameDataset:
    """Columnar GAME dataset (host side): responses/offsets/weights, one CSR
    per feature shard, dictionary-encoded entity id columns, and the raw
    uid strings when the records carry them."""

    responses: np.ndarray
    feature_shards: dict
    offsets: Optional[np.ndarray] = None
    weights: Optional[np.ndarray] = None
    id_columns: dict = dataclasses.field(default_factory=dict)
    id_vocabs: dict = dataclasses.field(default_factory=dict)
    uids: Optional[np.ndarray] = None

    def __post_init__(self):
        n = len(self.responses)
        self.responses = np.asarray(self.responses, dtype=np.float64)
        if self.offsets is None:
            self.offsets = np.zeros(n)
        if self.weights is None:
            self.weights = np.ones(n)
        for name, mat in list(self.feature_shards.items()):
            if not sp.issparse(mat):
                mat = sp.csr_matrix(np.asarray(mat))
            else:
                mat = mat.tocsr()
            self.feature_shards[name] = canonicalized_csr(mat)

    @property
    def num_samples(self) -> int:
        return len(self.responses)

    def encode_ids(self, id_type: str, raw_ids: np.ndarray) -> None:
        vocab, codes = np.unique(np.asarray(raw_ids), return_inverse=True)
        self.id_columns[id_type] = codes.astype(np.int64)
        self.id_vocabs[id_type] = vocab

    def recode_ids(self, id_type: str, vocab: np.ndarray) -> None:
        """Re-encode an id column against another dataset's ``vocab``:
        ids found there take its codes, the others follow in sorted order
        from ``len(vocab)`` on. A model trained on that dataset then scores
        these rows by code."""
        raw = np.asarray(self.id_vocabs[id_type]).astype(str)[
            self.id_columns[id_type]]
        known = np.asarray(vocab).astype(str)
        extra = np.setdiff1d(raw, known)
        full = np.concatenate([known, extra])
        order = np.argsort(full, kind="stable")
        self.id_columns[id_type] = order[
            np.searchsorted(full[order], raw)].astype(np.int64)
        self.id_vocabs[id_type] = np.concatenate(
            [np.asarray(vocab, dtype=object), extra.astype(object)])


def _to_device(a: np.ndarray, device, dtype=None) -> Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


# ---------------------------------------------------------------------------
# Fixed-effect view
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FixedEffectDataset:
    """Device batch (dense or ELL) over the full sample axis for one
    feature shard."""

    shard_id: str
    batch: Batch
    base_offsets: Tensor

    @property
    def num_samples(self) -> int:
        return int(self.batch.labels.shape[0])

    def with_offsets(self, extra_scores: Tensor) -> Batch:
        """Batch whose offsets = data offsets + other coordinates' scores."""
        return self.batch._replace(offsets=self.base_offsets + extra_scores)


def csr_to_batch(mat, labels, offsets, weights, dtype=torch.float32,
                 dense_threshold: int = DENSE_FEATURE_THRESHOLD,
                 device="cuda") -> Batch:
    """Device batch from a CSR shard (``dataset.py:153-172``): dense up to
    ``dense_threshold`` columns, ELL above (its pack needs the canonical
    form: a duplicated cell would split across slots and corrupt the
    Hessian diagonal's squares)."""
    device = resolve_device(device)
    if mat.shape[1] > dense_threshold:
        return ell_from_csr(canonicalized_csr(mat), labels, offsets,
                            weights, dtype=dtype, device=device)
    f32 = torch.float32
    return DenseBatch(
        X=_to_device(mat.toarray(), device, dtype),
        labels=_to_device(np.asarray(labels), device, f32),
        offsets=_to_device(np.asarray(offsets), device, f32),
        weights=_to_device(np.asarray(weights), device, f32),
    )


def build_fixed_effect_dataset(data: GameDataset, shard_id: str,
                               dtype=torch.float32,
                               dense_threshold: int = DENSE_FEATURE_THRESHOLD,
                               device="cuda") -> FixedEffectDataset:
    device = resolve_device(device)
    batch = csr_to_batch(data.feature_shards[shard_id], data.responses,
                         data.offsets, data.weights, dtype=dtype,
                         dense_threshold=dense_threshold, device=device)
    return FixedEffectDataset(shard_id=shard_id, batch=batch,
                              base_offsets=batch.offsets)


# ---------------------------------------------------------------------------
# Load-balanced entity partitioning
# ---------------------------------------------------------------------------


def balanced_entity_order(counts: np.ndarray, num_bins: int,
                          capacity: int = 10000) -> np.ndarray:
    """Greedy bin-pack entities by sample count into contiguous,
    load-balanced slices (``dataset.py:193-234``)."""
    import heapq

    e = len(counts)
    if e == 0:
        return np.zeros(0, dtype=np.int64)
    order = np.argsort(-counts, kind="stable")
    heavy = order[: min(capacity, e)]
    tail = order[min(capacity, e):]
    cap = -(-e // num_bins)
    bins: list[list[int]] = [[] for _ in range(num_bins)]
    heap = [(0, b) for b in range(num_bins)]
    heapq.heapify(heap)
    for ent in heavy:
        spill = []
        while True:
            load, b = heapq.heappop(heap)
            if len(bins[b]) < cap:
                break
            spill.append((load, b))
        bins[b].append(int(ent))
        heapq.heappush(heap, (load + int(counts[ent]), b))
        for item in spill:
            heapq.heappush(heap, item)
    for ent in tail:
        b = int(ent) % num_bins
        if len(bins[b]) >= cap:
            b = min(range(num_bins), key=lambda i: len(bins[i]))
        bins[b].append(int(ent))
    return np.concatenate([np.asarray(b, dtype=np.int64) for b in bins])


# ---------------------------------------------------------------------------
# Random-effect view
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FixedEffectDataConfiguration:
    """data/FixedEffectDataConfiguration.scala:23 —
    ``shardId[,minPartitions]``."""

    feature_shard_id: str
    min_num_partitions: int = 1

    @staticmethod
    def parse(s: str) -> "FixedEffectDataConfiguration":
        parts = [p.strip() for p in s.split(",")]
        return FixedEffectDataConfiguration(
            feature_shard_id=parts[0],
            min_num_partitions=int(parts[1]) if len(parts) > 1 else 1)


@dataclasses.dataclass(frozen=True)
class RandomEffectDataConfiguration:
    """Per-coordinate data knobs (``dataset.py:242-262``).

    CLI string (data/RandomEffectDataConfiguration.scala:80):
    ``idType,featureShardId,numPartitions[,activeBound[,passiveBound
    [,featuresToSamplesRatio[,projector]]]]`` with ``-``/``none`` meaning
    unset and a negative bound meaning unbounded.
    """

    random_effect_type: str
    feature_shard_id: str
    num_partitions: int = 1
    num_active_data_points_upper_bound: Optional[int] = None
    num_passive_data_points_lower_bound: Optional[int] = None
    num_features_to_samples_ratio_upper_bound: Optional[float] = None
    num_features_to_keep_upper_bound: Optional[int] = None
    projector: ProjectorConfig = ProjectorConfig(ProjectorType.INDEX_MAP)

    @staticmethod
    def parse(s: str) -> "RandomEffectDataConfiguration":
        parts = [p.strip() for p in s.split(",")]
        if len(parts) < 3:
            raise ValueError(
                f"random-effect data config needs at least idType,shard,"
                f"numPartitions: {s!r}")

        def unset(i):
            return i >= len(parts) or parts[i] in ("", "-", "none", "None")

        def opt(i, kind):
            if unset(i):
                return None
            v = kind(parts[i])
            return None if v < 0 else v

        proj = ProjectorConfig(ProjectorType.INDEX_MAP)
        if len(parts) > 6 and parts[6] not in ("", "-", "none"):
            proj = ProjectorConfig.parse(parts[6])
        return RandomEffectDataConfiguration(
            random_effect_type=parts[0],
            feature_shard_id=parts[1],
            num_partitions=int(parts[2]),
            num_active_data_points_upper_bound=opt(3, int),
            num_passive_data_points_lower_bound=opt(4, int),
            num_features_to_samples_ratio_upper_bound=opt(5, float),
            projector=proj)


@dataclasses.dataclass
class EntityBucket:
    """One (N, D)-homogeneous slice of the entity axis (``dataset.py:
    332-358``): bucket row ``i < num_real`` is global entity
    ``entity_start + i``; padded rows have weight 0 and row id N. ``X``
    is a device tensor, or an ``np.memmap`` on the host when the streamed
    builder had a ``blocks_dir``. A bucket built for one process of a
    gang (``entity_shard``) holds the rows ``[local_entity_offset,
    local_entity_offset + E_b / K)`` of the bucket's padded entity axis."""

    entity_start: int
    num_real: int
    X: object  # [E_b, N_b, D_b]
    labels: Tensor  # [E_b, N_b]
    base_offsets: Tensor
    weights: Tensor  # 0 = padding
    row_ids: Tensor  # [E_b, N_b] int64 (num_samples = discard slot)
    local_entity_offset: int = 0


@dataclasses.dataclass
class RandomEffectDataset:
    """Entity-major active blocks + sample-major passive rows
    (``dataset.py:361-444``). With ``num_buckets > 1`` the single block
    ``X/labels/...`` is ``None`` and ``buckets`` holds the blocks; the
    global coefficient block stays compact ``[num_entities, reduced_dim]``
    in bucket-major entity order."""

    config: RandomEffectDataConfiguration
    entity_codes: np.ndarray
    X: Optional[Tensor]
    labels: Optional[Tensor]
    base_offsets: Optional[Tensor]
    weights: Optional[Tensor]
    row_ids: Optional[Tensor]
    num_samples: int
    projectors: Optional[IndexMapProjectors] = None
    random_projector: Optional[RandomProjector] = None
    passive_X: object = None  # [P, D_red]: device tensor or np.memmap
    passive_entity: Optional[Tensor] = None
    passive_row_ids: Optional[Tensor] = None
    passive_offsets: Optional[Tensor] = None
    buckets: Optional[list] = None
    _reduced_dim: Optional[int] = None
    #: where the blocks are solved and scored (host feature blocks are
    #: copied there one at a time)
    device: Optional[torch.device] = None
    #: the dtype host feature blocks (f32 memmaps) take on that device:
    #: ``--precision``'s storage dtype applies when a block is paged in
    storage_dtype: torch.dtype = torch.float32
    #: ``(k, K)``: the blocks are the k-th of K contiguous slices of the
    #: entity axis, one per process of a gang (``entity_shard`` of the
    #: streamed builder); the solver and the score exchange gather the
    #: slices over the default mesh's process-spanning entity axis
    entity_shard: tuple = (0, 1)
    #: the single block's first row on the whole entity axis (a sliced
    #: single block; a bucket carries its own)
    local_entity_offset: int = 0

    @property
    def num_entities(self) -> int:
        if self.buckets is not None:
            return sum(b.num_real for b in self.buckets)
        return int(self.X.shape[0]) * int(self.entity_shard[1])

    @property
    def reduced_dim(self) -> int:
        if self.buckets is not None:
            return int(self._reduced_dim)
        return int(self.X.shape[2])

    @property
    def num_passive(self) -> int:
        return 0 if self.passive_X is None else int(self.passive_X.shape[0])

    def offsets_with(self, extra_scores: Tensor):
        """Per-block training offsets (base + other coordinates' scores):
        one ``[E, N_max]`` tensor, or a list per bucket."""
        padded = torch.cat([extra_scores, extra_scores.new_zeros(1)])
        if self.buckets is None:
            return self.base_offsets + padded[self.row_ids]
        return [b.base_offsets + padded[b.row_ids] for b in self.buckets]


def _topk_per_segment(seg: np.ndarray, score: np.ndarray,
                      limit: np.ndarray) -> np.ndarray:
    """Mask keeping the ``limit[seg]`` highest-``score`` items of each
    segment (stable; ``dataset.py:447-461``)."""
    order = np.lexsort((-score, seg))
    seg_sorted = seg[order]
    boundaries = np.flatnonzero(np.diff(seg_sorted)) + 1
    starts = np.concatenate([[0], boundaries])
    seg_sizes = np.diff(np.concatenate([starts, [len(seg)]]))
    rank = np.arange(len(seg)) - np.repeat(starts, seg_sizes)
    keep_sorted = rank < limit[seg_sorted]
    mask = np.zeros(len(seg), dtype=bool)
    mask[order] = keep_sorted
    return mask


def _project_nnz(sub: sp.csr_matrix, entity_of_row: np.ndarray,
                 projectors: IndexMapProjectors
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reduced column of every stored element of ``sub`` via one
    ``searchsorted`` over the (entity, raw column) table
    (``dataset.py:475-500``). Returns ``(row_of_nnz, reduced_col, valid)``."""
    lens = np.diff(sub.indptr)
    row_of = np.repeat(np.arange(sub.shape[0]), lens)
    ent = np.asarray(entity_of_row, dtype=np.int64)[row_of]
    d_red = projectors.max_reduced_dim
    stride = projectors.raw_dim + 1
    e = projectors.num_entities
    table = (np.arange(e, dtype=np.int64)[:, None] * stride
             + projectors.raw_indices.astype(np.int64)).ravel()
    keys = ent * stride + sub.indices
    pos = np.searchsorted(table, keys)
    pos_clip = np.minimum(pos, len(table) - 1)
    valid = table[pos_clip] == keys
    j = pos_clip - ent * d_red
    return row_of, j, valid


def _build_index_map_projectors(sub: sp.csr_matrix,
                                entity_of_row: np.ndarray,
                                act_counts: np.ndarray, labels: np.ndarray,
                                raw_dim: int,
                                config: RandomEffectDataConfiguration,
                                pad_to_multiple: int = PAD_DIM_MULTIPLE
                                ) -> IndexMapProjectors:
    """Per-entity feature unions + optional |Pearson| top-k selection over
    the active rows — the single-chunk ``_PairStatsAccumulator.add`` +
    ``finalize`` of ``dataset.py:503-634``."""
    e_real = len(act_counts)
    lens = np.diff(sub.indptr)
    row_of = np.repeat(np.arange(sub.shape[0]), lens)
    ent = np.asarray(entity_of_row, dtype=np.int64)[row_of]
    keys = ent * raw_dim + sub.indices
    pairs, inv = np.unique(keys, return_inverse=True)
    pair_ent = (pairs // raw_dim).astype(np.int64)
    pair_col = (pairs % raw_dim).astype(np.int32)

    limits = _keep_limits(config, e_real, act_counts)
    if limits is not None:
        v = sub.data.astype(np.float64)
        y = np.asarray(labels, dtype=np.float64)
        s1 = np.bincount(inv, weights=v, minlength=len(pairs))
        s2 = np.bincount(inv, weights=v * v, minlength=len(pairs))
        sxy = np.bincount(inv, weights=v * y[row_of], minlength=len(pairs))
        ent_rows = np.asarray(entity_of_row, dtype=np.int64)
        sy1 = np.bincount(ent_rows, weights=y, minlength=e_real)
        sy2 = np.bincount(ent_rows, weights=y * y, minlength=e_real)
        pair_ent, pair_col = _top_pearson_pairs(
            pair_ent, pair_col, (s1, s2, sxy), (sy1, sy2), act_counts,
            limits)
    return _projectors_from_pairs(pair_ent, pair_col, e_real, raw_dim,
                                  pad_to_multiple)


class _PairStatsAccumulator:
    """Streamed per-(entity, feature) moments for the index-map projector
    build (``dataset.py:503-616``): feed chunks of ACTIVE rows through
    :meth:`add`; the state is the sorted distinct (entity, feature) keys
    with their summed moments (Σx, Σx², Σxy) and the per-entity label
    sums, so memory grows with the projector table, not with the rows.
    :meth:`finalize` gives the projectors ``_build_index_map_projectors``
    gives on the same rows, array for array."""

    def __init__(self, raw_dim: int, e_real: int, with_moments: bool):
        self.raw_dim = raw_dim
        self.e_real = e_real
        self.with_moments = with_moments
        self.keys = np.zeros(0, np.int64)
        self.s1 = np.zeros(0)
        self.s2 = np.zeros(0)
        self.sxy = np.zeros(0)
        self.sy1 = np.zeros(e_real)
        self.sy2 = np.zeros(e_real)

    def add(self, sub: sp.csr_matrix, entity_of_row: np.ndarray,
            labels: np.ndarray) -> None:
        """Absorb one chunk of active rows (CSR, their entity indices and
        labels)."""
        lens = np.diff(sub.indptr)
        row_of = np.repeat(np.arange(sub.shape[0]), lens)
        ent = np.asarray(entity_of_row, dtype=np.int64)[row_of]
        keys = ent * self.raw_dim + sub.indices
        pairs, inv = np.unique(keys, return_inverse=True)
        if self.with_moments:
            v = sub.data.astype(np.float64)
            y = np.asarray(labels, dtype=np.float64)
            s1 = np.bincount(inv, weights=v, minlength=len(pairs))
            s2 = np.bincount(inv, weights=v * v, minlength=len(pairs))
            sxy = np.bincount(inv, weights=v * y[row_of],
                              minlength=len(pairs))
            ent_rows = np.asarray(entity_of_row, dtype=np.int64)
            self.sy1 += np.bincount(ent_rows, weights=y,
                                    minlength=self.e_real)
            self.sy2 += np.bincount(ent_rows, weights=y * y,
                                    minlength=self.e_real)
        else:
            s1 = s2 = sxy = np.zeros(len(pairs))
        if len(self.keys):
            # merge into the running sorted key set
            merged, minv = np.unique(np.concatenate([self.keys, pairs]),
                                     return_inverse=True)
            self.s1, self.s2, self.sxy = (
                np.bincount(minv, weights=np.concatenate([old, new]),
                            minlength=len(merged))
                for old, new in ((self.s1, s1), (self.s2, s2),
                                 (self.sxy, sxy)))
            self.keys = merged
        else:
            self.keys, self.s1, self.s2, self.sxy = pairs, s1, s2, sxy

    def finalize(self, act_counts: np.ndarray,
                 config: "RandomEffectDataConfiguration",
                 pad_to_multiple: int = PAD_DIM_MULTIPLE
                 ) -> IndexMapProjectors:
        """Per-entity feature unions + optional |Pearson| top-k selection
        over the accumulated moments (``dataset.py:579-616``)."""
        pair_ent = (self.keys // self.raw_dim).astype(np.int64)
        pair_col = (self.keys % self.raw_dim).astype(np.int32)
        limits = _keep_limits(config, self.e_real, act_counts)
        if limits is not None:
            pair_ent, pair_col = _top_pearson_pairs(
                pair_ent, pair_col, (self.s1, self.s2, self.sxy),
                (self.sy1, self.sy2), act_counts, limits)
        return _projectors_from_pairs(pair_ent, pair_col, self.e_real,
                                      self.raw_dim, pad_to_multiple)


def _keep_limits(config: "RandomEffectDataConfiguration", e_real: int,
                 act_counts: np.ndarray) -> Optional[np.ndarray]:
    """Per-entity feature keep limits; None when nothing is capped."""
    if config.num_features_to_keep_upper_bound is not None:
        return np.full(e_real, config.num_features_to_keep_upper_bound,
                       dtype=np.int64)
    if config.num_features_to_samples_ratio_upper_bound is not None:
        return np.ceil(config.num_features_to_samples_ratio_upper_bound
                       * act_counts).astype(np.int64)
    return None


def _top_pearson_pairs(pair_ent: np.ndarray, pair_col: np.ndarray,
                       x_moments: tuple, y_moments: tuple,
                       act_counts: np.ndarray, limits: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
    """The ``limits[e]`` pairs of each entity with the highest
    |Pearson(feature, label)| from the sparse moments (Σx, Σx², Σxy per
    pair; Σy, Σy² per entity; zeros count through the entity's row
    count), back in (entity, column) order."""
    s1, s2, sxy = x_moments
    sy1, sy2 = y_moments
    k_e = np.maximum(act_counts, 1).astype(np.float64)
    ym = sy1 / k_e
    y_sd = np.sqrt(np.maximum(sy2 / k_e - ym * ym, 0.0))
    ke_p = k_e[pair_ent]
    xm = s1 / ke_p
    cov = sxy / ke_p - xm * ym[pair_ent]
    var_x = np.maximum(s2 / ke_p - xm * xm, 0.0)
    denom = np.sqrt(var_x) * y_sd[pair_ent]
    corr = np.where(denom > 0,
                    np.abs(cov) / np.where(denom > 0, denom, 1.0), 0.0)
    keep = _topk_per_segment(pair_ent, corr, limits)
    pair_ent, pair_col = pair_ent[keep], pair_col[keep]
    reorder = np.lexsort((pair_col, pair_ent))
    return pair_ent[reorder], pair_col[reorder]


def _projectors_from_pairs(pair_ent: np.ndarray, pair_col: np.ndarray,
                           e_real: int, raw_dim: int,
                           pad_to_multiple: int) -> IndexMapProjectors:
    """Index-map projectors from the kept (entity, column) pairs in
    (entity, column) order: each entity's columns ascending, padded with
    the sentinel ``raw_dim``."""
    reduced_dims = np.bincount(pair_ent, minlength=e_real).astype(np.int32)
    d_red = int(reduced_dims.max()) if e_real else 1
    d_red = max(1, -(-max(d_red, 1) // pad_to_multiple) * pad_to_multiple)
    raw_indices = np.full((e_real, d_red), raw_dim, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(reduced_dims)[:-1]])
    slot = np.arange(len(pair_ent)) - starts[pair_ent]
    raw_indices[pair_ent, slot] = pair_col
    return IndexMapProjectors(raw_indices, reduced_dims, raw_dim)


def _bucket_plan(counts: np.ndarray, num_buckets: int, multiple: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Padded-area-optimal bucketing of entities by active-row count
    (``dataset.py:637-682``); returns ``(bucket_n_max desc, bucket_of)``."""
    counts = np.asarray(counts, dtype=np.int64)
    q = np.maximum(multiple, -(-counts // multiple) * multiple)
    uniq, w = np.unique(q, return_counts=True)
    uniq, w = uniq[::-1], w[::-1].astype(np.int64)
    m = len(uniq)
    k = min(num_buckets, m)
    if k >= m:
        return uniq, np.searchsorted(-uniq, -q)
    prefix = np.concatenate([[0], np.cumsum(w)])
    inf = np.iinfo(np.int64).max // 4
    f = np.full((m + 1, k + 1), inf, dtype=np.int64)
    arg = np.zeros((m + 1, k + 1), dtype=np.int64)
    f[0, 0] = 0
    for t in range(1, k + 1):
        for j in range(t, m + 1):
            cand = f[:j, t - 1] + uniq[:j] * (prefix[j] - prefix[:j])
            i = int(np.argmin(cand))
            f[j, t], arg[j, t] = cand[i], i
    cuts = []
    j = m
    for t in range(k, 0, -1):
        i = int(arg[j, t])
        cuts.append(i)
        j = i
    cuts = cuts[::-1]
    n_max = uniq[np.asarray(cuts)]
    seg_of_size = np.zeros(m, dtype=np.int64)
    for b, start in enumerate(cuts):
        seg_of_size[start:] = b
    return n_max, seg_of_size[np.searchsorted(-uniq, -q)]


@dataclasses.dataclass
class _ReservoirSplit:
    """The rows grouped by entity in (entity, random key) order, and the
    active / passive split under the configuration's bounds."""

    order: np.ndarray  # dataset rows in sorted order
    uniq: np.ndarray  # entity codes, ascending
    grp_of_sorted: np.ndarray  # entity index of each sorted row
    pos_in_group: np.ndarray  # a sorted row's rank within its entity
    active_mask: np.ndarray  # over sorted rows
    passive_mask: np.ndarray
    act_counts: np.ndarray  # active rows per entity
    group_scale: np.ndarray  # rows / active rows per entity


def _reservoir_split(codes: np.ndarray,
                     config: "RandomEffectDataConfiguration",
                     seed: int) -> _ReservoirSplit:
    """Group + reservoir split (``dataset.py:828-858``): rows ordered by
    (entity, random key), so the first ``cap`` rows of each group are a
    uniform sample; the same seed gives the same split in both
    builders."""
    n = len(codes)
    order = np.lexsort((np.random.default_rng(seed).random(n), codes))
    uniq, starts, group_sizes = np.unique(
        codes[order], return_index=True, return_counts=True)
    grp_of_sorted = np.repeat(np.arange(len(uniq)), group_sizes)
    pos_in_group = np.arange(n) - starts[grp_of_sorted]
    cap = config.num_active_data_points_upper_bound
    if cap is None:
        active_mask = np.ones(n, dtype=bool)
        act_counts = group_sizes
    else:
        active_mask = pos_in_group < cap
        act_counts = np.minimum(group_sizes, cap)
    lo = config.num_passive_data_points_lower_bound
    pas_counts = group_sizes - act_counts
    keep_passive_group = pas_counts > 0 if lo is None else pas_counts >= lo
    return _ReservoirSplit(
        order=order, uniq=uniq, grp_of_sorted=grp_of_sorted,
        pos_in_group=pos_in_group, active_mask=active_mask,
        passive_mask=~active_mask & keep_passive_group[grp_of_sorted],
        act_counts=act_counts,
        group_scale=group_sizes / np.maximum(act_counts, 1))


def _bucket_major_order(act_counts: np.ndarray, num_buckets: int,
                        multiple: int, num_bins: int = 1
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(bucket_n_max, perm, bucket_sizes)``: the bucket plan's non-empty
    buckets and the entity order, bucket-major and balanced within each
    bucket over ``num_bins`` contiguous entity-axis shards
    (``dataset.py:862-873``)."""
    bucket_n_max, bucket_of = _bucket_plan(act_counts, num_buckets, multiple)
    parts = []
    for b in range(len(bucket_n_max)):
        idx = np.flatnonzero(bucket_of == b)
        parts.append(idx[balanced_entity_order(act_counts[idx],
                                               max(1, num_bins))])
    kept = [(nm, p) for nm, p in zip(bucket_n_max, parts) if len(p)]
    return (np.array([nm for nm, _ in kept], dtype=np.int64),
            np.concatenate([p for _, p in kept]),
            np.array([len(p) for _, p in kept], dtype=np.int64))


def _bucket_dim(projectors: Optional[IndexMapProjectors], start: int,
                nr: int, d_red: int, multiple: int) -> int:
    """A bucket's feature width: under index-map projection its entities'
    widest reduced space, padded to ``multiple`` (at most ``d_red``);
    else ``d_red``."""
    if projectors is None:
        return d_red
    d_b = int(projectors.reduced_dims[start:start + nr].max())
    return min(max(1, -(-max(d_b, 1) // multiple) * multiple), d_red)


def _densify_chunked(sub: sp.csr_matrix, chunk: int = 1 << 16) -> np.ndarray:
    """``sub.toarray()`` in row chunks of f32 (``dataset.py:465-474``)."""
    r, d = sub.shape
    out = np.zeros((r, d), dtype=np.float32)
    for lo in range(0, r, chunk):
        out[lo:lo + chunk] = sub[lo:lo + chunk].toarray()
    return out


def _fill_feature_rows(sub: sp.csr_matrix, out: np.ndarray,
                       flat_pos: np.ndarray,
                       projectors: Optional[IndexMapProjectors],
                       random_projector: Optional[RandomProjector],
                       table_ent: Optional[np.ndarray] = None,
                       global_ent: Optional[np.ndarray] = None,
                       raw_indices: Optional[np.ndarray] = None,
                       native_pack: bool = True) -> None:
    """Write ``sub``'s projected rows into the zeroed C-contiguous f32
    block ``out`` (row ``r`` lands at flat row ``flat_pos[r]``;
    ``dataset.py:685-716``): the index-map pack, the random projector's
    product, or the raw rows densified (identity). The index-map pack goes
    through ``photon_pack_projected_rows`` with table row ``table_ent[r]``
    of ``raw_indices`` (a bucket's slice of the projector table), or with
    ``native_pack=False`` through the numpy ``_project_nnz`` scatter, which
    looks the row's GLOBAL entity ``global_ent[r]`` up in the full table."""
    flat = out.reshape(-1, out.shape[-1])
    if projectors is not None:
        if native_pack:
            pack_projected_rows_native(sub, table_ent, flat_pos, raw_indices,
                                       out)
        else:
            nnz_row, nnz_j, nnz_ok = _project_nnz(sub, global_ent,
                                                  projectors)
            flat[flat_pos[nnz_row[nnz_ok]], nnz_j[nnz_ok]] = \
                sub.data[nnz_ok]
    elif random_projector is not None:
        flat[flat_pos] = (sub @ random_projector.matrix).astype(np.float32)
    else:
        flat[flat_pos] = _densify_chunked(sub)


def _pack_entity_buckets(sub, ent_of_act, slot_of_act, act_labels,
                         act_offsets, act_weights, rows_act, n_samples,
                         bucket_sizes, bucket_n_max, projectors,
                         random_projector, d_red, dtype, device,
                         native_pack: bool = True,
                         entity_axis_size: int = 1) -> list[EntityBucket]:
    """Pack active rows into per-bucket (N_b, D_b) blocks
    (``dataset.py:719-792``); D_b narrows per bucket under index-map
    projection only, and a bucket's E_b is padded to a multiple of
    ``entity_axis_size`` so it splits evenly over the entity axis."""
    starts = np.concatenate([[0], np.cumsum(bucket_sizes)])
    bucket_of_act = np.searchsorted(starts, ent_of_act, side="right") - 1
    buckets: list[EntityBucket] = []
    for b in range(len(bucket_sizes)):
        nr = int(bucket_sizes[b])
        start = int(starts[b])
        n_b = int(bucket_n_max[b])
        d_b = _bucket_dim(projectors, start, nr, d_red, PAD_DIM_MULTIPLE)
        e_b = _padded_entities(nr, entity_axis_size)

        mask = bucket_of_act == b
        loc = ent_of_act[mask] - start
        slots = slot_of_act[mask]
        X = np.zeros((e_b, n_b, d_b), dtype=np.float32)
        labels = np.zeros((e_b, n_b), dtype=np.float32)
        offsets = np.zeros((e_b, n_b), dtype=np.float32)
        weights = np.zeros((e_b, n_b), dtype=np.float32)
        row_ids = np.full((e_b, n_b), n_samples, dtype=np.int64)
        labels[loc, slots] = act_labels[mask]
        offsets[loc, slots] = act_offsets[mask]
        weights[loc, slots] = act_weights[mask]
        row_ids[loc, slots] = rows_act[mask]
        # every entity's valid columns sit in the first reduced_dims[e] <=
        # D_b table slots, so the table's slice to D_b drops pads only
        _fill_feature_rows(
            sub[mask], X, loc * n_b + slots, projectors, random_projector,
            table_ent=loc, global_ent=ent_of_act[mask],
            raw_indices=None if projectors is None
            else projectors.raw_indices[start:start + nr, :d_b],
            native_pack=native_pack)
        buckets.append(EntityBucket(
            entity_start=start, num_real=nr,
            X=_to_device(X, device, dtype),
            labels=_to_device(labels, device),
            base_offsets=_to_device(offsets, device),
            weights=_to_device(weights, device),
            row_ids=_to_device(row_ids, device)))
    return buckets


def _padded_entities(e_real: int, entity_axis_size: int) -> int:
    """Lanes of a block of ``e_real`` entities: a multiple of the entity
    axis (at least 1), so its lanes split evenly over the shards."""
    k = max(1, int(entity_axis_size))
    return max(1, -(-max(e_real, 1) // k) * k)


def build_random_effect_dataset(data: GameDataset,
                                config: RandomEffectDataConfiguration,
                                seed: int = 0, pad_rows_multiple: int = 8,
                                dtype=torch.float32, num_buckets: int = 1,
                                device="cuda", native_pack: bool = True,
                                entity_axis_size: int = 1
                                ) -> RandomEffectDataset:
    """Group rows per entity, reservoir-cap, project, pad into device
    blocks (``dataset.py:795-978``). ``num_buckets > 1`` engages (N, D)
    size bucketing; ``native_pack=False`` packs index-map rows by the
    numpy scatter (the plain version). ``entity_axis_size`` is the mesh's
    entity axis: each block's entities are padded to a multiple of it
    with empty lanes, and ordered by the greedy balancer over that many
    bins so that contiguous entity shards carry balanced sample mass."""
    device = resolve_device(device)
    id_type = config.random_effect_type
    if id_type not in data.id_columns:
        raise KeyError(f"id type {id_type!r} not in dataset (have "
                       f"{list(data.id_columns)})")
    codes = np.asarray(data.id_columns[id_type])
    mat = data.feature_shards[config.feature_shard_id].tocsr()
    n, raw_dim = mat.shape
    split = _reservoir_split(codes, config, seed)
    order, grp_of_sorted, active_mask = (split.order, split.grp_of_sorted,
                                         split.active_mask)
    pos_in_group, act_counts = split.pos_in_group, split.act_counts
    group_scale, passive_mask = split.group_scale, split.passive_mask
    e_real = len(split.uniq)
    bucket_sizes = bucket_n_max = None
    if num_buckets > 1 and e_real > 1:
        bucket_n_max, perm, bucket_sizes = _bucket_major_order(
            act_counts, num_buckets, pad_rows_multiple, entity_axis_size)
    else:
        perm = balanced_entity_order(act_counts,
                                     max(1, entity_axis_size))
    ent_codes = split.uniq[perm].astype(np.int64)
    inv_perm = np.empty(e_real, dtype=np.int64)
    inv_perm[perm] = np.arange(e_real)

    rows_act = order[active_mask]
    ent_of_act = inv_perm[grp_of_sorted[active_mask]]
    slot_of_act = pos_in_group[active_mask]
    counts = act_counts[perm]

    sub = mat[rows_act]
    proj_cfg = config.projector
    projectors = random_projector = None
    if proj_cfg.kind == ProjectorType.INDEX_MAP:
        projectors = _build_index_map_projectors(
            sub, ent_of_act, counts, data.responses[rows_act], raw_dim,
            config)
        d_red = projectors.max_reduced_dim
    elif proj_cfg.kind == ProjectorType.RANDOM:
        random_projector = build_random_projector(
            raw_dim, proj_cfg.projected_dim, seed=proj_cfg.seed)
        d_red = proj_cfg.projected_dim
    else:  # IDENTITY
        d_red = raw_dim
    act_weights = (data.weights[rows_act]
                   * group_scale[grp_of_sorted[active_mask]])

    f32 = torch.float32
    single = {}
    buckets = None
    if bucket_sizes is not None:
        buckets = _pack_entity_buckets(
            sub, ent_of_act, slot_of_act,
            act_labels=data.responses[rows_act],
            act_offsets=data.offsets[rows_act], act_weights=act_weights,
            rows_act=rows_act, n_samples=n, bucket_sizes=bucket_sizes,
            bucket_n_max=bucket_n_max, projectors=projectors,
            random_projector=random_projector, d_red=d_red, dtype=dtype,
            device=device, native_pack=native_pack,
            entity_axis_size=entity_axis_size)
        single = dict(X=None, labels=None, base_offsets=None, weights=None,
                      row_ids=None)
    else:
        e_pad = _padded_entities(e_real, entity_axis_size)
        n_max = int(counts.max()) if e_real else 1
        n_max = max(1, -(-n_max // pad_rows_multiple) * pad_rows_multiple)
        X = np.zeros((e_pad, n_max, d_red), dtype=np.float32)
        labels = np.zeros((e_pad, n_max), dtype=np.float32)
        offsets = np.zeros((e_pad, n_max), dtype=np.float32)
        weights = np.zeros((e_pad, n_max), dtype=np.float32)
        row_ids = np.full((e_pad, n_max), n, dtype=np.int64)
        labels[ent_of_act, slot_of_act] = data.responses[rows_act]
        offsets[ent_of_act, slot_of_act] = data.offsets[rows_act]
        weights[ent_of_act, slot_of_act] = act_weights
        row_ids[ent_of_act, slot_of_act] = rows_act
        _fill_feature_rows(
            sub, X, ent_of_act * n_max + slot_of_act, projectors,
            random_projector, table_ent=ent_of_act, global_ent=ent_of_act,
            raw_indices=None if projectors is None
            else projectors.raw_indices, native_pack=native_pack)
        single = dict(X=_to_device(X, device, dtype),
                      labels=_to_device(labels, device),
                      base_offsets=_to_device(offsets, device),
                      weights=_to_device(weights, device),
                      row_ids=_to_device(row_ids, device))

    passive = {}
    if passive_mask.any():
        pr = order[passive_mask]
        local = inv_perm[grp_of_sorted[passive_mask]]
        dense = np.zeros((len(pr), d_red), dtype=np.float32)
        _fill_feature_rows(
            mat[pr], dense, np.arange(len(pr), dtype=np.int64), projectors,
            random_projector, table_ent=local, global_ent=local,
            raw_indices=None if projectors is None
            else projectors.raw_indices, native_pack=native_pack)
        passive = dict(
            passive_X=_to_device(dense, device, dtype),
            passive_entity=_to_device(local, device),
            passive_row_ids=_to_device(pr.astype(np.int64), device),
            passive_offsets=_to_device(data.offsets[pr], device, f32))

    return RandomEffectDataset(
        config=config, entity_codes=ent_codes, num_samples=n,
        projectors=projectors, random_projector=random_projector,
        buckets=buckets,
        _reduced_dim=d_red if buckets is not None else None,
        device=device, **single, **passive)


def _alloc_rows(shape, blocks_dir: Optional[str], name: str) -> np.ndarray:
    """Zeroed f32 destination (``dataset.py:981-990``): a RAM array, or a
    disk-backed ``np.memmap`` ``<blocks_dir>/<name>.f32``, which the OS
    pages and never holds whole."""
    if blocks_dir is None:
        return np.zeros(shape, dtype=np.float32)
    os.makedirs(blocks_dir, exist_ok=True)
    return np.memmap(os.path.join(blocks_dir, name + ".f32"),
                     dtype=np.float32, mode="w+", shape=shape)


def build_random_effect_dataset_streamed(
        stream_factory, config: RandomEffectDataConfiguration, raw_dim: int,
        seed: int = 0, pad_rows_multiple: int = 8, num_buckets: int = 1,
        blocks_dir: Optional[str] = None,
        dtype=torch.float32, device="cuda",
        native_pack: bool = True,
        entity_axis_size: int = 1,
        keep_host_blocks: bool = False,
        entity_shard: Optional[tuple] = None) -> RandomEffectDataset:
    """Random-effect blocks from streamed parts (``dataset.py:993-1295``),
    optionally memmap-backed; ``entity_axis_size`` pads and balances each
    bucket for the entity axis as the in-RAM builder does.

    ``stream_factory()`` returns a fresh iterator over parts
    ``(csr_chunk [M, raw_dim], entity_codes [M], labels [M], offsets [M],
    weights [M])`` in a fixed order; it is consumed two or three times.
    Pass 1 holds the O(N) scalar columns only and makes the reservoir
    split, the balanced entity order and the (N, D) bucket plan of the
    in-RAM builder (same seed, same active sets); an INDEX_MAP projector
    takes one more pass through :class:`_PairStatsAccumulator`; pass 2
    scatters each part's active and passive rows into their blocks. With
    ``blocks_dir`` the bucket and passive feature blocks are ``np.memmap``
    files there (``bucket<b>_X.f32``, ``passive_X.f32``) that stay on
    the host, and peak host memory is one part plus the scalar columns;
    the caller owns the directory. The memmap files are f32 whatever
    ``dtype`` is (the JAX package's spill format, ``dataset.py:1033-1039``):
    ``dtype`` applies when a block is paged to the device (the dataset's
    ``storage_dtype``), as it applies at the device commit of RAM blocks.
    The result is always bucketed (``num_buckets=1``: one bucket) and
    equals the in-RAM builder's array for array.

    ``entity_shard=(k, K)`` (``dataset.py:1038-1050``, ``:1159-1170``)
    builds only the k-th of K contiguous slices of every bucket's padded
    entity axis: the bucket plan stays global (it comes from the O(N)
    scalar columns), and each process of a gang allocates and fills its
    own slice, ``E_b / K`` entities starting at the bucket's
    ``local_entity_offset``. ``entity_axis_size`` must be divisible by K;
    passive rows stay whole. ``keep_host_blocks`` leaves the blocks
    (features, labels, offsets, weights, row ids; passive rows too) as
    host arrays until the caller places them. ``entity_shard=(0, 1)``
    gives the unsharded dataset, array for array."""
    device = resolve_device(device)
    shard_k, shard_count = (0, 1) if entity_shard is None else entity_shard
    if not 0 <= shard_k < shard_count:
        raise ValueError(f"entity_shard index {shard_k} out of range for "
                         f"{shard_count} shards")
    if entity_axis_size % shard_count != 0:
        raise ValueError(f"entity_shard needs entity_axis_size divisible "
                         f"by {shard_count}, got {entity_axis_size}")
    # ---- pass 1: scalar columns only ---------------------------------------
    codes_parts, y_parts, off_parts, wt_parts = [], [], [], []
    for _, c, y, o, w in stream_factory():
        codes_parts.append(np.asarray(c, np.int64))
        y_parts.append(np.asarray(y, np.float64))
        off_parts.append(np.asarray(o, np.float64))
        # f64, so that the reservoir rescale below is the in-RAM builder's
        # product (f64 weights x f64 scale, then one f32 cast)
        wt_parts.append(np.asarray(w, np.float64))
    if not codes_parts:
        raise ValueError("empty random-effect stream")
    codes = np.concatenate(codes_parts)
    resp = np.concatenate(y_parts)
    offs = np.concatenate(off_parts)
    wts = np.concatenate(wt_parts)
    del codes_parts, y_parts, off_parts, wt_parts
    n = len(codes)
    split = _reservoir_split(codes, config, seed)
    order, grp_of_sorted = split.order, split.grp_of_sorted
    active_mask, passive_mask = split.active_mask, split.passive_mask
    e_real = len(split.uniq)
    bucket_n_max, perm, bucket_sizes = _bucket_major_order(
        split.act_counts, max(1, num_buckets), pad_rows_multiple,
        entity_axis_size)
    ent_codes = split.uniq[perm].astype(np.int64)
    inv_perm = np.empty(e_real, dtype=np.int64)
    inv_perm[perm] = np.arange(e_real)
    counts = split.act_counts[perm]

    # per-dataset-row views of the sorted layout
    row_ent = np.empty(n, np.int64)
    row_ent[order] = inv_perm[grp_of_sorted]
    row_slot = np.empty(n, np.int64)
    row_slot[order] = split.pos_in_group
    row_active = np.empty(n, bool)
    row_active[order] = active_mask
    row_passive = np.empty(n, bool)
    row_passive[order] = passive_mask
    n_passive = int(passive_mask.sum())
    ppos = np.full(n, -1, np.int64)
    ppos[order[passive_mask]] = np.arange(n_passive)
    group_scale_perm = split.group_scale[perm]
    del split, order, grp_of_sorted, active_mask, passive_mask, codes

    # ---- projector (a streamed stats pass for INDEX_MAP) -------------------
    proj_cfg = config.projector
    projectors = random_projector = None
    if proj_cfg.kind == ProjectorType.INDEX_MAP:
        acc = _PairStatsAccumulator(
            raw_dim, e_real,
            _keep_limits(config, e_real, counts) is not None)
        lo = 0
        for chunk in stream_factory():
            mat_c = chunk[0].tocsr()
            m = mat_c.shape[0]
            a = row_active[lo:lo + m]
            acc.add(mat_c[a], row_ent[lo:lo + m][a], resp[lo:lo + m][a])
            lo += m
        projectors = acc.finalize(counts, config, PAD_DIM_MULTIPLE)
        d_red = projectors.max_reduced_dim
    elif proj_cfg.kind == ProjectorType.RANDOM:
        random_projector = build_random_projector(
            raw_dim, proj_cfg.projected_dim, seed=proj_cfg.seed)
        d_red = proj_cfg.projected_dim
    else:  # IDENTITY
        d_red = raw_dim

    # ---- destination blocks -------------------------------------------------
    b_starts = np.concatenate([[0], np.cumsum(bucket_sizes)])
    Xs, labs, offsb, wtsb, rids, dims = [], [], [], [], [], []
    slice_lo = []  # this slice's first row of each bucket's entity axis
    for b in range(len(bucket_sizes)):
        nr, n_b = int(bucket_sizes[b]), int(bucket_n_max[b])
        start = int(b_starts[b])
        d_b = _bucket_dim(projectors, start, nr, d_red, PAD_DIM_MULTIPLE)
        e_loc = _padded_entities(nr, entity_axis_size) // shard_count
        slice_lo.append(shard_k * e_loc)
        Xs.append(_alloc_rows((e_loc, n_b, d_b), blocks_dir,
                              f"bucket{b}_X"))
        labs.append(np.zeros((e_loc, n_b), np.float32))
        offsb.append(np.zeros((e_loc, n_b), np.float32))
        wtsb.append(np.zeros((e_loc, n_b), np.float32))
        rids.append(np.full((e_loc, n_b), n, np.int64))
        dims.append(d_b)
    p_X = (_alloc_rows((n_passive, d_red), blocks_dir, "passive_X")
           if n_passive else None)
    p_ent = np.zeros(n_passive, np.int64)
    p_rows = np.zeros(n_passive, np.int64)
    p_off = np.zeros(n_passive, np.float64)

    # ---- pass 2: scatter each part into its blocks --------------------------
    lo = 0
    for chunk in stream_factory():
        mat_c = chunk[0].tocsr()
        hi = lo + mat_c.shape[0]
        a = np.flatnonzero(row_active[lo:hi])
        if len(a):
            rows_g = lo + a
            ent = row_ent[lo:hi][a]
            slot = row_slot[lo:hi][a]
            b_of = np.searchsorted(b_starts, ent, side="right") - 1
            sub_a = mat_c[a]
            for b in np.unique(b_of):
                mask = b_of == b
                start, nr = int(b_starts[b]), int(bucket_sizes[b])
                lo_b = slice_lo[b]
                if shard_count > 1:  # this slice's entities only
                    in_bucket = ent - start
                    mask &= ((in_bucket >= lo_b)
                             & (in_bucket < lo_b + labs[b].shape[0]))
                    if not mask.any():
                        continue
                n_b = int(bucket_n_max[b])
                loc = ent[mask] - start - lo_b
                sl = slot[mask]
                # the projector rows of this slice's real entities
                tbl = slice(start + lo_b,
                            start + min(nr, lo_b + labs[b].shape[0]))
                _fill_feature_rows(
                    sub_a[mask], Xs[b], loc * n_b + sl, projectors,
                    random_projector, table_ent=loc, global_ent=ent[mask],
                    raw_indices=None if projectors is None
                    else projectors.raw_indices[tbl, :dims[b]],
                    native_pack=native_pack)
                labs[b][loc, sl] = resp[rows_g[mask]]
                offsb[b][loc, sl] = offs[rows_g[mask]]
                wtsb[b][loc, sl] = (wts[rows_g[mask]]
                                    * group_scale_perm[ent[mask]])
                rids[b][loc, sl] = rows_g[mask]
        p = np.flatnonzero(row_passive[lo:hi])
        if len(p):
            rows_g = lo + p
            pp = ppos[rows_g]
            ent_p = row_ent[lo:hi][p]
            _fill_feature_rows(
                mat_c[p], p_X, pp, projectors, random_projector,
                table_ent=ent_p, global_ent=ent_p,
                raw_indices=None if projectors is None
                else projectors.raw_indices, native_pack=native_pack)
            p_ent[pp] = ent_p
            p_rows[pp] = rows_g
            p_off[pp] = offs[rows_g]
        lo = hi

    host = blocks_dir is not None

    def feature_block(X):
        if host:
            X.flush()
            return X
        if keep_host_blocks:
            return X
        return _to_device(X, device, dtype)

    def place(a):
        return a if keep_host_blocks else _to_device(a, device)

    buckets = [EntityBucket(
        entity_start=int(b_starts[b]), num_real=int(bucket_sizes[b]),
        X=feature_block(Xs[b]), labels=place(labs[b]),
        base_offsets=place(offsb[b]), weights=place(wtsb[b]),
        row_ids=place(rids[b]), local_entity_offset=slice_lo[b])
        for b in range(len(bucket_sizes))]
    passive = {}
    if p_X is not None:
        passive = dict(
            passive_X=feature_block(p_X), passive_entity=place(p_ent),
            passive_row_ids=place(p_rows),
            passive_offsets=(p_off.astype(np.float32) if keep_host_blocks
                             else _to_device(p_off, device, torch.float32)))
    return RandomEffectDataset(
        config=config, entity_codes=ent_codes, X=None, labels=None,
        base_offsets=None, weights=None, row_ids=None, num_samples=n,
        projectors=projectors, random_projector=random_projector,
        buckets=buckets, _reduced_dim=d_red, device=device,
        storage_dtype=dtype, entity_shard=(shard_k, shard_count), **passive)


def dataset_row_stream(data: GameDataset,
                       config: RandomEffectDataConfiguration,
                       chunk_rows: int = 500_000):
    """Stream factory over an in-RAM ``GameDataset`` in row chunks
    (``dataset.py:1298-1316``): the part contract of
    :func:`build_random_effect_dataset_streamed`."""
    id_type = config.random_effect_type
    if id_type not in data.id_columns:
        raise KeyError(f"id type {id_type!r} not in dataset (have "
                       f"{list(data.id_columns)})")

    def factory():
        mat = data.feature_shards[config.feature_shard_id].tocsr()
        codes = np.asarray(data.id_columns[id_type])
        for lo in range(0, data.num_samples, chunk_rows):
            hi = min(lo + chunk_rows, data.num_samples)
            yield (mat[lo:hi], codes[lo:hi], data.responses[lo:hi],
                   data.offsets[lo:hi], data.weights[lo:hi])

    return factory

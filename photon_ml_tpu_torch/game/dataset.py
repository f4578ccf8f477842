"""GAME data layer: columnar dataset, fixed-effect batch, entity blocks.

Port of ``photon_ml_tpu/game/dataset.py`` — ``GameDataset`` (``:59-114``),
``csr_to_batch``'s dense branch and ``build_fixed_effect_dataset``
(``:153-185``), ``balanced_entity_order`` (``:193-234``),
``RandomEffectDataConfiguration`` with its CLI ``parse`` (``:243-313``),
``FixedEffectDataConfiguration`` (``:316-329``) and the in-RAM
``build_random_effect_dataset`` (``:333-978``) with its three projections
(the choice at ``:885-900``): INDEX_MAP, RANDOM (the shared Gaussian
matrix of ``projector/projectors.py``, applied to each row on the host,
``:711-712``) and IDENTITY (the raw shard densified in row chunks,
``:465``, ``:713-714``; what the factored coordinate needs), and
``(N, D)`` entity bucketing. The host-side grouping, reservoir split,
projector build and packing are numpy, identical to the JAX package's; the
index-map packer is the numpy ``_project_nnz`` scatter (the JAX package's
fallback at ``:706-710``) instead of the native ``block_packer.cpp``. Only
the device commit differs: blocks become torch tensors on the requested
device.

The ELL layout and the streamed builder wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.data.batch import DenseBatch
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.projector.projectors import (
    IndexMapProjectors,
    ProjectorConfig,
    ProjectorType,
    RandomProjector,
    build_random_projector,
)

Tensor = torch.Tensor

DENSE_FEATURE_THRESHOLD = 4096


def canonicalized_csr(mat):
    """CSR with duplicate (row, col) entries summed (``batch.py:173-181``)."""
    if not mat.has_canonical_format:
        mat = mat.copy()
        mat.sum_duplicates()
    return mat


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
    """Device batch over the full sample axis for one feature shard."""

    shard_id: str
    batch: DenseBatch
    base_offsets: Tensor

    @property
    def num_samples(self) -> int:
        return int(self.batch.labels.shape[0])

    def with_offsets(self, extra_scores: Tensor) -> DenseBatch:
        """Batch whose offsets = data offsets + other coordinates' scores."""
        return self.batch._replace(offsets=self.base_offsets + extra_scores)


def csr_to_batch(mat, labels, offsets, weights, dtype=torch.float32,
                 dense_threshold: int = DENSE_FEATURE_THRESHOLD,
                 device="cuda") -> DenseBatch:
    """Dense device batch from a CSR shard (``dataset.py:153-172``)."""
    device = resolve_device(device)
    if mat.shape[1] > dense_threshold:
        raise NotImplementedError(
            "the ELL layout for wide shards is not ported yet")
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
    ``entity_start + i``; padded rows have weight 0 and row id N."""

    entity_start: int
    num_real: int
    X: Tensor  # [E_b, N_b, D_b]
    labels: Tensor  # [E_b, N_b]
    base_offsets: Tensor
    weights: Tensor  # 0 = padding
    row_ids: Tensor  # [E_b, N_b] int64 (num_samples = discard slot)


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
    passive_X: Optional[Tensor] = None
    passive_entity: Optional[Tensor] = None
    passive_row_ids: Optional[Tensor] = None
    passive_offsets: Optional[Tensor] = None
    buckets: Optional[list] = None
    _reduced_dim: Optional[int] = None

    @property
    def num_entities(self) -> int:
        if self.buckets is not None:
            return sum(b.num_real for b in self.buckets)
        return int(self.X.shape[0])

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
                                pad_to_multiple: int = 8
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

    if config.num_features_to_keep_upper_bound is not None:
        limits = np.full(e_real, config.num_features_to_keep_upper_bound,
                         dtype=np.int64)
    elif config.num_features_to_samples_ratio_upper_bound is not None:
        limits = np.ceil(config.num_features_to_samples_ratio_upper_bound
                         * act_counts).astype(np.int64)
    else:
        limits = None

    if limits is not None:
        v = sub.data.astype(np.float64)
        y = np.asarray(labels, dtype=np.float64)
        s1 = np.bincount(inv, weights=v, minlength=len(pairs))
        s2 = np.bincount(inv, weights=v * v, minlength=len(pairs))
        sxy = np.bincount(inv, weights=v * y[row_of], minlength=len(pairs))
        ent_rows = np.asarray(entity_of_row, dtype=np.int64)
        sy1 = np.bincount(ent_rows, weights=y, minlength=e_real)
        sy2 = np.bincount(ent_rows, weights=y * y, minlength=e_real)
        # |Pearson(feature, label)| per pair from the sparse moments
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
        pair_ent, pair_col = pair_ent[reorder], pair_col[reorder]

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
                       global_ent: Optional[np.ndarray] = None) -> None:
    """Write ``sub``'s projected rows into the zeroed f32 block ``out``
    (row ``r`` lands at flat row ``flat_pos[r]``; ``dataset.py:685-716``):
    the index-map scatter by ``global_ent``, the random projector's
    product, or the raw rows densified (identity)."""
    flat = out.reshape(-1, out.shape[-1])
    if projectors is not None:
        nnz_row, nnz_j, nnz_ok = _project_nnz(sub, global_ent, projectors)
        flat[flat_pos[nnz_row[nnz_ok]], nnz_j[nnz_ok]] = sub.data[nnz_ok]
    elif random_projector is not None:
        flat[flat_pos] = (sub @ random_projector.matrix).astype(np.float32)
    else:
        flat[flat_pos] = _densify_chunked(sub)


def _pack_entity_buckets(sub, ent_of_act, slot_of_act, act_labels,
                         act_offsets, act_weights, rows_act, n_samples,
                         bucket_sizes, bucket_n_max, projectors,
                         random_projector, d_red, dtype, device,
                         pad_dim_multiple: int = 8) -> list[EntityBucket]:
    """Pack active rows into per-bucket (N_b, D_b) blocks
    (``dataset.py:719-792``, one entity-axis shard); D_b narrows per
    bucket under index-map projection only."""
    starts = np.concatenate([[0], np.cumsum(bucket_sizes)])
    bucket_of_act = np.searchsorted(starts, ent_of_act, side="right") - 1
    buckets: list[EntityBucket] = []
    for b in range(len(bucket_sizes)):
        nr = int(bucket_sizes[b])
        start = int(starts[b])
        n_b = int(bucket_n_max[b])
        d_b = d_red
        if projectors is not None:
            d_b = int(projectors.reduced_dims[start:start + nr].max())
            d_b = max(1, -(-max(d_b, 1) // pad_dim_multiple)
                      * pad_dim_multiple)
            d_b = min(d_b, d_red)
        e_b = max(1, nr)

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
        _fill_feature_rows(sub[mask], X, loc * n_b + slots, projectors,
                           random_projector, ent_of_act[mask])
        buckets.append(EntityBucket(
            entity_start=start, num_real=nr,
            X=_to_device(X, device, dtype),
            labels=_to_device(labels, device),
            base_offsets=_to_device(offsets, device),
            weights=_to_device(weights, device),
            row_ids=_to_device(row_ids, device)))
    return buckets


def build_random_effect_dataset(data: GameDataset,
                                config: RandomEffectDataConfiguration,
                                seed: int = 0, pad_rows_multiple: int = 8,
                                dtype=torch.float32, num_buckets: int = 1,
                                device="cuda") -> RandomEffectDataset:
    """Group rows per entity, reservoir-cap, project, pad into device
    blocks (``dataset.py:795-978``, one entity-axis shard). ``num_buckets
    > 1`` engages (N, D) size bucketing."""
    device = resolve_device(device)
    id_type = config.random_effect_type
    if id_type not in data.id_columns:
        raise KeyError(f"id type {id_type!r} not in dataset (have "
                       f"{list(data.id_columns)})")
    codes = np.asarray(data.id_columns[id_type])
    mat = data.feature_shards[config.feature_shard_id].tocsr()
    n, raw_dim = mat.shape
    rng = np.random.default_rng(seed)

    # group + reservoir split: rows ordered by (entity, random key), so the
    # first `cap` rows of each group are a uniform sample
    order = np.lexsort((rng.random(n), codes))
    sorted_codes = codes[order]
    uniq, starts, group_sizes = np.unique(
        sorted_codes, return_index=True, return_counts=True)
    e_real = len(uniq)
    grp_of_sorted = np.repeat(np.arange(e_real), group_sizes)
    pos_in_group = np.arange(n) - starts[grp_of_sorted]

    cap = config.num_active_data_points_upper_bound
    if cap is None:
        active_mask = np.ones(n, dtype=bool)
        act_counts = group_sizes
    else:
        active_mask = pos_in_group < cap
        act_counts = np.minimum(group_sizes, cap)
    group_scale = group_sizes / np.maximum(act_counts, 1)

    lo = config.num_passive_data_points_lower_bound
    pas_counts = group_sizes - act_counts
    keep_passive_group = pas_counts > 0 if lo is None else pas_counts >= lo
    passive_mask = ~active_mask & keep_passive_group[grp_of_sorted]

    bucket_sizes = bucket_n_max = None
    if num_buckets > 1 and e_real > 1:
        bucket_n_max, bucket_of = _bucket_plan(act_counts, num_buckets,
                                               pad_rows_multiple)
        parts = []
        for b in range(len(bucket_n_max)):
            idx = np.flatnonzero(bucket_of == b)
            parts.append(idx[balanced_entity_order(act_counts[idx], 1)])
        kept = [(nm, p) for nm, p in zip(bucket_n_max, parts) if len(p)]
        bucket_n_max = np.array([nm for nm, _ in kept], dtype=np.int64)
        parts = [p for _, p in kept]
        perm = np.concatenate(parts)
        bucket_sizes = np.array([len(p) for p in parts], dtype=np.int64)
    else:
        perm = balanced_entity_order(act_counts, 1)
    ent_codes = uniq[perm].astype(np.int64)
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
            device=device)
        single = dict(X=None, labels=None, base_offsets=None, weights=None,
                      row_ids=None)
    else:
        e_pad = max(1, e_real)
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
        _fill_feature_rows(sub, X, ent_of_act * n_max + slot_of_act,
                           projectors, random_projector, ent_of_act)
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
        _fill_feature_rows(mat[pr], dense, np.arange(len(pr)), projectors,
                           random_projector, local)
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
        **single, **passive)

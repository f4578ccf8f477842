"""Scoring core, and the bucketed serving scorer built on it.

Port of ``photon_ml_tpu/serve/scoring.py`` — ``resolve_index_maps`` (an
off-heap store, else name-term set files, else the model files' own
maps), ``load_scoring_model``, ``materialize_model`` (projected and
factored random effects converted to raw space once, ``:86-100``; a model
read from disk holds raw ones already), ``score_game_dataset``,
:class:`ServingScorer` (``:143-262``) and :class:`GenerationStore`
(``:264-429``).

:class:`ServingScorer` is the always-on path: protocol rows →
:func:`~photon_ml_tpu_torch.io.data_format.game_dataset_from_records`
(the records path of the Avro loader) → per-coordinate contributions,
with random-effect rows served by the tiered stores → the fold
``zeros + c₀ + c₁ + …`` in model order over a ``[C, bucket]`` f32 block
on the device, ``bucket`` a power of two. A random effect's row dot runs
on the device over the rows the store gathered there
(:func:`~photon_ml_tpu_torch.game.models.rowwise_sparse_dot_on_device`).
With the f32 tier it equals :func:`score_game_dataset` bit for bit: that
row dot makes the adds of the host form
:func:`~photon_ml_tpu_torch.game.models.rowwise_sparse_dot_gathered` in
their order over the same f32 rows, other coordinates score through
their own ``score``, and the fold makes :meth:`GameModel.score`'s f32
adds in its order (pad lanes are sliced off and never touch a real
row).
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.models import (
    FactoredRandomEffectModel,
    GameModel,
    RandomEffectModel,
    RandomEffectModelInProjectedSpace,
    rowwise_sparse_dot_on_device,
)
from photon_ml_tpu_torch.io.data_format import (
    NameAndTermFeatureSets,
    game_dataset_from_records,
)
from photon_ml_tpu_torch.io.feature_index_job import load_feature_index
from photon_ml_tpu_torch.io.model_io import load_game_model
from photon_ml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from photon_ml_tpu_torch.serve.batcher import MIN_BUCKET, bucket_rows
from photon_ml_tpu_torch.serve.tiers import TieredCoefficientStore


def resolve_index_maps(section_keys: dict[str, list[str]],
                       intercept_map: dict[str, bool],
                       feature_set_path: Optional[str] = None,
                       offheap_dir: Optional[str] = None,
                       offheap_partitions: Optional[int] = None) -> dict:
    """Feature index maps for scoring, by precedence: the off-heap store of
    ``offheap_dir`` (one namespace per shard; a missing store fails), the
    name-term set files, else ``{}`` (``load_game_model`` then rebuilds
    them from the model files)."""
    index_maps: dict = {}
    if offheap_dir:
        index_maps.update(load_feature_index(
            offheap_dir, sorted(section_keys), offheap=True,
            expected_partitions=offheap_partitions))
    elif feature_set_path:
        all_sections = sorted({s for secs in section_keys.values()
                               for s in secs})
        sets = NameAndTermFeatureSets.load(feature_set_path, all_sections)
        for shard, sections in section_keys.items():
            index_maps[shard] = sets.index_map(
                sections, add_intercept=intercept_map.get(shard, True))
    return index_maps


def materialize_model(model: GameModel) -> GameModel:
    """The model with every projected or factored random effect converted
    to raw space once (``to_raw()`` is what their ``score`` does on every
    call); the scores are the same bit for bit."""
    return GameModel({
        cid: (m.to_raw() if isinstance(m, (RandomEffectModelInProjectedSpace,
                                           FactoredRandomEffectModel))
              else m)
        for cid, m in model.models.items()})


def load_scoring_model(model_dir: str, index_maps: Optional[dict]):
    """``(model, index_maps)`` ready to score."""
    return load_game_model(model_dir, index_maps or None)


def score_game_dataset(model: GameModel, data, device="cuda") -> np.ndarray:
    """The summed coordinate score of every row, fetched once."""
    return model.score(data, device=device).cpu().numpy()


def fold_contributions(stacked: torch.Tensor) -> torch.Tensor:
    """``zeros + c_0 + c_1 + ...`` over the rows of a ``[C, P]`` block:
    :meth:`GameModel.score`'s adds in its order. Elementwise adds are
    lane-local, so pad lanes never influence real rows."""
    total = torch.zeros_like(stacked[0])
    for i in range(stacked.shape[0]):
        total = total + stacked[i]
    return total


class ServingScorer:
    """Resident scorer: tiered coefficient stores + bucketed device fold,
    on ``device``. One instance per model generation; called only from
    the device loop."""

    def __init__(self, model: GameModel,
                 section_keys: dict[str, list[str]],
                 index_maps: dict,
                 id_types: Sequence[str] = (),
                 hbm_budget_bytes: int = 64 << 20,
                 host_tier_entities: int = 65536,
                 tier_dtype: str = "f32",
                 min_bucket: int = MIN_BUCKET,
                 max_batch_rows: int = 4096,
                 registry: MetricsRegistry = REGISTRY,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.section_keys = section_keys
        self.index_maps = index_maps
        self.id_types = sorted(set(id_types) | {
            m.random_effect_type for m in model.models.values()
            if isinstance(m, RandomEffectModel)})
        self.min_bucket = int(min_bucket)
        self.max_batch_rows = int(max_batch_rows)
        self._registry = registry
        # one tiered store per random-effect coordinate that carries raw
        # entity ids (all disk-loaded models do); the budget is split
        # evenly across them
        tiered = [cid for cid, m in model.models.items()
                  if isinstance(m, RandomEffectModel)
                  and m.entity_ids is not None
                  and m.coefficients.shape[0] > 0]
        per_store = hbm_budget_bytes // max(len(tiered), 1)
        self.tier_dtype = tier_dtype
        self.stores = {
            cid: TieredCoefficientStore(
                cid, model.models[cid], per_store,
                host_capacity=host_tier_entities,
                device_dtype=tier_dtype, registry=registry,
                device=self.device)
            for cid in tiered}
        #: generation tag, assigned by :class:`GenerationStore` when the
        #: scorer is activated (1 for a scorer that was never swapped)
        self.generation = 1

    def release_device(self) -> None:
        """Release every tier store's device rows (generation retirement,
        once no in-flight batch is pinned to this generation).
        Reversible: a rollback re-warms on demand."""
        for store in self.stores.values():
            store.release()

    # -- per-batch path --------------------------------------------------

    def score_records(self, records: Sequence[dict],
                      stages: Optional[dict] = None,
                      ) -> tuple[np.ndarray, Optional[np.ndarray]]:
        """Protocol rows → ``(scores, uids)``. Chunks above the batch
        cap; per-row scores are row-local, so chunk boundaries cannot
        change any row's bits. ``stages`` is an optional accumulator the
        request-tracing layer passes in: per-stage ``perf_counter_ns``
        durations (``tier_gather``/``device_score``) are ADDED into it,
        so a chunked request reports the summed cost of its chunks."""
        if not records:
            return np.zeros(0), None
        if len(records) > self.max_batch_rows:
            parts = [self.score_records(
                records[i:i + self.max_batch_rows], stages=stages)
                for i in range(0, len(records), self.max_batch_rows)]
            scores = np.concatenate([p[0] for p in parts])
            uids = (np.concatenate([p[1] for p in parts])
                    if parts[0][1] is not None else None)
            return scores, uids
        data = game_dataset_from_records(
            records, self.section_keys, self.index_maps,
            id_types=self.id_types, response_required=False)
        return self.score_dataset(data, stages=stages), data.uids

    def score_dataset(self, data, stages: Optional[dict] = None
                      ) -> np.ndarray:
        """The summed coordinate score through the tiered stores and the
        bucketed fold; bit-identical to :func:`score_game_dataset` on the
        same rows with the f32 tier."""
        n = data.num_samples
        bucket = bucket_rows(n, min_bucket=self.min_bucket)
        stacked = torch.zeros((len(self.model.models), bucket),
                              dtype=torch.float32, device=self.device)
        device_ns = 0
        for i, (cid, m) in enumerate(self.model.models.items()):
            store = self.stores.get(cid)
            if store is None:
                stacked[i, :n] = m.score(data, device=self.device)
                continue
            codes = np.asarray(data.id_columns[m.random_effect_type])
            vocab = data.id_vocabs[m.random_effect_type]
            raw_ids = np.asarray(
                [str(x) for x in np.asarray(vocab).ravel()],
                dtype=object)[codes]
            # the store adds its own wall time to stages["tier_gather"]
            table, rows = store.lookup(raw_ids, stages=stages)
            t0 = time.perf_counter_ns()
            stacked[i, :n] = rowwise_sparse_dot_on_device(
                data.feature_shards[m.feature_shard_id], table, rows)
            device_ns += time.perf_counter_ns() - t0
        t0 = time.perf_counter_ns()
        out = fold_contributions(stacked)[:n].cpu().numpy().astype(
            np.float64)
        if stages is not None:
            stages["device_score"] = stages.get("device_score", 0) \
                + device_ns + (time.perf_counter_ns() - t0)
        self._registry.counter("serve_rows_scored").inc(n)
        return out

    def stats(self) -> dict:
        out = {"tiers": [s.stats() for s in self.stores.values()],
               "tier_hits": self._registry.counter(
                   "serve_tier_hits").by_label("tier")}
        if self.device.type == "cuda":
            # the caching allocator's host-side counter: no device work
            out["device_max_memory_allocated"] = \
                torch.cuda.max_memory_allocated(self.device)
        return out


class _GenerationEntry:
    __slots__ = ("scorer", "model_id", "pins", "retained", "released")

    def __init__(self, scorer: ServingScorer, model_id: str):
        self.scorer = scorer
        self.model_id = model_id
        self.pins = 0          # batches admitted, not yet replied
        self.retained = False  # kept as the rollback target
        self.released = False  # device rows dropped


class GenerationStore:
    """Versioned :class:`ServingScorer` registry with pinned-batch
    accounting — the atomic-flip half of the hot-swap contract.

    Reader threads :meth:`pin` the CURRENT generation per request at
    admission; the device loop scores each micro-batch against the
    generation its work is pinned to and :meth:`unpin`\\ s when the
    reply (or error/shed) resolves. :meth:`activate` flips the current
    generation in one lock-held assignment — new requests pin the
    candidate, in-flight work keeps its old pin, and since the batcher
    never mixes generations in a batch, no score ever mixes
    generations. The previous generation is RETAINED as the rollback
    target until probation passes; :meth:`rollback` re-activates it.
    Old-generation device rows are freed only by :meth:`reap` — called
    from the device loop (the only device-touching thread) once a
    retired generation's last pinned batch has drained.

    Generation numbers are monotonic (``_seq``) and never reused, so a
    relaunch or rollback can always be audited to exactly one
    consistent generation.
    """

    def __init__(self, scorer: ServingScorer, model_id: str,
                 registry: MetricsRegistry = REGISTRY):
        self._lock = threading.Lock()
        self._entries: dict[int, _GenerationEntry] = {
            1: _GenerationEntry(scorer, model_id)}
        self._current = 1
        self._seq = 1
        self._previous: Optional[int] = None
        self._registry = registry
        scorer.generation = 1
        registry.gauge("serve_generation").set(1)

    # -- reads ----------------------------------------------------------

    @property
    def generation(self) -> int:
        with self._lock:
            return self._current

    @property
    def next_generation(self) -> int:
        """The number the next :meth:`activate` will assign (stable
        while at most one swap is in flight — the service serializes
        swaps)."""
        with self._lock:
            return self._seq + 1

    def model_id(self, generation: Optional[int] = None) -> str:
        with self._lock:
            gen = self._current if generation is None else generation
            return self._entries[gen].model_id

    def scorer(self, generation: int = 0) -> ServingScorer:
        """The scorer for ``generation`` (0 = current)."""
        with self._lock:
            gen = generation or self._current
            return self._entries[gen].scorer

    # -- pin accounting (reader threads / device loop) -------------------

    def pin(self) -> int:
        """Admit one request under the current generation."""
        with self._lock:
            self._entries[self._current].pins += 1
            return self._current

    def unpin(self, generation: int) -> None:
        with self._lock:
            entry = self._entries.get(generation)
            if entry is not None and entry.pins > 0:
                entry.pins -= 1

    # -- the flip --------------------------------------------------------

    def activate(self, scorer: ServingScorer, model_id: str) -> int:
        """Atomic generation flip: the candidate becomes current, the
        old current becomes the retained rollback target (displacing —
        and thereby releasing — any older retained generation)."""
        with self._lock:
            self._seq += 1
            new_gen = self._seq
            scorer.generation = new_gen
            old = self._current
            self._entries[new_gen] = _GenerationEntry(scorer, model_id)
            self._entries[old].retained = True
            if self._previous is not None:
                prev = self._entries.get(self._previous)
                if prev is not None:
                    prev.retained = False
            self._previous = old
            self._current = new_gen
            self._registry.gauge("serve_generation").set(new_gen)
            return new_gen

    def rollback(self) -> int:
        """Re-activate the retained previous generation (probation
        failed). The rolled-back generation is retired un-retained —
        reaped once its last pinned batch drains."""
        with self._lock:
            if self._previous is None:
                raise RuntimeError("no retained generation to roll "
                                   "back to")
            failed = self._current
            back = self._previous
            self._current = back
            self._previous = None
            self._entries[back].retained = False
            # the store re-warms on demand; a future retirement must
            # release it again
            self._entries[back].released = False
            self._entries[failed].retained = False
            self._registry.gauge("serve_generation").set(back)
            return back

    def release_previous(self) -> None:
        """Probation passed: stop retaining the previous generation
        (reaped once drained)."""
        with self._lock:
            if self._previous is None:
                return
            prev = self._entries.get(self._previous)
            if prev is not None:
                prev.retained = False
            self._previous = None

    # -- device-loop cleanup ---------------------------------------------

    def reap(self) -> list[ServingScorer]:
        """Retired generations whose last pinned batch has drained —
        the caller (the device loop) releases their device rows. A
        rollback-retained generation is device-released but its entry
        (host/model state) survives; anything else is forgotten."""
        out: list[ServingScorer] = []
        with self._lock:
            for gen in list(self._entries):
                entry = self._entries[gen]
                if gen == self._current or entry.pins > 0:
                    continue
                if not entry.released:
                    entry.released = True
                    out.append(entry.scorer)
                if not entry.retained:
                    del self._entries[gen]
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "generation": self._current,
                "model_id": self._entries[self._current].model_id,
                "retained_generation": self._previous,
                "pins": {g: e.pins for g, e in self._entries.items()},
            }

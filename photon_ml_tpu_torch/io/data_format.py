"""GAME ingestion: Avro records -> columnar ``GameDataset``, feature sets.

Port of the records path of ``photon_ml_tpu/io/data_format.py`` —
``_id_from_record`` (``:599-610``), ``game_dataset_from_records``
(``:808-896``), ``load_game_dataset_avro`` (``:899-943``) and
``NameAndTermFeatureSets`` (``:951-1071``; avro/data/NameAndTermFeature
SetContainer.scala:38-127). Per record: one sparse row per feature shard
(the union of its feature sections), response/offset/weight, id columns
from top-level fields or ``metadataMap``, the intercept appended when the
shard's index map carries the intercept key (avro/data/
DataProcessingUtils.scala:57-215).

The JAX package decodes through its native columnar reader
(``io/native_avro.py``) when it can and falls back to this interpreted
loop; both build the same dataset. The port has only the loop; the native
decoder and the legacy ``LabeledData``/LibSVM loaders come in later
slices. With an ingest policy (``data/ingest.py``) the loop reads part
file by part file and quarantines a corrupt or unreadable one, as the
JAX package's interpreted fallback does (``:916-935``).
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Sequence

import numpy as np
import scipy.sparse as sp

from photon_ml_tpu_torch.game.dataset import GameDataset
from photon_ml_tpu_torch.io.avro import list_avro_parts, read_shard
from photon_ml_tpu_torch.io.index_map import IndexMap, feature_key

# Avro field names (avro/AvroFieldNames.scala:21-28).
NAME, TERM, VALUE = "name", "term", "value"
RESPONSE, OFFSET, WEIGHT, UID = "response", "offset", "weight", "uid"
META_DATA_MAP = "metadataMap"


def _id_from_record(rec: dict, id_type: str) -> str:
    """Top-level field first, then metadataMap
    (DataProcessingUtils.scala:91-115)."""
    v = rec.get(id_type)
    if v is None or v == "":
        meta = rec.get(META_DATA_MAP) or {}
        v = meta.get(id_type)
        if v is None:
            raise ValueError(
                f"Cannot find id in either record field {id_type!r} or in "
                f"metadataMap with key {id_type!r}")
    return str(v)


def game_dataset_from_records(
        records: Sequence[dict],
        feature_shard_sections: dict[str, Sequence[str]],
        index_maps: dict[str, IndexMap],
        id_types: Sequence[str] = (),
        response_required: bool = True) -> GameDataset:
    """Decoded GAME records (dicts in the Avro record shape) ->
    :class:`GameDataset`: feature-key probing, duplicate detection,
    intercept append and CSR canonicalization, as the JAX package's
    interpreted loop does them."""
    n = len(records)
    responses = np.full(n, np.nan)
    offsets = np.zeros(n)
    weights = np.ones(n)
    uids: Optional[list] = [] if any(
        r.get(UID) is not None for r in records) else None

    shard_builders = {
        shard: ([], [], []) for shard in feature_shard_sections}
    id_values: dict[str, list] = {t: [] for t in id_types}
    intercepts = {shard: index_maps[shard].intercept_index
                  for shard in feature_shard_sections}
    for i, rec in enumerate(records):
        if rec.get(RESPONSE) is not None:
            responses[i] = float(rec[RESPONSE])
        elif response_required:
            raise ValueError(f"record {i} has no response field")
        if rec.get(OFFSET) is not None:
            offsets[i] = float(rec[OFFSET])
        if rec.get(WEIGHT) is not None:
            weights[i] = float(rec[WEIGHT])
        if uids is not None:
            uids.append("" if rec.get(UID) is None else str(rec[UID]))
        for t in id_types:
            id_values[t].append(_id_from_record(rec, t))
        for shard, sections in feature_shard_sections.items():
            imap = index_maps[shard]
            rows, cols, vals = shard_builders[shard]
            seen = set()
            for section in sections:
                entries = rec.get(section)
                if entries is None:
                    raise ValueError(
                        f"record {i}: feature section {section!r} is not a "
                        f"list (or is null)")
                for f in entries:
                    key = feature_key(f[NAME], f.get(TERM) or "")
                    j = imap.index_of(key)
                    if j < 0:
                        continue
                    if j in seen:
                        raise ValueError(
                            f"Duplicate feature {key!r} in record {i} for "
                            f"shard {shard!r}")
                    seen.add(j)
                    rows.append(i)
                    cols.append(j)
                    vals.append(
                        0.0 if f[VALUE] is None else float(f[VALUE]))
            if intercepts[shard] is not None:
                rows.append(i)
                cols.append(intercepts[shard])
                vals.append(1.0)

    shards = {}
    for shard, (rows, cols, vals) in shard_builders.items():
        d = len(index_maps[shard])
        shards[shard] = sp.csr_matrix(
            (np.asarray(vals), (np.asarray(rows, np.int64),
                                np.asarray(cols, np.int64))),
            shape=(n, d))

    ds = GameDataset(responses=responses, feature_shards=shards,
                     offsets=offsets, weights=weights)
    for t in id_types:
        ds.encode_ids(t, np.asarray(id_values[t], dtype=object))
    if uids is not None:
        ds.uids = np.asarray(uids, dtype=object)
    return ds


def _records(paths: Sequence[str], policy=None) -> Iterable[dict]:
    """The records of the part files of ``paths`` (files, or directories
    of parts), one file decoded at a time; with ``policy`` a corrupt or
    unreadable part is quarantined and skipped."""
    files: list[str] = []
    for p in paths:
        files.extend(list_avro_parts(p) if os.path.isdir(p) else [p])
    if policy is not None:
        policy.begin(len(files))
    for f in files:
        out = read_shard(f, policy=policy)
        if out is not None:
            yield from out[1]


def load_game_dataset_avro(
        path: str | Sequence[str],
        feature_shard_sections: dict[str, Sequence[str]],
        index_maps: dict[str, IndexMap],
        id_types: Sequence[str] = (),
        response_required: bool = True,
        policy=None) -> GameDataset:
    """Avro records -> columnar :class:`GameDataset`. ``path`` is a file,
    a directory of part files, or a list of them (the dated
    daily-partition layout resolves to several directories). ``policy``
    (an :class:`~photon_ml_tpu_torch.data.ingest.IngestPolicy`) skips a
    corrupt or unreadable part file instead of failing the load, within
    its loss budget."""
    records = list(_records([path] if isinstance(path, str) else path,
                            policy))
    return game_dataset_from_records(
        records, feature_shard_sections, index_maps,
        id_types=id_types, response_required=response_required)


class NameAndTermFeatureSets:
    """Per-section (name, term) sets -> index maps; text save/load
    (avro/data/NameAndTermFeatureSetContainer.scala:38-127)."""

    def __init__(self, sets: dict[str, set[tuple[str, str]]]):
        self.sets = sets

    @staticmethod
    def from_records(records: Iterable[dict],
                     section_keys: Sequence[str]) -> "NameAndTermFeatureSets":
        sets: dict[str, set[tuple[str, str]]] = {
            k: set() for k in section_keys}
        for rec in records:
            for k in section_keys:
                for f in rec.get(k) or []:
                    sets[k].add((f[NAME], f.get(TERM) or ""))
        return NameAndTermFeatureSets(sets)

    @staticmethod
    def from_paths(paths: Sequence[str], section_keys: Sequence[str],
                   policy=None) -> "NameAndTermFeatureSets":
        """Feature-map scan over data files, one part file decoded at a
        time (GAMEDriver.prepareFeatureMapsDefault's distinct() scan);
        ``policy`` quarantines corrupt or unreadable parts."""
        return NameAndTermFeatureSets.from_records(_records(paths, policy),
                                                   section_keys)

    def index_map(self, section_keys: Sequence[str],
                  add_intercept: bool) -> IndexMap:
        """Union of the sections' features -> one map
        (getFeatureNameAndTermToIndexMap :46-58)."""
        pairs = set()
        for k in section_keys:
            pairs |= self.sets.get(k, set())
        return IndexMap.from_name_terms(sorted(pairs),
                                        add_intercept=add_intercept)

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        for section, pairs in self.sets.items():
            with open(os.path.join(directory, section), "w") as fh:
                for name, term in sorted(pairs):
                    fh.write(f"{name}\t{term}\n")

    @staticmethod
    def load(directory: str,
             section_keys: Sequence[str]) -> "NameAndTermFeatureSets":
        sets: dict[str, set[tuple[str, str]]] = {}
        for section in section_keys:
            pairs = set()
            with open(os.path.join(directory, section)) as fh:
                for line in fh:
                    line = line.rstrip("\n")
                    if not line:
                        continue
                    parts = line.split("\t")
                    if len(parts) == 1:
                        pairs.add((parts[0], ""))
                    elif len(parts) == 2:
                        pairs.add((parts[0], parts[1]))
                    else:
                        raise ValueError(
                            f"Unexpected entry {line!r}: expected 1 or 2 "
                            f"tab-separated tokens, found {len(parts)}")
            sets[section] = pairs
        return NameAndTermFeatureSets(sets)

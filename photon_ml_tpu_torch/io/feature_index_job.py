"""Feature indexing job: build partitioned on-disk index maps from data.

Port of ``photon_ml_tpu/io/feature_index_job.py`` — ``build_feature_index``
and ``load_feature_index`` (reference: FeatureIndexingJob.scala:90-204):
scan the input Avro for its distinct (name, term) feature keys, per
feature shard over that shard's sections (GAME) or over the legacy
``features`` field, and write the partitioned JSON store and, with
``offheap=True``, the memmap-served ``OffHeapIndexMap`` store that the
drivers read through ``--offheap-indexmap-dir``. The scan is the
drivers' own feature-map scan (``NameAndTermFeatureSets.from_paths``:
the native columnar decoder, the records path for a part it declines),
so a store holds the keys of the map a driver builds from the same data,
with the same indices.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from photon_ml_tpu_torch.io.data_format import (
    FieldNames,
    NameAndTermFeatureSets,
)
from photon_ml_tpu_torch.io.index_map import IndexMap, OffHeapIndexMap


def build_feature_index(
        input_path: str, output_dir: str,
        feature_shard_sections: Optional[dict[str, Sequence[str]]] = None,
        field_names: Optional[FieldNames] = None,
        add_intercept: bool = True, num_partitions: int = 1,
        offheap: bool = False) -> dict[str, IndexMap]:
    """Distinct feature keys of ``input_path`` (a file, a directory of
    part files, or a comma-separated list of them) -> partitioned stores
    under ``output_dir``, one namespace per map: ``"global"`` over the
    legacy ``field_names.features`` field, and each shard id of
    ``feature_shard_sections`` over the union of its sections. Returns the
    in-RAM maps by namespace."""
    paths = [p for p in input_path.split(",") if p]
    sections = sorted({s for secs in (feature_shard_sections or {}).values()
                       for s in secs}
                      | ({field_names.features} if field_names else set()))
    sets = NameAndTermFeatureSets.from_paths(paths, sections)
    wanted = dict(feature_shard_sections or {})
    if field_names is not None:
        wanted = {"global": [field_names.features], **wanted}
    out: dict[str, IndexMap] = {}
    for namespace, secs in wanted.items():
        imap = sets.index_map(secs, add_intercept=add_intercept)
        imap.save(output_dir, num_partitions, namespace=namespace)
        if offheap:
            imap.save_offheap(output_dir, num_partitions,
                              namespace=namespace)
        out[namespace] = imap
    return out


def load_feature_index(directory: str, namespaces: Sequence[str],
                       offheap: Optional[bool] = None,
                       expected_partitions: Optional[int] = None) -> dict:
    """Stores written by :func:`build_feature_index` (PalDBIndexMapLoader
    analog). ``offheap=None`` detects: a namespace with an off-heap meta
    file loads as an :class:`OffHeapIndexMap`, else its JSON store is read
    into an ``IndexMap``. ``expected_partitions`` is checked against each
    off-heap store's meta."""
    out: dict = {}
    for ns in namespaces:
        has_offheap = os.path.exists(
            os.path.join(directory, f"{ns}-offheap-meta.json"))
        use = has_offheap if offheap is None else offheap
        out[ns] = (OffHeapIndexMap(directory, namespace=ns,
                                   expected_partitions=expected_partitions)
                   if use else IndexMap.load(directory, namespace=ns))
    return out

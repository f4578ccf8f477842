"""Ingestion: Avro -> columnar ``GameDataset``, feature sets, and the
legacy single-GLM loaders (Avro and LibSVM -> ``LabeledData``).

Port of the GAME ingestion of ``photon_ml_tpu/io/data_format.py``, both of
its paths (avro/data/DataProcessingUtils.scala:57-215,
avro/data/NameAndTermFeatureSetContainer.scala:38-127). Per record: one
sparse row per feature shard (the union of its feature sections),
response/offset/weight, id columns from top-level fields or
``metadataMap``, the intercept appended when the shard's index map
carries the intercept key.

- The native columnar path, which every load and feature scan takes
  first: ``_columnar_part_paths`` (``:128``), ``_QUARANTINED`` and
  ``_columnar_part_or_quarantine`` (``:155-197``, the framing probe and
  the ``io.avro_read`` retry), ``_feature_col_ok`` (``:200``),
  ``_unique_name_terms`` (``:215``), ``_feature_triples`` (``:235``),
  ``_columnar_game_dataset`` (``:613-805``), the dispatch of
  ``load_game_dataset_avro`` (``:899-943``) and the columnar scan of
  ``NameAndTermFeatureSets.from_paths`` (``:970-1016``). Part files are
  decoded one at a time by ``io/native_avro.py``.
- The records path, the plain version: ``_id_from_record``
  (``:599-610``), ``game_dataset_from_records`` (``:808-896``),
  :func:`load_game_dataset_records` and
  ``NameAndTermFeatureSets.from_records``. An input goes down it whole
  when a part's schema is outside the native decoder's subset
  (``read_columnar`` returns None) or a column the columnar assembly
  cannot take (a nullable feature section, a numeric uid, a float id),
  exactly where the JAX package sends it; a failed build of the native
  library raises instead. :data:`INGEST_STATS` counts the parts each path
  read.

With an ingest policy (``data/ingest.py``) either path quarantines a
corrupt or unreadable part file within the loss budget. The saved
feature sets load under the ``io.index_map`` fault point with retry
(``:1036-1048``).

The legacy single-GLM loaders (``:59-137``, ``:251-598``; io/GLMSuite
.scala:98-260, io/LibSVMInputDataFormat.scala:31-77): ``InputFormatType``,
``FieldNames``, ``LabeledData``, ``load_selected_features``,
``build_index_map_from_records``, ``load_labeled_points_avro`` (the
native columnar assembly ``_columnar_labeled_points`` first; a part it
declines sends the whole input to the records loop, counted in
:data:`INGEST_STATS` as for GAME), ``load_libsvm`` (every file through the
port's native parser, ``csrc/host/libsvm_parser.cpp``, unless custom
delimiters ask for the Python loop, the plain version; the intercept is
the last column) and ``parse_constraint_map`` (the box-constraint JSON
with its wildcard rules).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from typing import Iterable, Optional, Sequence

import numpy as np
import scipy.sparse as sp

from photon_ml_tpu_torch.game.dataset import GameDataset
from photon_ml_tpu_torch.io.avro import (
    check_container_framing,
    list_avro_parts,
    read_shard,
)
from photon_ml_tpu_torch.io.avro import read_records
from photon_ml_tpu_torch.io.index_map import (
    DELIMITER,
    INTERCEPT_KEY,
    IndexMap,
    feature_key,
)
from photon_ml_tpu_torch.io.native_avro import (
    OP_LONG,
    OP_STRING,
    arena_strings,
    read_columnar,
)
from photon_ml_tpu_torch.utils.faults import fault_point
from photon_ml_tpu_torch.utils.retry import (
    RetryExhaustedError,
    call_with_retry,
)

# Avro field names (avro/AvroFieldNames.scala:21-28).
NAME, TERM, VALUE = "name", "term", "value"
RESPONSE, OFFSET, WEIGHT, UID = "response", "offset", "weight", "uid"
META_DATA_MAP = "metadataMap"

#: part files decoded by the native columnar path, declines (a part that
#: sent its whole input down the records path) and part files read by the
#: records path, since the last :func:`reset_ingest_stats`
INGEST_STATS = {"native_parts": 0, "declined_parts": 0, "records_parts": 0}


def reset_ingest_stats() -> None:
    for k in INGEST_STATS:
        INGEST_STATS[k] = 0


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


# ---------------------------------------------------------------------------
# The native columnar path
# ---------------------------------------------------------------------------


def _columnar_part_paths(path: str) -> list[str]:
    """Part files of a file-or-directory input (the records reader's set)."""
    if os.path.isdir(path):
        return list_avro_parts(path)
    return [path]


#: "this shard was quarantined: skip it and keep the native path" (distinct
#: from None, "outside the decoder's subset: read the input as records")
_QUARANTINED = object()


def _columnar_part_or_quarantine(path: str, policy):
    """``read_columnar`` under the degraded-ingest protocol: the columnar
    part, ``None`` for a shape the native decoder does not cover (the
    caller reads the whole input as records), or :data:`_QUARANTINED`
    when the shard was lost to the policy.

    The native decoder declines corrupt framing with ``None`` instead of
    raising (the records reader owns the diagnostics), so on a None with a
    policy active the container framing is probed once, without decoding
    a record, to tell a corrupt shard (quarantine it, keep the native
    path for the rest) from an unsupported schema (read as records)."""
    def attempt():
        fault_point("io.avro_read", tag=os.path.basename(path), path=path)
        return read_columnar(path)

    try:
        part = call_with_retry(attempt, site="io.avro_read")
    except (RetryExhaustedError, ValueError, FileNotFoundError) as e:
        if policy is None:
            raise
        policy.quarantine(path, stage=("decode" if isinstance(e, ValueError)
                                       else "open"), error=e)
        return _QUARANTINED
    if part is None and policy is not None:
        # the probe opens the file again, under the same retry as every
        # other open: a transient EIO mid-probe must not quarantine a
        # healthy but unsupported shard
        try:
            call_with_retry(lambda: check_container_framing(path),
                            site="io.shard_open")
        except (RetryExhaustedError, ValueError, FileNotFoundError) as e:
            policy.quarantine(path,
                              stage=("decode" if isinstance(e, ValueError)
                                     else "open"), error=e)
            return _QUARANTINED
        return None
    if part is not None and policy is not None:
        policy.record_ok(path)
    return part


def _feature_col_ok(col) -> bool:
    """A feature array column :func:`_feature_triples` can take: record
    items with string name/term (interned codes) and a numeric value."""
    if col is None or "subs" not in col:
        return False
    subs = col["subs"]
    if any(k not in subs for k in (NAME, TERM, VALUE)):
        return False
    if any(subs[k].get("op") != OP_STRING for k in (NAME, TERM)):
        return False
    return subs[VALUE].get("op") != OP_STRING


def _unique_name_terms(subs, with_inverse: bool = True):
    """Interned name/term sub-columns -> (per-entry unique-pair ids,
    unique (name, term) pair list). ``with_inverse=False`` (the feature
    scan) skips the per-entry inverse."""
    name_codes = subs[NAME]["codes"].astype(np.int64)
    name_uniq = subs[NAME]["uniq"]
    term_codes = subs[TERM]["codes"]
    term_uniq = subs[TERM]["uniq"]
    nt = max(len(term_uniq), 1)
    pair = name_codes * nt + term_codes
    if with_inverse:
        upair, inv_p = np.unique(pair, return_inverse=True)
    else:
        upair, inv_p = np.unique(pair), None
    upairs = [(str(name_uniq[p // nt]), str(term_uniq[p % nt]))
              for p in upair]
    return inv_p, upairs


def _feature_triples(col, num_prior_rows_total: int):
    """array<record> feature column -> (row of each entry, unique-key id
    of each entry, the unique keys, values). Keys are composed once per
    unique (name, term) pair; the per-entry work is integer arithmetic."""
    lengths = col["lengths"]
    values = col["subs"][VALUE]["values"]
    rows = np.repeat(
        np.arange(len(lengths), dtype=np.int64) + num_prior_rows_total,
        lengths)
    inv_p, upairs = _unique_name_terms(col["subs"])
    ukeys = [feature_key(n, t) for n, t in upairs]
    return rows, inv_p, ukeys, values


def _columnar_game_dataset(
        paths: Sequence[str],
        feature_shard_sections: dict[str, Sequence[str]],
        index_maps: dict[str, IndexMap],
        id_types: Sequence[str],
        response_required: bool,
        policy=None) -> Optional[GameDataset]:
    """GAME assembly from native columnar reads, part by part, so that
    peak memory is the largest part plus the assembled CSR; None sends
    the input down the records path. Each part's feature keys are mapped
    through the index maps as it streams by."""
    sections_needed = sorted({s for secs in feature_shard_sections.values()
                              for s in secs})
    resp_parts, off_parts, wt_parts, uids_parts = [], [], [], []
    have_uid = False
    ids_parts: dict[str, list] = {t: [] for t in id_types}
    # per shard: filtered (rows, cols, vals) triples, index-mapped per part
    shard_acc: dict[str, list] = {s: [] for s in feature_shard_sections}
    base = 0
    part_files = [f for p in paths for f in _columnar_part_paths(p)]
    if policy is not None:
        policy.begin(len(part_files))
    for pf in part_files:
        part = _columnar_part_or_quarantine(pf, policy)
        if part is _QUARANTINED:
            continue  # shard lost; the others keep streaming
        if part is None:
            INGEST_STATS["declined_parts"] += 1
            return None
        schema, count, cols = part
        if not _columns_supported(schema, cols, sections_needed, id_types,
                                  response_required):
            INGEST_STATS["declined_parts"] += 1
            return None

        r = cols.get(RESPONSE)
        if r is not None and "values" in r:
            vals = r["values"].copy()
            null_mask = r["nulls"] == 1
            if response_required and null_mask.any():
                raise ValueError(
                    f"record {base + int(np.argmax(null_mask))} has no "
                    f"response field")
            vals[null_mask] = np.nan
            resp_parts.append(np.asarray(vals, dtype=float))
        elif response_required:
            raise ValueError(f"record {base} has no response field")
        else:
            resp_parts.append(np.full(count, np.nan))
        off = cols.get(OFFSET)
        off_parts.append(np.asarray(off["values"], dtype=float)
                         if off is not None and "values" in off
                         else np.zeros(count))
        wt = cols.get(WEIGHT)
        wt_parts.append(np.where(wt["nulls"] == 1, 1.0, wt["values"])
                        if wt is not None and "values" in wt
                        else np.ones(count))
        u = cols.get(UID)
        if u is not None and "arena" in u:
            s = arena_strings(u["arena"], u["offsets"], dedup=False)
            if (u["nulls"] == 0).any():
                have_uid = True
            s[u["nulls"] == 1] = ""
            uids_parts.append(s)
        else:
            uids_parts.append(np.full(count, "", dtype=object))

        ids_local = _part_ids(cols, count, id_types)
        for t in id_types:
            ids_parts[t].append(ids_local[t])

        for shard, sections in feature_shard_sections.items():
            imap = index_maps[shard]
            for sec in sections:
                rows, keyid, ukeys, values = _feature_triples(
                    cols[sec], base)
                ucol = np.asarray([imap.index_of(k) for k in ukeys],
                                  np.int64)
                c = ucol[keyid]
                ok = c >= 0
                shard_acc[shard].append((rows[ok], c[ok], values[ok]))
        base += count
        INGEST_STATS["native_parts"] += 1
    if base == 0 and not part_files:
        return None

    n = base
    responses = (np.concatenate(resp_parts) if resp_parts
                 else np.full(0, np.nan))
    offsets = np.concatenate(off_parts) if off_parts else np.zeros(0)
    weights = np.concatenate(wt_parts) if wt_parts else np.ones(0)
    ids_obj = {t: (np.concatenate(ids_parts[t]) if ids_parts[t]
                   else np.zeros(0, dtype=object)) for t in id_types}
    for t in id_types:
        missing = np.asarray([v is None for v in ids_obj[t]])
        if missing.any():
            raise ValueError(
                f"Cannot find id in either record field {t!r} or in "
                f"metadataMap with key {t!r}")

    shards = {}
    for shard, acc in shard_acc.items():
        imap = index_maps[shard]
        rows = (np.concatenate([a[0] for a in acc]) if acc
                else np.zeros(0, np.int64))
        cvec = (np.concatenate([a[1] for a in acc]) if acc
                else np.zeros(0, np.int64))
        vals = np.concatenate([a[2] for a in acc]) if acc else np.zeros(0)
        d = len(imap)
        rc = rows * np.int64(d) + cvec
        if len(np.unique(rc)) != len(rc):
            raise ValueError(
                f"Duplicate feature in a record for shard {shard!r}")
        intercept_idx = imap.intercept_index
        if intercept_idx is not None:
            rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
            cvec = np.concatenate(
                [cvec, np.full(n, intercept_idx, np.int64)])
            vals = np.concatenate([vals, np.ones(n)])
        shards[shard] = sp.csr_matrix((vals, (rows, cvec)), shape=(n, d))

    ds = GameDataset(responses=responses, feature_shards=shards,
                     offsets=offsets, weights=weights)
    for t in id_types:
        ds.encode_ids(t, np.asarray([str(v) for v in ids_obj[t]],
                                    dtype=object))
    if have_uid:
        ds.uids = np.concatenate(uids_parts).astype(object)
    return ds


def _columns_supported(schema, cols, sections_needed, id_types,
                       response_required) -> bool:
    """Whether the columnar assembly takes a decoded part; where it does
    not, the records path keeps its own semantics (per-record errors for
    a null section, ``str()`` of a numeric uid or a float id)."""
    field_types = {f["name"]: f["type"]
                   for f in (schema.get("fields", [])
                             if isinstance(schema, dict) else [])}
    for sec in sections_needed:
        if not _feature_col_ok(cols.get(sec)):
            return False
        if isinstance(field_types.get(sec), list):
            return False  # a nullable section
    u = cols.get(UID)
    if u is not None and "arena" not in u:
        return False  # a numeric uid
    for aux in (OFFSET, WEIGHT):
        c = cols.get(aux)
        if c is not None and "values" not in c:
            return False
    # top-level ids: strings, or integer columns (str(int) is the records
    # path's str(v) exactly); float ids are read as records
    for t in id_types:
        c = cols.get(t)
        if c is not None and "arena" not in c and c.get("op") != OP_LONG:
            return False
    return not (response_required and (RESPONSE not in cols
                                       or "values" not in cols[RESPONSE]))


def _part_ids(cols, count: int, id_types) -> dict:
    """id type -> object array of each row's raw id (None where the part
    has none): the top-level field first, then ``metadataMap``."""
    ids_local = {t: np.full(count, None, dtype=object) for t in id_types}
    for t in id_types:
        c = cols.get(t)
        if c is None:
            continue
        if "arena" in c:
            s = arena_strings(c["arena"], c["offsets"])
            ok = (c["nulls"] == 0) & (s != "")
            ids_local[t][ok] = s[ok]
        elif "values" in c:
            iv = c["values"].astype(np.int64)
            uniq, inv = np.unique(iv, return_inverse=True)
            s = np.asarray([str(int(u)) for u in uniq], dtype=object)[inv]
            ok = c["nulls"] == 0
            ids_local[t][ok] = s[ok]
    m = cols.get(META_DATA_MAP)
    if m is not None and "key_codes" in m:
        pair_rows = np.repeat(np.arange(count, dtype=np.int64), m["lengths"])
        key_uniq = m["key_uniq"]
        for t in id_types:
            matches = np.flatnonzero(key_uniq == t)
            if len(matches) == 0:
                continue
            hit = m["key_codes"] == matches[0]
            if hit.any():
                rows_t = pair_rows[hit]
                vals_t = m["val_uniq"][m["val_codes"][hit]]
                still = np.asarray(
                    [ids_local[t][rr] is None for rr in rows_t])
                # later map entries win, as dict construction does
                ids_local[t][rows_t[still]] = vals_t[still]
    return ids_local


# ---------------------------------------------------------------------------
# The records path
# ---------------------------------------------------------------------------


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
    files = [f for p in paths for f in _columnar_part_paths(p)]
    if policy is not None:
        policy.begin(len(files))
    for f in files:
        out = read_shard(f, policy=policy)
        INGEST_STATS["records_parts"] += 1
        if out is not None:
            yield from out[1]


def load_game_dataset_records(
        paths: Sequence[str],
        feature_shard_sections: dict[str, Sequence[str]],
        index_maps: dict[str, IndexMap],
        id_types: Sequence[str] = (),
        response_required: bool = True,
        policy=None) -> GameDataset:
    """The records path of :func:`load_game_dataset_avro`: every record
    decoded to a dict, then :func:`game_dataset_from_records`."""
    return game_dataset_from_records(
        list(_records(paths, policy)), feature_shard_sections, index_maps,
        id_types=id_types, response_required=response_required)


def load_game_dataset_avro(
        path: str | Sequence[str],
        feature_shard_sections: dict[str, Sequence[str]],
        index_maps: dict[str, IndexMap],
        id_types: Sequence[str] = (),
        response_required: bool = True,
        policy=None) -> GameDataset:
    """Avro records -> columnar :class:`GameDataset`. ``path`` is a file,
    a directory of part files, or a list of them (the dated
    daily-partition layout resolves to several directories). The native
    columnar path reads it unless a part declines, and then the records
    path reads all of it. ``policy`` (an
    :class:`~photon_ml_tpu_torch.data.ingest.IngestPolicy`) skips a
    corrupt or unreadable part file instead of failing the load, within
    its loss budget, on either path."""
    paths = [path] if isinstance(path, str) else list(path)
    fast = _columnar_game_dataset(paths, feature_shard_sections,
                                  index_maps, id_types, response_required,
                                  policy=policy)
    if fast is not None:
        return fast
    return load_game_dataset_records(
        paths, feature_shard_sections, index_maps, id_types=id_types,
        response_required=response_required, policy=policy)


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
        time (GAMEDriver.prepareFeatureMapsDefault's distinct() scan): on
        the native path the unique name/term tables of each part are the
        sets, and no per-entry string is built; a part that declines sends
        the scan to the records path. ``policy`` quarantines corrupt or
        unreadable parts."""
        files = [f for p in paths for f in _columnar_part_paths(p)]
        sets: dict[str, set[tuple[str, str]]] = {
            k: set() for k in section_keys}
        if policy is not None:
            policy.begin(len(files))
        for f in files:
            part = _columnar_part_or_quarantine(f, policy)
            if part is _QUARANTINED:
                continue
            cols = None if part is None else part[2]
            if cols is None or not all(_feature_col_ok(cols.get(k))
                                       for k in section_keys):
                INGEST_STATS["declined_parts"] += 1
                return NameAndTermFeatureSets.from_records(
                    _records(paths, policy), section_keys)
            for k in section_keys:
                _, upairs = _unique_name_terms(cols[k]["subs"],
                                               with_inverse=False)
                sets[k].update(upairs)
            INGEST_STATS["native_parts"] += 1
        if not files:
            return NameAndTermFeatureSets.from_records(
                _records(paths, policy), section_keys)
        return NameAndTermFeatureSets(sets)

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
        """The sets :meth:`save` wrote. They are required state, so a
        lost file is not quarantined; transient I/O retries (the
        ``io.index_map`` fault point) and a persistent failure raises
        ``RetryExhaustedError``, which the drivers end with exit 3."""
        def attempt():
            fault_point("io.index_map", tag=os.path.basename(directory))
            return NameAndTermFeatureSets._load_once(directory,
                                                     section_keys)

        return call_with_retry(attempt, site="io.index_map")

    @staticmethod
    def _load_once(directory: str,
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


# ---------------------------------------------------------------------------
# The legacy single-GLM loaders (GLMSuite, LibSVMInputDataFormat)
# ---------------------------------------------------------------------------

WILDCARD = "*"  # io/GLMSuite.scala:377


class InputFormatType(enum.Enum):
    """io/InputFormatType.scala analog."""

    AVRO = "AVRO"
    LIBSVM = "LIBSVM"


@dataclasses.dataclass(frozen=True)
class FieldNames:
    """avro/FieldNames.scala:23-29 analog."""

    features: str = "features"
    response: str = "label"
    offset: str = "offset"
    weight: str = "weight"


TRAINING_EXAMPLE_FIELD_NAMES = FieldNames(response="label")
RESPONSE_PREDICTION_FIELD_NAMES = FieldNames(response="response")


@dataclasses.dataclass
class LabeledData:
    """Columnar legacy dataset (the RDD[LabeledPoint] analog)."""

    features: sp.csr_matrix  # [N, D]
    labels: np.ndarray  # [N]
    offsets: np.ndarray  # [N]
    weights: np.ndarray  # [N]
    index_map: IndexMap

    @property
    def num_samples(self) -> int:
        return self.features.shape[0]

    @property
    def dim(self) -> int:
        return self.features.shape[1]


def load_selected_features(path: str) -> set[str]:
    """Selected-features Avro file -> set of feature keys
    (io/GLMSuite.scala:141-149)."""
    return {feature_key(r[NAME], r.get(TERM) or "")
            for r in read_records(path)}


def build_index_map_from_records(
        records: Iterable[dict],
        field_names: FieldNames = TRAINING_EXAMPLE_FIELD_NAMES,
        selected_features: Optional[set[str]] = None,
        add_intercept: bool = True) -> IndexMap:
    """Sorted distinct feature keys (filtered by ``selected_features``
    when given: an empty set selects nothing), the intercept last when
    asked (io/GLMSuite.scala:159-205)."""
    keys: set[str] = set()
    for rec in records:
        for f in rec.get(field_names.features) or []:
            key = feature_key(f[NAME], f.get(TERM) or "")
            if selected_features is None or key in selected_features:
                keys.add(key)
    return IndexMap.from_keys(sorted(keys), add_intercept=add_intercept)


def _labeled_columns_ok(cols, field_names: FieldNames) -> bool:
    """Whether the columnar assembly takes a decoded legacy part; a null
    response, a feature column of another shape or a string offset or
    weight goes to the records loop, which has its own semantics."""
    r = cols.get(field_names.response)
    if r is None or "values" not in r:
        return False
    if r.get("nulls") is not None and r["nulls"].any():
        return False  # the records loop raises on a null response
    if not _feature_col_ok(cols.get(field_names.features)):
        return False
    return all(c is None or "values" in c
               for c in (cols.get(field_names.offset),
                         cols.get(field_names.weight)))


def _columnar_labeled_points(
        path: str,
        field_names: FieldNames,
        index_map: Optional[IndexMap],
        selected: Optional[set],
        add_intercept: bool) -> Optional[LabeledData]:
    """``LabeledData`` assembled from native columnar reads, one part file
    at a time (``data_format.py:251-343``); None when a part declines, and
    the caller then reads the whole input as records."""
    lab_parts, off_parts, wt_parts = [], [], []
    all_rows, all_keyid, all_vals = [], [], []
    key_tables = []
    keys_before = 0
    base = 0
    parts = _columnar_part_paths(path)
    for pf in parts:
        part = read_columnar(pf)
        if part is None or not _labeled_columns_ok(part[2], field_names):
            INGEST_STATS["declined_parts"] += 1
            return None
        _, count, cols = part
        lab_parts.append(np.asarray(cols[field_names.response]["values"],
                                    dtype=float))
        off = cols.get(field_names.offset)
        off_parts.append(np.asarray(off["values"], dtype=float)  # null: 0
                         if off is not None else np.zeros(count))
        wt = cols.get(field_names.weight)
        wt_parts.append(np.where(wt["nulls"] == 1, 1.0, wt["values"])
                        if wt is not None else np.ones(count))
        rows, keyid, ukeys, values = _feature_triples(
            cols[field_names.features], base)
        all_rows.append(rows)
        all_keyid.append(keyid + keys_before)
        all_vals.append(values)
        key_tables.append(ukeys)
        keys_before += len(ukeys)
        base += count
        INGEST_STATS["native_parts"] += 1
    if not parts:
        return None

    n = base
    labels = np.concatenate(lab_parts)
    offsets = np.concatenate(off_parts)
    weights = np.concatenate(wt_parts)
    rows = np.concatenate(all_rows)
    keyid = np.concatenate(all_keyid)
    vals = np.concatenate(all_vals)
    ukeys: list[str] = [k for t in key_tables for k in t]
    kept = (np.asarray([k in selected for k in ukeys], bool)
            if selected is not None else np.ones(len(ukeys), bool))
    if index_map is None:
        index_map = IndexMap.from_keys(
            [k for k, keep in zip(ukeys, kept) if keep],
            add_intercept=add_intercept)
    ucol = np.asarray([index_map.index_of(k) if keep else -1
                       for k, keep in zip(ukeys, kept)], np.int64)
    cols_of = ucol[keyid]
    ok = cols_of >= 0
    rows, cols_of, vals = rows[ok], cols_of[ok], vals[ok]

    d = len(index_map)
    rc = rows * np.int64(d) + cols_of
    if len(np.unique(rc)) != len(rc):
        raise ValueError("Duplicate feature in a record (same name+term "
                         "appears twice)")
    intercept_idx = index_map.intercept_index
    if intercept_idx is not None:
        rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
        cols_of = np.concatenate(
            [cols_of, np.full(n, intercept_idx, np.int64)])
        vals = np.concatenate([vals, np.ones(n)])
    features = sp.csr_matrix((vals, (rows, cols_of)), shape=(n, d))
    return LabeledData(features, labels, offsets, weights, index_map)


def labeled_points_from_records(
        records: Sequence[dict],
        field_names: FieldNames = TRAINING_EXAMPLE_FIELD_NAMES,
        index_map: Optional[IndexMap] = None,
        selected: Optional[set] = None,
        add_intercept: bool = True) -> LabeledData:
    """The records loop of :func:`load_labeled_points_avro`
    (``data_format.py:369-413``), the plain version of the columnar
    assembly."""
    if index_map is None:
        index_map = build_index_map_from_records(
            records, field_names, selected, add_intercept)
    n, d = len(records), len(index_map)
    labels = np.zeros(n)
    offsets = np.zeros(n)
    weights = np.ones(n)
    rows, cols, vals = [], [], []
    intercept_idx = index_map.intercept_index
    for i, rec in enumerate(records):
        labels[i] = float(rec[field_names.response])
        if rec.get(field_names.offset) is not None:
            offsets[i] = float(rec[field_names.offset])
        if rec.get(field_names.weight) is not None:
            weights[i] = float(rec[field_names.weight])
        seen = set()
        for f in rec.get(field_names.features) or []:
            key = feature_key(f[NAME], f.get(TERM) or "")
            # the selected-features filter holds with a given map too
            if selected is not None and key not in selected:
                continue
            j = index_map.index_of(key)
            if j < 0:
                continue
            if j in seen:
                raise ValueError(f"Duplicate feature {key!r} in record {i}")
            seen.add(j)
            rows.append(i)
            cols.append(j)
            vals.append(0.0 if f[VALUE] is None else float(f[VALUE]))
        if intercept_idx is not None:
            rows.append(i)
            cols.append(intercept_idx)
            vals.append(1.0)
    features = sp.csr_matrix(
        (np.asarray(vals), (np.asarray(rows, np.int64),
                            np.asarray(cols, np.int64))),
        shape=(n, d))
    return LabeledData(features, labels, offsets, weights, index_map)


def load_labeled_points_avro(
        path: str,
        field_names: FieldNames = TRAINING_EXAMPLE_FIELD_NAMES,
        index_map: Optional[IndexMap] = None,
        selected_features_file: Optional[str] = None,
        add_intercept: bool = True) -> LabeledData:
    """Legacy Avro ingestion (io/GLMSuite.scala:98-137): sparse features
    through the index map (built from the data when not given), the
    intercept column set to 1 when the map carries it, offset and weight
    defaults 0 and 1. The native columnar path reads the input unless a
    part declines; then the records loop reads all of it."""
    selected = (load_selected_features(selected_features_file)
                if selected_features_file else None)
    fast = _columnar_labeled_points(path, field_names, index_map, selected,
                                    add_intercept)
    if fast is not None:
        return fast
    records = list(_records([path]))
    return labeled_points_from_records(records, field_names, index_map,
                                       selected, add_intercept)


def _libsvm_paths(path: str) -> list[str]:
    """A file, or a directory's files but the hidden and underscored ones
    (``_SUCCESS``, ``.crc``)."""
    if os.path.isdir(path):
        return [os.path.join(path, p) for p in sorted(os.listdir(path))
                if not p.startswith((".", "_"))]
    return [path]


def load_libsvm(path: str, feature_dimension: int,
                use_intercept: bool = True, zero_based: bool = False,
                delim: str = " ", idx_value_delim: str = ":",
                binarize_labels: bool = True) -> LabeledData:
    """LibSVM text -> ``LabeledData`` (``data_format.py:425-508``): labels
    binarized (> 0 -> 1) unless ``binarize_labels`` is false, the
    intercept in the last column when enabled. The default delimiters go
    through the native parser; custom ones through :func:`libsvm_python`."""
    paths = _libsvm_paths(path)
    if delim != " " or idx_value_delim != ":" or not paths:
        return libsvm_python(paths, feature_dimension, use_intercept,
                             zero_based, delim, idx_value_delim,
                             binarize_labels)
    from photon_ml_tpu_torch.io.native_loader import parse_libsvm_native

    mats, labels_all = [], []
    for p in paths:
        raw_labels, mat, dim = parse_libsvm_native(p, zero_based)
        if dim > feature_dimension:
            raise ValueError(
                f"feature index {dim - 1 + (0 if zero_based else 1)} out of "
                f"range for feature_dimension={feature_dimension} "
                f"(zero_based={zero_based})")
        n = mat.shape[0]
        mat = sp.csr_matrix((mat.data, mat.indices, mat.indptr),
                            shape=(n, feature_dimension))
        if use_intercept:
            mat = sp.hstack([mat, np.ones((n, 1))], format="csr")
        mats.append(mat)
        labels_all.append((raw_labels > 0).astype(np.float64)
                          if binarize_labels
                          else np.asarray(raw_labels, np.float64))
    features = sp.vstack(mats, format="csr") if len(mats) > 1 else mats[0]
    return _libsvm_labeled_data(features, np.concatenate(labels_all),
                                feature_dimension, use_intercept)


def libsvm_python(paths: Sequence[str], feature_dimension: int,
                  use_intercept: bool = True, zero_based: bool = False,
                  delim: str = " ", idx_value_delim: str = ":",
                  binarize_labels: bool = True) -> LabeledData:
    """The Python row loop of ``load_libsvm`` (``data_format.py:451-493``),
    the plain version of the native parser: the default delimiter is any
    run of whitespace, a custom one splits literally."""
    true_dim = feature_dimension + 1 if use_intercept else feature_dimension
    labels_list: list[float] = []
    rows, cols, vals = [], [], []
    i = 0
    for p in paths:
        with open(p) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                ts = line.split() if delim == " " else line.split(delim)
                label = float(ts[0])
                labels_list.append((1.0 if label > 0 else 0.0)
                                   if binarize_labels else label)
                for item in ts[1:]:
                    item = item.strip()
                    if not item:
                        continue
                    idx_s, val_s = item.split(idx_value_delim)
                    idx = int(idx_s) - (0 if zero_based else 1)
                    if not 0 <= idx < feature_dimension:
                        raise ValueError(
                            f"feature index {idx_s} out of range for "
                            f"feature_dimension={feature_dimension} "
                            f"(zero_based={zero_based})")
                    rows.append(i)
                    cols.append(idx)
                    vals.append(float(val_s))
                if use_intercept:
                    rows.append(i)
                    cols.append(true_dim - 1)
                    vals.append(1.0)
                i += 1
    features = sp.csr_matrix(
        (np.asarray(vals), (np.asarray(rows, np.int64),
                            np.asarray(cols, np.int64))),
        shape=(len(labels_list), true_dim))
    return _libsvm_labeled_data(features, np.asarray(labels_list),
                                feature_dimension, use_intercept)


def _libsvm_labeled_data(features: sp.csr_matrix, labels: np.ndarray,
                         feature_dimension: int,
                         use_intercept: bool) -> LabeledData:
    """``LabeledData`` with the IdentityIndexMapLoader map, the intercept
    last when enabled."""
    if use_intercept:
        keys = {str(i): i for i in range(feature_dimension)}
        keys[INTERCEPT_KEY] = feature_dimension
        index_map = IndexMap(keys)
    else:
        index_map = IndexMap.identity(feature_dimension)
    n = features.shape[0]
    return LabeledData(features, labels, np.zeros(n), np.ones(n), index_map)


def parse_constraint_map(constraint_string: Optional[str],
                         index_map: IndexMap
                         ) -> Optional[dict[int, tuple[float, float]]]:
    """JSON list of ``{name, term, lowerBound?, upperBound?}`` -> bounds
    by index, with the reference's wildcard rules
    (io/GLMSuite.scala:207-260): (*, *) bounds every feature but the
    intercept and must be the only entry; (name, *) bounds every term of
    ``name``; a wildcard name needs a wildcard term."""
    if not constraint_string:
        return None
    out: dict[int, tuple[float, float]] = {}
    for entry in json.loads(constraint_string):
        name = entry["name"]
        term = entry["term"]
        lo = float(entry.get("lowerBound", -np.inf))
        hi = float(entry.get("upperBound", np.inf))
        if not (np.isfinite(lo) or np.isfinite(hi)):
            raise ValueError(
                f"constraint for ({name}, {term}) has -Inf/+Inf bounds")
        if lo >= hi:
            raise ValueError(
                f"lower bound {lo} >= upper bound {hi} for ({name}, {term})")
        if name == WILDCARD:
            if term != WILDCARD:
                raise ValueError("wildcard name requires wildcard term")
            if out:
                raise ValueError(
                    "(*, *) constraint must be the only constraint")
            for key, idx in index_map.items():
                if key != INTERCEPT_KEY:
                    out[idx] = (lo, hi)
        elif term == WILDCARD:
            prefix = name + DELIMITER
            for key, idx in index_map.items():
                if key.startswith(prefix):
                    if idx in out:
                        raise ValueError(
                            f"conflicting bounds for feature {key!r}")
                    out[idx] = (lo, hi)
        else:
            key = feature_key(name, term)
            if key in index_map:
                idx = index_map.index_of(key)
                if idx in out:
                    raise ValueError(
                        f"conflicting bounds for feature {key!r}")
                out[idx] = (lo, hi)
    return out or None

"""GAME / GLM model files and scored items — the reference's on-disk contract.

Port of ``photon_ml_tpu/io/model_io.py`` — ``glm_to_record``/
``record_to_glm`` (``:80-143``), ``save_game_model``/``load_game_model``
for fixed-effect and random-effect coordinates (``:161-326``; raw,
projected and factored random effects, all written in raw space through
``to_raw()``, ``:184-186``; a matrix-factorization model is refused with
the JAX package's ``TypeError``, ``:228-235``),
``save_matrix_factorization_model``/``load_matrix_factorization_model``
(LatentFactorAvro, ``:330-385``: ``<dir>/<effectType>/part-*.avro``, one
record per entity, ``effectId`` and ``latentFactor``) and
``save_scored_items``/``load_scored_items`` (``:392-476``). The directory
layout (ModelProcessingUtils.scala:44-106)::

    <dir>/fixed-effect/<name>/id-info                  (1 line: featureShardId)
    <dir>/fixed-effect/<name>/coefficients/part-00000.avro
    <dir>/random-effect/<name>/id-info                 (2 lines: reType, shardId)
    <dir>/random-effect/<name>/coefficients/part-*.avro

Coefficient files hold ``BayesianLinearModelAvro`` records (one per fixed
effect, modelId "fixed-effect"; one per entity, modelId = raw entity id)
with the JVM model class name the reference reflects on. Records are the
JAX package's byte for byte; only the random sync marker of each file
differs. Scores are encoded block by block by the port's native encoder
(``csrc/host/score_encoder.cpp`` through ``io/native_loader.py``), as in
the JAX package; ``save_scored_items_records`` is the plain version.
The legacy driver's text models, ``write_models_text`` and
``read_models_text`` (``:484-530``, util/IOUtils.scala:207-247), write
and read the JAX package's TSV files: one ``part-<i>.txt`` per model,
``name\tterm\tvalue\tlambda`` rows by coefficient value descending.
"""

from __future__ import annotations

import io
import logging
import os
import zlib
from typing import Iterable, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro import (
    DEFAULT_SYNC_INTERVAL,
    SYNC_SIZE,
    BinaryEncoder,
    _names_index,
    compile_writer,
    parse_schema,
    read_directory,
    read_records,
    write_container,
    write_container_header,
)
from photon_ml_tpu_torch.io.index_map import (
    IndexMap,
    feature_key,
    split_feature_key,
)
from photon_ml_tpu_torch.io.native_loader import encode_scores_native
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.optimize.config import TaskType

logger = logging.getLogger(__name__)

# Directory-layout constants (reference avro/Constants.scala:22-25).
ID_INFO = "id-info"
COEFFICIENTS = "coefficients"
FIXED_EFFECT = "fixed-effect"
RANDOM_EFFECT = "random-effect"
DEFAULT_AVRO_FILE_NAME = "part-00000.avro"

# JVM class-name interop (avro/AvroUtils.scala:208 setModelClass /
# :231 Class.forName), written verbatim both ways.
_MODEL_CLASS_BY_TASK = {
    TaskType.LOGISTIC_REGRESSION:
        "com.linkedin.photon.ml.supervised.classification."
        "LogisticRegressionModel",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
        "com.linkedin.photon.ml.supervised.classification."
        "SmoothedHingeLossLinearSVMModel",
    TaskType.LINEAR_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.LinearRegressionModel",
    TaskType.POISSON_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.PoissonRegressionModel",
}
_TASK_BY_MODEL_CLASS = {v: k for k, v in _MODEL_CLASS_BY_TASK.items()}


def _host64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float64)


def _vector_to_name_term_values(vec: np.ndarray, index_map: IndexMap
                                ) -> list[dict]:
    """Sparse (name, term, value) entries for the nonzeros of ``vec``
    (avro/AvroUtils.scala convertVectorAsArrayOfNameTermValueAvros)."""
    out = []
    for idx in np.flatnonzero(vec):
        key = index_map.key_of(int(idx))
        if key is None:
            continue
        name, term = split_feature_key(key)
        out.append({"name": name, "term": term, "value": float(vec[idx])})
    return out


def glm_to_record(model_id: str, model: GeneralizedLinearModel,
                  index_map: IndexMap) -> dict:
    """BayesianLinearModelAvro dict for one GLM
    (avro/AvroUtils.scala:172-194)."""
    record = {
        "modelId": model_id,
        "modelClass": _MODEL_CLASS_BY_TASK[model.task],
        "means": _vector_to_name_term_values(
            _host64(model.coefficients.means), index_map),
        "variances": None,
        "lossFunction": "",
    }
    if model.coefficients.variances is not None:
        record["variances"] = _vector_to_name_term_values(
            _host64(model.coefficients.variances), index_map)
    return record


def record_to_glm(record: dict, index_map: Optional[IndexMap] = None,
                  load_variances: bool = False,
                  default_task: TaskType = TaskType.LINEAR_REGRESSION
                  ) -> tuple[GeneralizedLinearModel, IndexMap]:
    """Rebuild a GLM (f32 CPU tensors) from a BayesianLinearModelAvro dict
    (avro/AvroUtils.scala:203-241). Without an index map, a compact one is
    built from the record's own features (the load-without-index
    contract)."""
    if index_map is None:
        keys = [feature_key(f["name"], f["term"]) for f in record["means"]]
        keys += [feature_key(f["name"], f["term"])
                 for f in record.get("variances") or []]
        index_map = IndexMap.from_keys(keys)

    def dense(entries) -> torch.Tensor:
        v = np.zeros(len(index_map))
        for f in entries:
            j = index_map.index_of(feature_key(f["name"], f["term"]))
            if j >= 0:
                v[j] = f["value"]
        return torch.from_numpy(v.astype(np.float32))

    variances = None
    if load_variances and record.get("variances"):
        variances = dense(record["variances"])
    task = _TASK_BY_MODEL_CLASS.get(record.get("modelClass") or "",
                                    default_task)
    return GeneralizedLinearModel(
        Coefficients(means=dense(record["means"]), variances=variances),
        task), index_map


def _write_id_info(path: str, lines: list[str]) -> None:
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _read_id_info(path: str) -> list[str]:
    with open(path) as fh:
        return [ln for ln in fh.read().splitlines() if ln]


def save_game_model(model, output_dir: str,
                    index_maps: dict[str, IndexMap],
                    entity_vocabs: Optional[dict[str, np.ndarray]] = None,
                    num_output_files: int = 1,
                    task: TaskType = TaskType.LINEAR_REGRESSION) -> None:
    """Write a GameModel in the reference's directory layout.

    ``entity_vocabs[reType]`` maps the dataset's entity codes to raw ids
    for random-effect coordinates whose models still hold codes; a model
    that carries ``entity_ids`` needs no vocab.
    """
    from photon_ml_tpu_torch.game.models import (
        FactoredRandomEffectModel,
        FixedEffectModel,
        MatrixFactorizationModel,
        RandomEffectModel,
        RandomEffectModelInProjectedSpace,
    )

    for name, sub in model.models.items():
        if isinstance(sub, (RandomEffectModelInProjectedSpace,
                            FactoredRandomEffectModel)):
            sub = sub.to_raw()
        if isinstance(sub, FixedEffectModel):
            out = os.path.join(output_dir, FIXED_EFFECT, name)
            os.makedirs(os.path.join(out, COEFFICIENTS), exist_ok=True)
            _write_id_info(os.path.join(out, ID_INFO), [sub.feature_shard_id])
            record = glm_to_record(FIXED_EFFECT, sub.model,
                                   index_maps[sub.feature_shard_id])
            write_container(
                os.path.join(out, COEFFICIENTS, DEFAULT_AVRO_FILE_NAME),
                schemas.BAYESIAN_LINEAR_MODEL, [record])
        elif isinstance(sub, RandomEffectModel):
            out = os.path.join(output_dir, RANDOM_EFFECT, name)
            os.makedirs(os.path.join(out, COEFFICIENTS), exist_ok=True)
            _write_id_info(os.path.join(out, ID_INFO),
                           [sub.random_effect_type, sub.feature_shard_id])
            index_map = index_maps[sub.feature_shard_id]
            coefs = _host64(sub.coefficients)
            if sub.entity_ids is not None:
                raw_ids = np.asarray(sub.entity_ids)
            else:
                vocab = (entity_vocabs or {}).get(sub.random_effect_type)
                if vocab is None:
                    raise ValueError(
                        f"random effect '{name}' has no entity_ids and no "
                        f"vocab for '{sub.random_effect_type}' was passed")
                raw_ids = np.asarray(vocab)[np.asarray(sub.entity_codes)]
            records = [
                {"modelId": str(raw_ids[e]),
                 "modelClass": _MODEL_CLASS_BY_TASK[task],
                 "means": _vector_to_name_term_values(coefs[e], index_map),
                 "variances": None, "lossFunction": ""}
                for e in range(coefs.shape[0])]
            # partitioned output (numberOfOutputFilesForRandomEffectModel)
            chunks = np.array_split(np.arange(len(records)),
                                    max(1, num_output_files))
            for part, idxs in enumerate(chunks):
                if len(chunks) > 1 and len(idxs) == 0:
                    continue
                write_container(
                    os.path.join(out, COEFFICIENTS, f"part-{part:05d}.avro"),
                    schemas.BAYESIAN_LINEAR_MODEL,
                    [records[i] for i in idxs])
        elif isinstance(sub, MatrixFactorizationModel):
            # a GAME directory has no place a load would find it again
            raise TypeError(
                f"coordinate '{name}': MatrixFactorizationModel is saved "
                f"separately via save_matrix_factorization_model(), not in "
                f"the GAME model directory")
        else:
            raise TypeError(f"cannot serialize coordinate model {type(sub)}")


def load_game_model(input_dir: str,
                    index_maps: Optional[dict[str, IndexMap]] = None,
                    task: TaskType = TaskType.LINEAR_REGRESSION):
    """Load a GameModel directory (ModelProcessingUtils.scala:106-170).
    Returns ``(GameModel, {shardId: IndexMap})``; index maps are rebuilt
    compactly from the model files when not provided. Random-effect models
    come back with their raw ``entity_ids``."""
    from photon_ml_tpu_torch.game.models import (
        FixedEffectModel,
        GameModel,
        RandomEffectModel,
    )

    index_maps = dict(index_maps or {})
    models: dict = {}

    fixed_dir = os.path.join(input_dir, FIXED_EFFECT)
    if os.path.isdir(fixed_dir):
        for name in sorted(os.listdir(fixed_dir)):
            inner = os.path.join(fixed_dir, name)
            (shard_id,) = _read_id_info(os.path.join(inner, ID_INFO))
            _, records = read_directory(os.path.join(inner, COEFFICIENTS))
            glm, imap = record_to_glm(records[0], index_maps.get(shard_id),
                                      load_variances=True,
                                      default_task=task)
            index_maps.setdefault(shard_id, imap)
            models[name] = FixedEffectModel(glm, shard_id)

    re_dir = os.path.join(input_dir, RANDOM_EFFECT)
    empty_shards: dict = {}  # shard_id -> first empty coordinate seen
    if os.path.isdir(re_dir):
        for name in sorted(os.listdir(re_dir)):
            inner = os.path.join(re_dir, name)
            re_type, shard_id = _read_id_info(os.path.join(inner, ID_INFO))
            # no coefficients dir: a valid empty coordinate (zero entities)
            coeff_dir = os.path.join(inner, COEFFICIENTS)
            records = (read_directory(coeff_dir)[1]
                       if os.path.isdir(coeff_dir) else [])
            imap = index_maps.get(shard_id)
            if imap is None:
                keys = sorted({feature_key(f["name"], f["term"])
                               for r in records for f in r["means"]})
                imap = IndexMap.from_keys(keys)
                if records:
                    index_maps[shard_id] = imap
                else:
                    empty_shards.setdefault(shard_id, name)
            # per-entity variances are not loaded, as in the reference
            rows = [record_to_glm(r, imap, default_task=task)[0]
                    .coefficients.means for r in records]
            coefs = (torch.stack(rows) if rows
                     else torch.zeros((0, len(imap)), dtype=torch.float32))
            models[name] = RandomEffectModel(
                random_effect_type=re_type,
                feature_shard_id=shard_id,
                entity_codes=np.arange(len(records)),
                coefficients=coefs,
                entity_ids=np.asarray([r["modelId"] for r in records],
                                      dtype=object))

    for shard_id, name in empty_shards.items():
        if shard_id not in index_maps:
            logger.warning(
                "random-effect coordinate %r is empty and no index map was "
                "supplied for feature shard %r; the shard is omitted from "
                "the returned index maps", name, shard_id)

    if not models:
        raise FileNotFoundError(f"no models under {input_dir}")
    return GameModel(models), index_maps


def save_matrix_factorization_model(
        model, output_dir: str,
        entity_vocabs: Optional[dict[str, np.ndarray]] = None,
        num_output_files: int = 1) -> None:
    """``<dir>/<rowEffectType>/part-*.avro`` and the same for the column
    effect, LatentFactorAvro records (ModelProcessingUtils.scala:375-400).
    A factor row's id is the model's own ``row_ids``/``col_ids``, else the
    ``entity_vocabs`` entry of its code, else the code itself."""
    for effect_type, factors, ids in (
            (model.row_effect_type, model.row_factors, model.row_ids),
            (model.col_effect_type, model.col_factors, model.col_ids)):
        out = os.path.join(output_dir, effect_type)
        os.makedirs(out, exist_ok=True)
        arr = _host64(factors)
        if ids is None:
            vocab = (entity_vocabs or {}).get(effect_type)
            if vocab is not None and len(vocab) < len(arr):
                raise ValueError(
                    f"entity vocab for '{effect_type}' has {len(vocab)} "
                    f"entries but the factor table has {len(arr)} rows")
            ids = (np.asarray(vocab)[:len(arr)] if vocab is not None
                   else np.arange(len(arr)))
        records = [{"effectId": str(ids[i]),
                    "latentFactor": [float(v) for v in arr[i]]}
                   for i in range(len(arr))]
        chunks = np.array_split(np.arange(len(records)),
                                max(1, num_output_files))
        for part, idxs in enumerate(chunks):
            write_container(os.path.join(out, f"part-{part:05d}.avro"),
                            schemas.LATENT_FACTOR,
                            [records[i] for i in idxs])


def load_matrix_factorization_model(input_dir: str, row_effect_type: str,
                                    col_effect_type: str):
    """The model :func:`save_matrix_factorization_model` wrote (or the JAX
    package's), with f32 CPU tables and the raw ids of their rows
    (ModelProcessingUtils.scala:413-430)."""
    from photon_ml_tpu_torch.game.models import MatrixFactorizationModel

    tables = {}
    for effect_type in (row_effect_type, col_effect_type):
        _, records = read_directory(os.path.join(input_dir, effect_type))
        ids = np.asarray([r["effectId"] for r in records], dtype=object)
        factors = (np.asarray([r["latentFactor"] for r in records],
                              np.float32)
                   if records else np.zeros((0, 0), np.float32))
        tables[effect_type] = (ids, torch.from_numpy(factors))
    row_ids, row_factors = tables[row_effect_type]
    col_ids, col_factors = tables[col_effect_type]
    return MatrixFactorizationModel(
        row_effect_type=row_effect_type, col_effect_type=col_effect_type,
        row_factors=row_factors, col_factors=col_factors,
        row_ids=row_ids, col_ids=col_ids)


def save_scored_items(path: str, scores, model_id: str,
                      uids: Optional[Iterable] = None,
                      labels: Optional[np.ndarray] = None,
                      weights: Optional[np.ndarray] = None) -> None:
    """ScoringResultAvro output (avro/data/ScoreProcessingUtils.scala),
    one deflate block per ``DEFAULT_SYNC_INTERVAL`` records, each block's
    records encoded by the native encoder (``model_io.py:390-430``). An
    encoder that refuses a block raises; nothing switches writers."""
    def encode(lo, hi, uid_arr):
        raw = encode_scores_native(
            scores[lo:hi], model_id,
            uids=None if uid_arr is None else uid_arr[lo:hi],
            labels=None if labels is None else labels[lo:hi],
            weights=None if weights is None else weights[lo:hi])
        if raw is None:
            raise RuntimeError(f"the native score encoder refused records "
                               f"{lo}:{hi} of {path}")
        return raw

    scores = _host64(scores)
    uid_arr = None if uids is None else np.asarray(
        [str(u) for u in uids], dtype=object)
    _write_scored_blocks(path, len(scores), encode, uid_arr)


def save_scored_items_records(path: str, scores, model_id: str,
                              uids: Optional[Iterable] = None,
                              labels: Optional[np.ndarray] = None,
                              weights: Optional[np.ndarray] = None) -> None:
    """The plain version of :func:`save_scored_items`: the same blocks,
    each record encoded by the Avro writer from a dict."""
    schema = parse_schema(schemas.SCORING_RESULT)
    writer = compile_writer(schema, _names_index(schema))

    def encode(lo, hi, uid_list):
        buf = io.BytesIO()
        enc = BinaryEncoder(buf)
        for i in range(lo, hi):
            writer(enc, {
                "uid": None if uid_list is None else uid_list[i],
                "label": None if labels is None else float(labels[i]),
                "modelId": model_id,
                "predictionScore": float(scores[i]),
                "weight": None if weights is None else float(weights[i]),
                "metadataMap": None})
        return buf.getvalue()

    scores = _host64(scores)
    _write_scored_blocks(path, len(scores), encode,
                         None if uids is None else [str(u) for u in uids])


def _write_scored_blocks(path: str, n: int, encode, uids) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blocks = []
    for lo in range(0, n, DEFAULT_SYNC_INTERVAL):
        hi = min(lo + DEFAULT_SYNC_INTERVAL, n)
        blocks.append((hi - lo, encode(lo, hi, uids)))
    _write_container_raw(path, schemas.SCORING_RESULT, blocks)


def _write_container_raw(path: str, schema, blocks: list) -> None:
    """Container framing around already-encoded record streams, one Avro
    block per (count, record_bytes) entry (``model_io.py:443-472``)."""
    schema = parse_schema(schema)
    sync = os.urandom(SYNC_SIZE)
    with open(path, "wb") as fh:
        write_container_header(fh, schema, "deflate", sync)
        for count, record_bytes in blocks:
            if not count:
                continue
            packed = zlib.compress(record_bytes)[2:-1]  # raw deflate
            head = io.BytesIO()
            henc = BinaryEncoder(head)
            henc.write_long(count)
            henc.write_long(len(packed))
            fh.write(head.getvalue())
            fh.write(packed)
            fh.write(sync)


def load_scored_items(path: str) -> list[dict]:
    return read_records(path)


# ---------------------------------------------------------------------------
# Legacy text models (util/IOUtils.scala:207-247)
# ---------------------------------------------------------------------------


def write_models_text(output_dir: str,
                      models: Iterable[tuple[float, GeneralizedLinearModel]],
                      index_map: IndexMap) -> None:
    """One ``part-<i>.txt`` per ``(lambda, model)``:
    ``name\tterm\tvalue\tlambda`` rows, largest coefficient first."""
    os.makedirs(output_dir, exist_ok=True)
    for part, (reg_weight, model) in enumerate(models):
        means = model.coefficients.means.detach().cpu().numpy().astype(
            np.float64)
        lines = []
        for idx in np.argsort(-means, kind="stable"):
            key = index_map.key_of(int(idx))
            if key is None:
                continue
            name, term = split_feature_key(key)
            lines.append(f"{name}\t{term}\t{means[idx]}\t{reg_weight}")
        with open(os.path.join(output_dir, f"part-{part:05d}.txt"),
                  "w") as fh:
            fh.write("\n".join(lines) + "\n")


def read_models_text(input_dir: str, index_map: Optional[IndexMap] = None,
                     task: TaskType = TaskType.LINEAR_REGRESSION,
                     device=DEFAULT_DEVICE
                     ) -> list[tuple[float, GeneralizedLinearModel]]:
    """``(lambda, model)`` of each ``.txt`` file, f32 means on ``device``,
    indexed by ``index_map`` or by the files' sorted feature keys."""
    device = resolve_device(device)
    out = []
    for fname in sorted(os.listdir(input_dir)):
        if not fname.endswith(".txt"):
            continue
        entries = []
        with open(os.path.join(input_dir, fname)) as fh:
            for line in fh:
                if not line.strip():
                    continue
                name, term, value, lam = line.rstrip("\n").split("\t")
                entries.append((name, term, float(value), float(lam)))
        if not entries:
            continue
        imap = index_map or IndexMap.from_keys(
            [feature_key(n, t) for n, t, _, _ in entries])
        means = np.zeros(len(imap))
        for name, term, value, _ in entries:
            key = feature_key(name, term)
            if key in imap:
                means[imap.index_of(key)] = value
        out.append((entries[0][3], GeneralizedLinearModel(
            Coefficients(torch.as_tensor(means, dtype=torch.float32,
                                         device=device)), task)))
    return out

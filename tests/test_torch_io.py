"""PyTorch port vs the JAX package: Avro, feature maps, GAME ingestion, model
and score files.

Small inputs made from a seed with numpy:

- the port's Avro writer and reader round-trip the GAME training, model
  (BayesianLinearModelAvro) and score (ScoringResultAvro) schemas, and a
  file written by either package decodes to the same records in the other;
  the record bytes of a container are the same from both writers;
- ``NameAndTermFeatureSets`` and the ``IndexMap`` built from the same Avro
  are equal, the intercept index included, and so is a saved set dir
  read back by the other package;
- ``load_game_dataset_avro`` gives a ``GameDataset`` equal array for array
  (``np.array_equal`` on canonical CSR, responses, offsets, weights, id
  columns and vocabularies, uids);
- ``glm_to_record`` gives the same record in both packages, and each
  package's ``record_to_glm`` reads it back to the same f32 values;
- scored items written by either package read back the same in both.
"""

import os
import zlib

import jax
import numpy as np
import pytest
import torch

from photon_ml_tpu.io import avro as javro
from photon_ml_tpu.io import data_format as jdf
from photon_ml_tpu.io import model_io as jio
from photon_ml_tpu.io import schemas as jschemas
from photon_ml_tpu.models.glm import Coefficients as JCoefficients
from photon_ml_tpu.models.glm import GeneralizedLinearModel as JGLM
from photon_ml_tpu.optimize.config import TaskType as JTask
from photon_ml_tpu_torch.io import avro as tavro
from photon_ml_tpu_torch.io import data_format as tdf
from photon_ml_tpu_torch.io import model_io as tio
from photon_ml_tpu_torch.io import schemas as tschemas
from photon_ml_tpu_torch.models.glm import Coefficients as TCoefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel as TGLM
from photon_ml_tpu_torch.optimize.config import TaskType as TTask

SECTIONS = {"global": ["globalFeatures"], "user": ["userFeatures"],
            "both": ["globalFeatures", "userFeatures"]}


def game_schema(schemas):
    return {
        "name": "GameRecord", "type": "record", "namespace": "t",
        "fields": [
            {"name": "uid", "type": ["null", "string"], "default": None},
            {"name": "response", "type": "double"},
            {"name": "offset", "type": ["null", "double"], "default": None},
            {"name": "weight", "type": ["null", "double"], "default": None},
            {"name": "metadataMap",
             "type": ["null", {"type": "map", "values": "string"}],
             "default": None},
            {"name": "globalFeatures",
             "type": {"type": "array", "items": schemas.FEATURE}},
            {"name": "userFeatures",
             "type": {"type": "array", "items": "FeatureAvro"}},
        ],
    }


def game_records(n=120, seed=3):
    """GAME rows with sparse, termed features, optional offsets/weights
    and ids both top-level-less (metadataMap) and repeated."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = rng.choice(12, size=rng.integers(1, 6), replace=False)
        u = rng.choice(5, size=rng.integers(0, 3), replace=False)
        out.append({
            "uid": None if i % 17 == 5 else f"r{i}",
            "response": float(rng.integers(0, 2)),
            "offset": None if i % 3 else float(rng.normal()),
            "weight": None if i % 4 else float(rng.uniform(0.5, 2)),
            "metadataMap": {"userId": f"u{rng.integers(0, 9)}",
                            "movieId": str(rng.integers(0, 4))},
            "globalFeatures": [
                {"name": f"g{j // 4}", "term": f"t{j % 4}",
                 "value": float(rng.normal())} for j in g],
            "userFeatures": [
                {"name": f"m{j}", "term": "", "value": 1.0} for j in u],
        })
    return out


def model_records(n=6, seed=4):
    rng = np.random.default_rng(seed)
    return [{"modelId": f"e{i}",
             "modelClass": "com.linkedin.photon.ml.supervised."
                           "classification.LogisticRegressionModel",
             "means": [{"name": f"f{j}", "term": "t" * (j % 2),
                        "value": float(rng.normal())}
                       for j in range(rng.integers(0, 5))],
             "variances": None if i % 2 else [
                 {"name": "f0", "term": "", "value": float(rng.uniform())}],
             "lossFunction": ""} for i in range(n)]


def score_records(n=50, seed=5):
    rng = np.random.default_rng(seed)
    return [{"uid": f"s{i}", "label": None if i % 7 == 0 else 1.0,
             "modelId": "m", "predictionScore": float(rng.normal()),
             "weight": float(rng.uniform()), "metadataMap": None}
            for i in range(n)]


CASES = {
    "game": (game_schema, game_records),
    "model": (lambda s: s.BAYESIAN_LINEAR_MODEL, model_records),
    "score": (lambda s: s.SCORING_RESULT, score_records),
}
WRITERS = {"jax": (javro, jschemas), "torch": (tavro, tschemas)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("codec", ["deflate", "null"])
def test_avro_round_trips_across_packages(tmp_path, case, writer, codec):
    schema_of, records_of = CASES[case]
    avro, schemas = WRITERS[writer]
    records = records_of()
    path = str(tmp_path / "f.avro")
    avro.write_container(path, schema_of(schemas), records, codec=codec,
                         sync_interval=16)
    _, jrecs = javro.read_container(path)
    _, trecs = tavro.read_container(path)
    assert jrecs == trecs == records


def _blocks(path):
    """(count, decompressed record bytes) per block of a container."""
    buf = open(path, "rb").read()
    dec = javro.BinaryDecoder(buf, 4)
    while True:
        count = dec.read_long()
        if count == 0:
            break
        for _ in range(count):
            dec.read_string()
            dec.read_bytes()
    header_end = dec.pos
    dec.pos += javro.SYNC_SIZE
    out = []
    while dec.pos < len(buf):
        count, size = dec.read_long(), dec.read_long()
        out.append((count, zlib.decompress(buf[dec.pos:dec.pos + size],
                                           -15)))
        dec.pos += size + javro.SYNC_SIZE
    return buf[:header_end], out


def test_writers_emit_the_same_bytes(tmp_path):
    records = game_records()
    paths = {}
    for name, (avro, schemas) in WRITERS.items():
        paths[name] = str(tmp_path / f"{name}.avro")
        avro.write_container(paths[name], game_schema(schemas), records,
                             sync_interval=32)
    assert _blocks(paths["jax"]) == _blocks(paths["torch"])


@pytest.fixture(scope="module")
def game_avro(tmp_path_factory):
    d = tmp_path_factory.mktemp("io")
    os.makedirs(d / "parts")
    recs = game_records()
    for i, lo in enumerate(range(0, len(recs), 50)):
        tavro.write_container(str(d / "parts" / f"part-{i:05d}.avro"),
                              game_schema(tschemas), recs[lo:lo + 50])
    return str(d / "parts")


@pytest.mark.parametrize("intercept", [True, False])
def test_feature_sets_and_index_maps_agree(game_avro, tmp_path, intercept):
    keys = ["globalFeatures", "userFeatures"]
    jsets = jdf.NameAndTermFeatureSets.from_paths([game_avro], keys)
    tsets = tdf.NameAndTermFeatureSets.from_paths([game_avro], keys)
    assert jsets.sets == tsets.sets
    for shard, secs in SECTIONS.items():
        jm = jsets.index_map(secs, add_intercept=intercept)
        tm = tsets.index_map(secs, add_intercept=intercept)
        assert dict(jm.items()) == dict(tm.items()), shard
        assert jm.intercept_index == tm.intercept_index
        assert (tm.intercept_index is not None) == intercept
    # a saved set directory reads back the same in the other package
    tsets.save(str(tmp_path / "t"))
    jsets.save(str(tmp_path / "j"))
    assert jdf.NameAndTermFeatureSets.load(
        str(tmp_path / "t"), keys).sets == tsets.sets
    assert tdf.NameAndTermFeatureSets.load(
        str(tmp_path / "j"), keys).sets == jsets.sets


def _same_dataset(a, b):
    assert np.array_equal(a.responses, b.responses, equal_nan=True)
    assert np.array_equal(a.offsets, b.offsets)
    assert np.array_equal(a.weights, b.weights)
    assert sorted(a.feature_shards) == sorted(b.feature_shards)
    for k in a.feature_shards:
        ma, mb = a.feature_shards[k], b.feature_shards[k]
        assert ma.has_canonical_format and mb.has_canonical_format
        assert ma.shape == mb.shape
        for attr in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(ma, attr), getattr(mb, attr)), k
    assert sorted(a.id_columns) == sorted(b.id_columns)
    for t in a.id_columns:
        assert np.array_equal(a.id_columns[t], b.id_columns[t])
        assert np.array_equal(a.id_vocabs[t], b.id_vocabs[t])
    assert np.array_equal(a.uids, b.uids)


@pytest.mark.parametrize("response_required", [True, False])
def test_load_game_dataset_avro_agrees(game_avro, response_required):
    keys = ["globalFeatures", "userFeatures"]
    maps = {}
    for shard, secs in SECTIONS.items():
        maps[shard] = tdf.NameAndTermFeatureSets.from_paths(
            [game_avro], keys).index_map(secs, add_intercept=shard != "user")
    jdata = jdf.load_game_dataset_avro(
        [game_avro], SECTIONS, maps, id_types=["movieId", "userId"],
        response_required=response_required)
    tdata = tdf.load_game_dataset_avro(
        [game_avro], SECTIONS, maps, id_types=["movieId", "userId"],
        response_required=response_required)
    _same_dataset(jdata, tdata)
    assert tdata.num_samples == 120
    assert tdata.feature_shards["global"].shape[1] == len(maps["global"])


def test_game_dataset_from_records_refuses_duplicates():
    rec = game_records(n=1)[0]
    rec["globalFeatures"] = rec["globalFeatures"][:1] * 2
    imap = tdf.NameAndTermFeatureSets.from_records(
        [rec], ["globalFeatures"]).index_map(["globalFeatures"], True)
    with pytest.raises(ValueError, match="Duplicate feature"):
        tdf.game_dataset_from_records([rec], {"g": ["globalFeatures"]},
                                      {"g": imap})


def test_glm_records_agree_and_read_back_exactly():
    rng = np.random.default_rng(6)
    keys = ["a\u0001", "a\u0001x", "b\u0001", "(INTERCEPT)\u0001"]
    from photon_ml_tpu.io.index_map import IndexMap as JIndexMap
    from photon_ml_tpu_torch.io.index_map import IndexMap as TIndexMap

    jmap, tmap = JIndexMap.from_keys(keys), TIndexMap.from_keys(keys)
    means = rng.normal(size=4).astype(np.float32)
    means[1] = 0.0
    var = rng.uniform(size=4).astype(np.float32)
    with jax.enable_x64(False):
        jrec = jio.glm_to_record("m", JGLM(JCoefficients(
            jax.numpy.asarray(means), jax.numpy.asarray(var)),
            JTask.LOGISTIC_REGRESSION), jmap)
    trec = tio.glm_to_record("m", TGLM(TCoefficients(
        torch.from_numpy(means), torch.from_numpy(var)),
        TTask.LOGISTIC_REGRESSION), tmap)
    assert jrec == trec
    assert len(trec["means"]) == 3
    tglm, _ = tio.record_to_glm(trec, tmap, load_variances=True)
    assert tglm.task == TTask.LOGISTIC_REGRESSION
    assert np.array_equal(tglm.coefficients.means.numpy(), means)
    assert np.array_equal(tglm.coefficients.variances.numpy(), var)
    # without an index map: a compact one from the record's own features
    tglm2, imap2 = tio.record_to_glm(trec)
    assert len(imap2) == 4


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_scored_items_cross_read(tmp_path, writer):
    rng = np.random.default_rng(8)
    n = 16_005  # two blocks at the 16,000-record sync interval
    scores = rng.normal(size=n)
    uids = [f"u{i}" for i in range(n)]
    labels = rng.integers(0, 2, n).astype(np.float64)
    weights = rng.uniform(size=n)
    path = str(tmp_path / "scores" / "part-00000.avro")
    mod = jio if writer == "jax" else tio
    mod.save_scored_items(path, scores, "mid", uids=uids, labels=labels,
                          weights=weights)
    jrecs = jio.load_scored_items(path)
    trecs = tio.load_scored_items(path)
    assert jrecs == trecs
    assert [r["predictionScore"] for r in trecs] == scores.tolist()
    assert [r["uid"] for r in trecs] == uids
    assert trecs[0]["modelId"] == "mid"
    assert len(_blocks(path)[1]) == 2


@pytest.mark.parametrize("text", [
    "userId,user,1", "userId,user,4,128", "userId,user,1,128,-",
    "userId,user,1,-1,3,0.5", "u,s,2,10,none,2.5,index_map"])
def test_random_effect_data_configuration_parse(text):
    from photon_ml_tpu.game.dataset import (
        RandomEffectDataConfiguration as J)
    from photon_ml_tpu_torch.game.dataset import (
        RandomEffectDataConfiguration as T)

    j, t = J.parse(text), T.parse(text)
    for f in ("random_effect_type", "feature_shard_id", "num_partitions",
              "num_active_data_points_upper_bound",
              "num_passive_data_points_lower_bound",
              "num_features_to_samples_ratio_upper_bound",
              "num_features_to_keep_upper_bound"):
        assert getattr(j, f) == getattr(t, f), f
    assert j.projector.kind.value == t.projector.kind.value


@pytest.mark.parametrize("text", ["global", "global,4", " g , 2 "])
def test_fixed_effect_data_configuration_parse(text):
    from photon_ml_tpu.game.dataset import FixedEffectDataConfiguration as J
    from photon_ml_tpu_torch.game.dataset import (
        FixedEffectDataConfiguration as T)

    j, t = J.parse(text), T.parse(text)
    assert (j.feature_shard_id, j.min_num_partitions) == (
        t.feature_shard_id, t.min_num_partitions)


def test_recode_ids_follows_another_vocabulary():
    from photon_ml_tpu_torch.game.dataset import GameDataset

    data = GameDataset(responses=np.zeros(5), feature_shards={})
    data.encode_ids("u", np.array(["b", "z", "c", "b", "a"], dtype=object))
    data.recode_ids("u", np.array(["a", "b", "c", "d"], dtype=object))
    assert list(data.id_vocabs["u"]) == ["a", "b", "c", "d", "z"]
    assert data.id_columns["u"].tolist() == [1, 4, 2, 1, 0]

"""PyTorch port vs the JAX package: the native columnar Avro ingest path.

The port's ``io/native_avro.py`` + ``io/data_format.py`` columnar path
(built from ``csrc/host/avro_columnar.cpp`` with ``g++`` on first use) is
held against the JAX package's own native path and against the port's
records path, on the same Avro files:

- ``read_columnar`` gives the JAX ``read_columnar``'s columns, column by
  column, array for array;
- the port's native load, the port's records load and the JAX load give
  ``GameDataset``s equal array for array (both CSR shards, responses,
  offsets, weights, id codes and vocabularies, uids), on one file and on
  a directory of parts; the feature name-and-term sets are equal;
- a part the decoder declines (a nullable feature section, a numeric uid,
  a float id column) sends the input down the records path, as in the
  JAX package, and the datasets still agree;
- a corrupt part is quarantined under a loss budget, the same part the
  JAX package names; an all-corrupt input aborts;
- the ``io.shard_open``, ``io.avro_read`` and ``io.index_map`` fault
  points fire on the native path and retry, as often as in the JAX
  package;
- a failed build of the host library raises, and no load falls back to
  the records path for it;
- the fixture writer's directory of parts loads to the one-file dataset.
"""

import os
import stat

import numpy as np
import pytest
import torch

from photon_ml_tpu.data.ingest import IngestPolicy as JPolicy
from photon_ml_tpu.io import data_format as jdf
from photon_ml_tpu.io import native_avro as jna
from photon_ml_tpu.utils import faults as jfaults
from photon_ml_tpu_torch.data.ingest import (
    IngestPolicy,
    ShardLossExceededError,
)
from photon_ml_tpu_torch.io import data_format as tdf
from photon_ml_tpu_torch.io import native_avro as tna
from photon_ml_tpu_torch.io import native_loader
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro import write_container
from photon_ml_tpu_torch.ops import kernels_build
from photon_ml_tpu_torch.tools.crash_resume_drill import write_movielens_avro
from photon_ml_tpu_torch.utils import faults as tfaults
from photon_ml_tpu_torch.utils import retry as tretry

torch.set_num_threads(1)

SECTIONS = {"global": ["globalFeatures"], "user": ["userFeatures"]}
SECTION_KEYS = ["globalFeatures", "userFeatures"]
GLMIX = dict(n_train=1_500, n_val=300, n_users=40, n_movies=30, d_global=8)


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    monkeypatch.delenv("PHOTON_FAULTS", raising=False)
    monkeypatch.delenv("PHOTON_FAULTS_STATE_DIR", raising=False)
    tfaults.disarm_all()
    jfaults.disarm_all()
    tdf.reset_ingest_stats()
    yield
    tfaults.disarm_all()
    jfaults.disarm_all()


@pytest.fixture(scope="module")
def glmix(tmp_path_factory):
    """The GLMix recipe as one training file and as four part files."""
    d = tmp_path_factory.mktemp("glmix")
    write_movielens_avro(str(d / "train.avro"), str(d / "val.avro"),
                         *GLMIX.values())
    parts = d / "parts"
    parts.mkdir()
    train = str(d / "train.avro")
    # the same rows split into part files by the port's writer
    from photon_ml_tpu_torch.io.avro import read_container

    schema, records = read_container(train)
    for k, lo in enumerate(range(0, len(records), 400)):
        write_container(str(parts / f"part-{k:05d}.avro"), schema,
                        records[lo:lo + 400])
    return {"train": train, "val": str(d / "val.avro"),
            "parts": str(parts)}


def _maps(path, mod):
    sets = mod.NameAndTermFeatureSets.from_paths([path], SECTION_KEYS)
    return {"global": sets.index_map(["globalFeatures"], True),
            "user": sets.index_map(["userFeatures"], True)}


def assert_datasets_equal(a, b, same_package=True):
    assert set(a.feature_shards) == set(b.feature_shards)
    for k, x in a.feature_shards.items():
        y = b.feature_shards[k]
        assert x.shape == y.shape, k
        for f in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), (k, f)
        if same_package:
            assert x.dtype == y.dtype and x.indices.dtype == y.indices.dtype
    for f in ("responses", "offsets", "weights"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.uids is None) == (b.uids is None)
    if a.uids is not None:
        assert list(a.uids) == list(b.uids)
    assert set(a.id_columns) == set(b.id_columns)
    for t in a.id_columns:
        assert np.array_equal(a.id_columns[t], b.id_columns[t]), t
        assert list(a.id_vocabs[t]) == list(b.id_vocabs[t]), t


def _columns_equal(got, want, where=""):
    assert type(got) is type(want), where
    if isinstance(got, dict):
        assert set(got) == set(want), where
        for k in got:
            _columns_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(got, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), where
    else:
        assert got == want, where


RICH_SCHEMA = {
    "name": "Rich", "type": "record", "namespace": "t",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "response", "type": "double"},
        {"name": "count", "type": "long"},
        {"name": "ratio", "type": "float"},
        {"name": "flag", "type": "boolean"},
        {"name": "kind", "type": {"type": "enum", "name": "Kind",
                                  "symbols": ["A", "B", "C"]}},
        {"name": "either", "type": ["null", "long", "double"]},
        {"name": "blob", "type": "bytes"},
        {"name": "tags", "type": {"type": "array", "items": "double"}},
        {"name": "metadataMap",
         "type": ["null", {"type": "map", "values": "string"}],
         "default": None},
        {"name": "features",
         "type": {"type": "array", "items": schemas.FEATURE}},
    ],
}


def _rich_records(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append({
            "uid": None if i % 7 == 0 else f"r{i}",
            "response": float(rng.integers(0, 2)),
            "count": int(rng.integers(-5, 1 << 40)),
            "ratio": float(np.float32(rng.normal())),
            "flag": bool(i % 2), "kind": "ABC"[i % 3],
            "either": [None, int(i), float(i) / 3][i % 3],
            "blob": bytes(rng.integers(0, 256, i % 5, dtype=np.uint8)),
            "tags": rng.normal(size=i % 4).tolist(),
            "metadataMap": None if i % 5 == 0 else {"userId": f"u{i % 6}",
                                                    "k": "v"},
            "features": [{"name": f"f{j}", "term": "t" * (j % 2),
                          "value": float(rng.normal())}
                         for j in rng.choice(9, size=i % 4, replace=False)],
        })
    return out


@pytest.mark.parametrize("which", ["glmix", "rich"])
def test_read_columnar_matches_jax(glmix, tmp_path, which):
    if which == "glmix":
        path = glmix["train"]
    else:
        path = str(tmp_path / "rich.avro")
        write_container(path, RICH_SCHEMA, _rich_records(300))
    got, want = tna.read_columnar(path), jna.read_columnar(path)
    assert got is not None and want is not None
    assert got[0] == want[0] and got[1] == want[1]
    _columns_equal(got[2], want[2])


@pytest.mark.parametrize("layout", ["file", "parts"])
def test_datasets_equal_three_ways(glmix, layout):
    path = glmix["train"] if layout == "file" else glmix["parts"]
    tmaps, jmaps = _maps(path, tdf), _maps(path, jdf)
    assert tdf.INGEST_STATS["records_parts"] == 0
    tdf.reset_ingest_stats()
    native = tdf.load_game_dataset_avro(path, SECTIONS, tmaps,
                                        id_types=["userId"])
    n_parts = 1 if layout == "file" else 4
    assert tdf.INGEST_STATS == {"native_parts": n_parts,
                                "declined_parts": 0, "records_parts": 0}
    records = tdf.load_game_dataset_records([path], SECTIONS, tmaps,
                                            id_types=["userId"])
    assert tdf.INGEST_STATS["records_parts"] == n_parts
    ref = jdf.load_game_dataset_avro(path, SECTIONS, jmaps,
                                     id_types=["userId"])
    assert native.num_samples == GLMIX["n_train"]
    assert_datasets_equal(native, records)
    assert_datasets_equal(native, ref, same_package=False)
    if layout == "parts":
        one = tdf.load_game_dataset_avro(glmix["train"], SECTIONS, tmaps,
                                         id_types=["userId"])
        assert_datasets_equal(native, one)


def test_feature_sets_equal_three_ways(glmix):
    paths = [glmix["parts"], glmix["val"]]
    native = tdf.NameAndTermFeatureSets.from_paths(paths, SECTION_KEYS)
    assert tdf.INGEST_STATS == {"native_parts": 5, "declined_parts": 0,
                                "records_parts": 0}
    records = tdf.NameAndTermFeatureSets.from_records(
        tdf._records(paths), SECTION_KEYS)
    ref = jdf.NameAndTermFeatureSets.from_paths(paths, SECTION_KEYS)
    assert native.sets == records.sets == ref.sets
    assert len(native.sets["userFeatures"]) == GLMIX["n_movies"]


def _declined_schema(kind):
    fields = [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "response", "type": "double"},
        {"name": "globalFeatures",
         "type": {"type": "array", "items": schemas.FEATURE}},
        {"name": "userId", "type": "string"},
    ]
    if kind == "nullable_section":
        fields[2]["type"] = ["null", fields[2]["type"]]
    elif kind == "numeric_uid":
        fields[0]["type"] = ["null", "long"]
    elif kind == "float_id":
        fields[3]["type"] = "double"
    return {"name": "G", "type": "record", "namespace": "t",
            "fields": fields}


@pytest.mark.parametrize("kind", ["nullable_section", "numeric_uid",
                                  "float_id"])
def test_declined_parts_take_the_records_path_as_in_jax(tmp_path, kind):
    rng = np.random.default_rng(5)
    recs = [{"uid": (i if kind == "numeric_uid" else f"x{i}"),
             "response": float(i % 2),
             "globalFeatures": [{"name": f"g{j}", "term": "",
                                 "value": float(rng.normal())}
                                for j in range(3)],
             "userId": (float(i % 4) if kind == "float_id"
                        else f"u{i % 4}")} for i in range(60)]
    path = str(tmp_path / "d.avro")
    write_container(path, _declined_schema(kind), recs)
    sections = {"global": ["globalFeatures"]}
    tsets = tdf.NameAndTermFeatureSets.from_paths([path], ["globalFeatures"])
    jsets = jdf.NameAndTermFeatureSets.from_paths([path], ["globalFeatures"])
    assert tsets.sets == jsets.sets
    tdf.reset_ingest_stats()
    got = tdf.load_game_dataset_avro(
        path, sections, {"global": tsets.index_map(["globalFeatures"], True)},
        id_types=["userId"])
    assert tdf.INGEST_STATS == {"native_parts": 0, "declined_parts": 1,
                                "records_parts": 1}
    want = jdf.load_game_dataset_avro(
        path, sections, {"global": jsets.index_map(["globalFeatures"], True)},
        id_types=["userId"])
    assert_datasets_equal(got, want, same_package=False)


def _corrupt(path, how="truncated"):
    data = bytearray(open(path, "rb").read())
    mid = len(data) // 2
    if how == "truncated":
        del data[mid:]
    else:
        data[mid:mid + 64] = bytes(64)
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("how", ["truncated", "zeroed"])
def test_corrupt_part_is_quarantined_as_in_jax(glmix, tmp_path, how):
    """A truncated part fails the framing probe: quarantined, and the
    other parts stay on the native path. Zeroed record bytes inside
    intact framing are what the decoder cannot walk: the input goes to
    the records path, whose decode quarantines the part (as in JAX)."""
    import shutil

    parts = str(tmp_path / "parts")
    shutil.copytree(glmix["parts"], parts)
    _corrupt(os.path.join(parts, "part-00002.avro"), how)
    tmaps, jmaps = _maps(glmix["train"], tdf), _maps(glmix["train"], jdf)
    tpol, jpol = IngestPolicy(0.5), JPolicy(0.5)
    got = tdf.load_game_dataset_avro(parts, SECTIONS, tmaps,
                                     id_types=["userId"], policy=tpol)
    want = jdf.load_game_dataset_avro(parts, SECTIONS, jmaps,
                                      id_types=["userId"], policy=jpol)
    assert tdf.INGEST_STATS["records_parts"] == (
        0 if how == "truncated" else 4)
    assert [os.path.basename(q.path) for q in tpol.quarantined] == [
        os.path.basename(q.path) for q in jpol.quarantined] == [
        "part-00002.avro"]
    assert [q.stage for q in tpol.quarantined] == [
        q.stage for q in jpol.quarantined]
    assert tpol.coverage_fraction == jpol.coverage_fraction == 0.75
    assert got.num_samples == GLMIX["n_train"] - 400
    assert_datasets_equal(got, want, same_package=False)
    # without a budget the corrupt part ends the load, as in JAX
    with pytest.raises(ValueError):
        tdf.load_game_dataset_avro(parts, SECTIONS, tmaps,
                                   id_types=["userId"])
    # all parts corrupt: past any budget below 1
    for name in os.listdir(parts):
        _corrupt(os.path.join(parts, name))
    with pytest.raises(ShardLossExceededError):
        tdf.load_game_dataset_avro(parts, SECTIONS, tmaps,
                                   id_types=["userId"],
                                   policy=IngestPolicy(0.5))
    with pytest.raises(ShardLossExceededError):
        tdf.NameAndTermFeatureSets.from_paths([parts], SECTION_KEYS,
                                              policy=IngestPolicy(0.5))


@pytest.mark.parametrize("point,site", [("io.shard_open", "io.avro_read"),
                                        ("io.avro_read", "io.avro_read")])
def test_io_fault_points_fire_on_the_native_path(glmix, point, site):
    tmaps, jmaps = _maps(glmix["parts"], tdf), _maps(glmix["parts"], jdf)
    tdf.reset_ingest_stats()
    before = tretry.RETRIES.get(site, 0)
    tfaults.arm(point, "io_error", times=2, tag="part-00001.avro")
    jfaults.arm(point, "io_error", times=2, tag="part-00001.avro")
    got = tdf.load_game_dataset_avro(glmix["parts"], SECTIONS, tmaps,
                                     id_types=["userId"])
    want = jdf.load_game_dataset_avro(glmix["parts"], SECTIONS, jmaps,
                                      id_types=["userId"])
    assert tfaults.hits(point) == jfaults.hits(point) >= 2
    assert tretry.RETRIES.get(site, 0) - before == 2
    assert tdf.INGEST_STATS == {"native_parts": 4, "declined_parts": 0,
                                "records_parts": 0}
    assert_datasets_equal(got, want, same_package=False)


def test_index_map_fault_point_retries(glmix, tmp_path):
    sets = tdf.NameAndTermFeatureSets.from_paths([glmix["train"]],
                                                 SECTION_KEYS)
    d = str(tmp_path / "sets")
    sets.save(d)
    before = tretry.RETRIES.get("io.index_map", 0)
    tfaults.arm("io.index_map", "io_error", times=2)
    jfaults.arm("io.index_map", "io_error", times=2)
    got = tdf.NameAndTermFeatureSets.load(d, SECTION_KEYS)
    want = jdf.NameAndTermFeatureSets.load(d, SECTION_KEYS)
    assert got.sets == want.sets == sets.sets
    assert tfaults.hits("io.index_map") == jfaults.hits("io.index_map")
    assert tretry.RETRIES["io.index_map"] - before == 2
    tfaults.arm("io.index_map", "io_error", times=99)
    with pytest.raises(tretry.RetryExhaustedError):
        tdf.NameAndTermFeatureSets.load(d, SECTION_KEYS)


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """An empty build directory and no loaded host library."""
    monkeypatch.setattr(kernels_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_loader, "_lib", None)
    return tmp_path


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_host_build_raises_and_never_reads_records(glmix, fresh_build,
                                                          monkeypatch,
                                                          compiler):
    bin_dir = fresh_build / "bin"
    bin_dir.mkdir()
    if compiler == "failing":
        gxx = bin_dir / "g++"
        gxx.write_text("#!/bin/sh\necho 'fake g++: error: no luck' >&2\n"
                       "exit 1\n")
        gxx.chmod(gxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(bin_dir))
    want = "g\\+\\+ not found" if compiler == "missing" else "no luck"
    with pytest.raises(RuntimeError, match=want):
        native_loader.get_host_lib()
    # (the JAX package's maps: the port's scan cannot run without it)
    with pytest.raises(RuntimeError, match=want):
        tdf.load_game_dataset_avro(glmix["train"], SECTIONS,
                                   _maps(glmix["train"], jdf),
                                   id_types=["userId"])
    with pytest.raises(RuntimeError, match=want):
        tdf.NameAndTermFeatureSets.from_paths([glmix["train"]], SECTION_KEYS)
    assert tdf.INGEST_STATS == {"native_parts": 0, "declined_parts": 0,
                                "records_parts": 0}
    d = kernels_build.BUILD_DIR
    assert not os.path.isdir(d) or not any(n.endswith(".so")
                                           for n in os.listdir(d))


def test_host_library_builds_into_the_build_dir(fresh_build):
    lib = native_loader.get_host_lib()
    assert native_loader.get_host_lib() is lib
    (name,) = [n for n in os.listdir(kernels_build.BUILD_DIR)
               if n.endswith(".so")]
    assert name.startswith("libphoton_host_")
    assert native_loader.BUILD_INFO["seconds"] > 0
    for fn in ("photon_avro_count", "photon_avro_fill",
               "photon_encode_scores"):
        assert hasattr(lib, fn)


def test_fixture_parts_load_to_the_one_file_dataset(tmp_path):
    one, parts = tmp_path / "one", tmp_path / "parts"
    one.mkdir()
    args = (300, 100, 12, 9, 5)
    write_movielens_avro(str(one / "t.avro"), str(one / "v.avro"), *args)
    write_movielens_avro(str(parts / "t"), str(parts / "v"), *args,
                         parts=(3, 2))
    assert sorted(os.listdir(parts / "t")) == [
        f"part-{k:05d}.avro" for k in range(3)]
    for split in ("t", "v"):
        a = str(one / f"{split}.avro")
        b = str(parts / split)
        maps = _maps(a, tdf)
        assert dict(_maps(b, tdf)["user"].items()) == dict(
            maps["user"].items())
        assert_datasets_equal(
            tdf.load_game_dataset_avro(a, SECTIONS, maps,
                                       id_types=["userId"]),
            tdf.load_game_dataset_avro(b, SECTIONS, maps,
                                       id_types=["userId"]))

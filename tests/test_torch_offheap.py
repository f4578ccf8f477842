"""PyTorch port vs the JAX package: index-map stores and the off-heap flags.

- ``OffHeapIndexMap`` round trip: ``index_of``, ``key_of``, ``items``,
  ``len``, the intercept; a lookup compares key bytes, so keys whose
  64-bit hashes collide still resolve; a partition count other than the
  store's is refused with the JAX package's message.
- Each package reads the other's JSON and memmap stores, key for key.
- The feature-indexing job (GAME and legacy mode, the JSON store alone
  and with the off-heap store; the autodetect of ``load_feature_index``)
  writes the stores the JAX job writes, and ``cli/feature_indexing_job``
  takes the JAX CLI's flags.
- The three port drivers consume a store built by the port's job: the
  training driver equals its run without the store (objectives and the
  model, record for record) and agrees with the JAX driver on the same
  argv (objectives rel 1e-4, f32); the scoring driver scores the same
  with and without the store (``array_equal``); the legacy driver
  learns as many coefficients as the store holds and agrees with the
  JAX legacy driver on the same argv (rtol 1e-4).
"""

import json
import os

import jax
import numpy as np
import pytest

from photon_ml_tpu.cli import feature_indexing_job as jjob_cli
from photon_ml_tpu.cli import legacy_driver as jlegacy
from photon_ml_tpu.cli.game_training_driver import main as jax_train_main
from photon_ml_tpu.io import feature_index_job as jjob
from photon_ml_tpu.io import index_map as jim
from photon_ml_tpu_torch.cli import feature_indexing_job as tjob_cli
from photon_ml_tpu_torch.cli import game_scoring_driver as tsd
from photon_ml_tpu_torch.cli import game_training_driver as ttd
from photon_ml_tpu_torch.cli import legacy_driver as tlegacy
from photon_ml_tpu_torch.io import feature_index_job as tjob
from photon_ml_tpu_torch.io import index_map as tim
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro import write_container
from photon_ml_tpu_torch.io.data_format import TRAINING_EXAMPLE_FIELD_NAMES
from photon_ml_tpu_torch.io.model_io import load_scored_items
from test_torch_drivers import SECTIONS, TRAIN_FLAGS, make_game_avro
from test_torch_streamed import _model_records


def _keys(n=300):
    return [tim.feature_key(f"name{i}", f"term{i % 7}") for i in range(n)]


def test_offheap_round_trip(tmp_path):
    imap = tim.IndexMap.from_keys(_keys(), add_intercept=True)
    imap.save_offheap(str(tmp_path), num_partitions=3)
    oh = tim.OffHeapIndexMap(str(tmp_path))
    assert len(oh) == len(imap)
    for k, v in imap.items():
        assert oh.index_of(k) == v and oh.key_of(v) == k and k in oh
    assert oh.index_of("absent\x01key") == -1 and "nope" not in oh
    assert oh.key_of(len(imap) + 5) is None
    assert oh.intercept_index == imap.intercept_index is not None
    assert dict(oh.items()) == dict(imap.items())
    assert tim.stable_hash64(_keys()[0]) == jim.stable_hash64(_keys()[0])


def test_offheap_lookups_compare_key_bytes(tmp_path, monkeypatch):
    # every key hashes alike: one partition, one run of equal hashes
    monkeypatch.setattr(tim, "stable_hash64", lambda key: 42)
    imap = tim.IndexMap.from_keys(_keys(40))
    imap.save_offheap(str(tmp_path), num_partitions=2)
    oh = tim.OffHeapIndexMap(str(tmp_path))
    assert np.all(np.load(tmp_path / "global-part-0.hash.npy") == 42)
    assert len(np.load(tmp_path / "global-part-1.hash.npy")) == 0
    for k, v in imap.items():
        assert oh.index_of(k) == v
    assert oh.index_of("collides\x01but-absent") == -1


def test_wrong_partition_count_is_refused(tmp_path):
    tim.IndexMap.from_keys(_keys()).save_offheap(str(tmp_path), 3)
    assert len(tim.OffHeapIndexMap(str(tmp_path),
                                   expected_partitions=3)) == 300
    with pytest.raises(ValueError, match="built with 3 partitions, but 8"):
        tim.OffHeapIndexMap(str(tmp_path), expected_partitions=8)
    with pytest.raises(ValueError) as jerr:
        jim.OffHeapIndexMap(str(tmp_path), expected_partitions=8)
    with pytest.raises(ValueError) as terr:
        tim.OffHeapIndexMap(str(tmp_path), expected_partitions=8)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_reads_the_others_stores(tmp_path, writer):
    mod, other = (jim, tim) if writer == "jax" else (tim, jim)
    imap = mod.IndexMap.from_keys(_keys(), add_intercept=True)
    imap.save(str(tmp_path), num_partitions=4, namespace="shard")
    imap.save_offheap(str(tmp_path), num_partitions=4, namespace="shard")
    json_map = other.IndexMap.load(str(tmp_path), namespace="shard")
    oh = other.OffHeapIndexMap(str(tmp_path), namespace="shard",
                               expected_partitions=4)
    assert dict(json_map.items()) == dict(imap.items()) == dict(oh.items())
    for k, v in imap.items():
        assert oh.index_of(k) == v and oh.key_of(v) == k
    for f in sorted(os.listdir(tmp_path)):
        assert f.startswith("shard-")


def _game_fixture(d):
    train, val = str(d / "train.avro"), str(d / "val.avro")
    make_game_avro(train, seed=0)
    make_game_avro(val, n=200, seed=1)
    return train, val


def _legacy_fixture(path, n, seed):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, 6))
    y = (r.uniform(size=n) < 1 / (1 + np.exp(-X @ np.linspace(-1, 1, 6))))
    write_container(path, schemas.TRAINING_EXAMPLE, [
        {"uid": f"r{i}", "label": float(y[i]),
         "features": [{"name": f"f{j}", "term": "t" if j % 2 else "",
                       "value": float(X[i, j])} for j in range(6)
                      if (i + j) % 5],
         "metadataMap": None, "weight": None, "offset": None}
        for i in range(n)])


def _stores(out):
    return sorted(f for f in os.listdir(out))


@pytest.mark.parametrize("offheap", ["false", "true"])
def test_feature_indexing_jobs_agree_game_mode(tmp_path, offheap):
    train, _ = _game_fixture(tmp_path)
    argv = ["--input-paths", train, "--num-partitions", "3",
            "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
            "--offheap", offheap]
    tjob_cli.main(argv + ["--output-dir", str(tmp_path / "t")])
    jjob_cli.main(argv + ["--output-dir", str(tmp_path / "j")])
    assert _stores(tmp_path / "t") == _stores(tmp_path / "j")
    for ns in ("global", "user"):
        for reader in (tjob.load_feature_index, jjob.load_feature_index):
            t = reader(str(tmp_path / "t"), [ns])[ns]
            j = reader(str(tmp_path / "j"), [ns])[ns]
            assert isinstance(t, (tim.OffHeapIndexMap, jim.OffHeapIndexMap)) \
                == (offheap == "true")
            assert dict(t.items()) == dict(j.items())
    loaded = tjob.load_feature_index(str(tmp_path / "t"), ["global"],
                                     offheap=False)["global"]
    assert isinstance(loaded, tim.IndexMap)
    if offheap == "false":
        with pytest.raises(FileNotFoundError):
            tjob.load_feature_index(str(tmp_path / "t"), ["global"],
                                    offheap=True)


def test_feature_indexing_jobs_agree_legacy_mode(tmp_path):
    path = str(tmp_path / "train.avro")
    _legacy_fixture(path, 80, seed=2)
    built = tjob.build_feature_index(
        path, str(tmp_path / "t"),
        field_names=TRAINING_EXAMPLE_FIELD_NAMES, num_partitions=2,
        offheap=True)
    jjob_cli.main(["--input-paths", path, "--output-dir",
                   str(tmp_path / "j"), "--num-partitions", "2"])
    assert _stores(tmp_path / "t") == _stores(tmp_path / "j")
    j = jjob.load_feature_index(str(tmp_path / "j"), ["global"])["global"]
    assert dict(built["global"].items()) == dict(j.items())
    assert built["global"].intercept_index is not None


def _offheap_store(tmp_path, train, partitions=2):
    store = str(tmp_path / "store")
    tjob_cli.main(["--input-paths", train, "--output-dir", store,
                   "--feature-shard-id-to-feature-section-keys-map",
                   SECTIONS, "--num-partitions", str(partitions)])
    return store


def _grid_states(out):
    (grid,) = json.load(open(os.path.join(out, "metrics.json")))["grid"]
    return [(s["iteration"], s["coordinate"], s["objective"])
            for s in grid["states"]]


@pytest.fixture(scope="module")
def game_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("offheap_drivers")
    train, val = _game_fixture(d)
    store = _offheap_store(d, train)
    base = ["--train-input-dirs", train, "--validate-input-dirs", val,
            *TRAIN_FLAGS]
    offheap = ["--offheap-indexmap-dir", store,
               "--offheap-indexmap-num-partitions", "2"]
    out = {k: str(d / k) for k in ("plain", "offheap", "jax_offheap")}
    ttd.run(base + ["--output-dir", out["plain"], "--device", "cpu"])
    ttd.run(base + offheap + ["--output-dir", out["offheap"],
                              "--device", "cpu"])
    with jax.enable_x64(False):
        jax_train_main(base + offheap + ["--output-dir", out["jax_offheap"]])
    return dict(dir=d, val=val, store=store, out=out, base=base)


def test_training_driver_consumes_the_store(game_runs):
    out = game_runs["out"]
    assert _grid_states(out["offheap"]) == _grid_states(out["plain"])
    assert _model_records(out["offheap"]) == _model_records(out["plain"])
    for (ti, tc, to), (ji, jc, jo) in zip(_grid_states(out["offheap"]),
                                          _grid_states(out["jax_offheap"])):
        assert (ti, tc) == (ji, jc) and to == pytest.approx(jo, rel=1e-4)
    log = open(os.path.join(out["offheap"], "game-training.log")).read()
    assert "off-heap feature maps" in log


def test_training_driver_refuses_the_wrong_partition_count(game_runs,
                                                           tmp_path):
    argv = game_runs["base"] + [
        "--offheap-indexmap-dir", game_runs["store"],
        "--offheap-indexmap-num-partitions", "5",
        "--output-dir", str(tmp_path / "out"), "--device", "cpu"]
    with pytest.raises(ValueError, match="built with 2 partitions, but 5"):
        ttd.run(argv)


def test_scoring_driver_consumes_the_store(game_runs, tmp_path):
    base = ["--input-data-dirs", game_runs["val"],
            "--game-model-input-dir",
            os.path.join(game_runs["out"]["plain"], "best"),
            "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
            "--random-effect-id-set", "userId", "--evaluator-type", "AUC",
            "--device", "cpu"]
    scores = {}
    for name, extra in (("plain", []),
                        ("offheap", ["--offheap-indexmap-dir",
                                     game_runs["store"],
                                     "--offheap-indexmap-num-partitions",
                                     "2"])):
        out = str(tmp_path / name)
        tsd.main(base + extra + ["--output-dir", out])
        scores[name] = [r["predictionScore"] for r in load_scored_items(
            os.path.join(out, "scores", "part-00000.avro"))]
    assert len(scores["plain"]) == 200
    assert np.array_equal(scores["plain"], scores["offheap"])


def test_legacy_drivers_consume_the_store(tmp_path):
    train, val = str(tmp_path / "train.avro"), str(tmp_path / "val.avro")
    _legacy_fixture(train, 300, seed=3)
    _legacy_fixture(val, 100, seed=4)
    store = str(tmp_path / "store")
    tjob_cli.main(["--input-paths", train, "--output-dir", store,
                   "--num-partitions", "3"])
    argv = ["--training-data-directory", train,
            "--validating-data-directory", val,
            "--task", "LOGISTIC_REGRESSION", "--regularization-weights",
            "1", "--num-iterations", "30", "--offheap-indexmap-dir", store,
            "--offheap-indexmap-num-partitions", "3"]
    td = tlegacy.run(argv + ["--output-directory", str(tmp_path / "t"),
                             "--device", "cpu"])
    jd = jlegacy.LegacyDriver(jlegacy.parse_args(
        argv + ["--output-directory", str(tmp_path / "j")]))
    jd.run()
    oh = tim.OffHeapIndexMap(store)
    assert isinstance(td.train_data.index_map, tim.OffHeapIndexMap)
    (tm,), (jm,) = td.models, jd.models
    w = tm.model.coefficients.means.numpy()
    assert len(w) == len(oh)
    np.testing.assert_allclose(w, np.asarray(jm.model.coefficients.means),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="built with 3 partitions"):
        tlegacy.run(argv[:-1] + ["4", "--output-directory",
                                 str(tmp_path / "bad"), "--device", "cpu"])

"""PyTorch port vs the JAX package: the GAME training and scoring drivers.

One small GAME fixture (the recipe of ``tests/test_drivers.py:66``: 400
training and 200 validation rows, 8 users, 6 global and 3 per-user
features, uids and ``userId`` in ``metadataMap``) goes through both
training drivers with the same argv — the port's with ``--device cpu``
added, the JAX package's inside ``jax.enable_x64(False)`` (f32 throughout,
like the port; ``tests/test_torch_game.py`` explains why). Then:

- the objectives in ``metrics.json`` agree to rel 1e-4 per update, with
  equal state counts, and the validation AUC to 1e-4;
- each package's ``load_game_model`` reads the other's ``best/`` dir, and
  the coefficients equal what the writer's own reader finds, exactly
  (both hold the f32 values the Avro doubles carry);
- each scoring driver scores the other's model, and the scores agree to
  1e-5 abs by uid;
- both drivers decode the fixture natively, and the port's driver on its
  records path (every part declined) writes the same metrics.json
  objectives and validation metrics, states and scores;
- on the second-order argvs (linear TRON + L2 with
  ``--compute-variance``, Poisson L-BFGS + elastic net) the objectives
  and validation metrics agree to rel 1e-4 per update, each side reads
  and scores the other's model, and neither model carries variances;
- every flag the port does not run yet ends its driver with
  ``NotImplementedError`` (exit 3 and one ``PHOTON_ABORT`` line;
  ``tests/test_torch_drivers_cd.py`` runs the coordinate-descent flags
  and down-sampling, ``tests/test_torch_drivers_factored.py`` the
  factored random effects); TRON with L1 and TRON for the smoothed hinge
  raise ``ValueError`` from both drivers; the checkpoint, recovery, stop
  and degraded-ingest flags run, and ``tests/test_torch_drill.py`` holds
  them against the JAX drivers.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli.game_scoring_driver import main as jax_score_main
from photon_ml_tpu.cli.game_training_driver import main as jax_train_main
from photon_ml_tpu.io import model_io as jio
from photon_ml_tpu.io.avro import write_container
from photon_ml_tpu_torch.cli import game_scoring_driver as tsd
from photon_ml_tpu_torch.cli import game_training_driver as ttd
from photon_ml_tpu_torch.io import data_format as tdf
from photon_ml_tpu_torch.io import model_io as tio
from photon_ml_tpu_torch.tools.glmix_cases import GLMIX_CASES, SECOND_ORDER_CASES
from test_torch_score_encode import load_jax_native_lib

torch.set_num_threads(1)

SECTIONS = "global:globalFeatures|user:userFeatures"
TRAIN_FLAGS = [
    "--task-type", "LOGISTIC_REGRESSION",
    "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
    "--updating-sequence", "fixed,perUser", "--num-iterations", "2",
    "--fixed-effect-data-configurations", "fixed:global,1",
    "--fixed-effect-optimization-configurations",
    "fixed:40,1e-7,10,1,LBFGS,L2",
    "--random-effect-data-configurations", "perUser:userId,user,1,128",
    "--random-effect-optimization-configurations",
    "perUser:20,1e-7,1,1,LBFGS,L2",
    "--random-effect-block-buckets", "4",
    "--evaluator-type", "AUC,LOGISTIC_LOSS,AUC:userId",
]


def _game_schema():
    from photon_ml_tpu.io import schemas

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


def make_game_avro(path, n=400, n_users=8, d_g=6, d_u=3, seed=0,
                   skip_users=()):
    """``tests/test_drivers.py:66 _make_game_avro``'s records, without the
    rows of ``skip_users``."""
    rng = np.random.default_rng(seed)
    w_rng = np.random.default_rng(777)
    w_g = w_rng.normal(size=d_g)
    W_u = w_rng.normal(size=(n_users, d_u))
    records = []
    for i in range(n):
        u = int(rng.integers(0, n_users))
        xg = rng.normal(size=d_g)
        xu = rng.normal(size=d_u)
        y = float(rng.uniform() < 1.0 / (1.0 + np.exp(-(xg @ w_g
                                                          + xu @ W_u[u]))))
        records.append({
            "uid": f"s{seed}_{i}", "response": y, "offset": None,
            "weight": None, "metadataMap": {"userId": f"user{u}"},
            "globalFeatures": [{"name": f"g{j}", "term": "",
                                "value": float(xg[j])} for j in range(d_g)],
            "userFeatures": [{"name": f"u{j}", "term": "",
                              "value": float(xu[j])} for j in range(d_u)]})
    write_container(path, _game_schema(),
                    [r for r in records
                     if r["metadataMap"]["userId"] not in skip_users])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("drivers")
    train, val = str(d / "train.avro"), str(d / "val.avro")
    make_game_avro(train, seed=0)
    make_game_avro(val, n=200, seed=1)
    base = ["--train-input-dirs", train, "--validate-input-dirs", val,
            *TRAIN_FLAGS]
    out = {"jax": str(d / "jax"), "torch": str(d / "torch")}
    with pytest.MonkeyPatch.context() as mp:
        load_jax_native_lib(mp)  # the JAX driver decodes natively too
    with jax.enable_x64(False):
        jax_train_main(base + ["--output-dir", out["jax"]])
    tdf.reset_ingest_stats()
    result = ttd.run(base + ["--output-dir", out["torch"], "--device",
                             "cpu"]).best_result
    ingest = dict(tdf.INGEST_STATS)
    metrics = {k: json.load(open(os.path.join(v, "metrics.json")))
               for k, v in out.items()}
    return dict(dir=d, val=val, out=out, metrics=metrics, result=result,
                base=base, ingest=ingest)


def _states(metrics):
    (grid,) = metrics["grid"]
    return grid["states"]


def test_both_drivers_write_their_outputs(runs):
    for side, out in runs["out"].items():
        assert sorted(os.listdir(out)) == ["best", "game-training.log",
                                           "metrics.json", "output"], side
        assert sorted(os.listdir(os.path.join(out, "best"))) == [
            "fixed-effect", "random-effect"]
        assert os.listdir(os.path.join(out, "output")) == ["grid-0"]
    assert set(runs["metrics"]["torch"]) == set(runs["metrics"]["jax"])


def test_objectives_agree_per_update(runs):
    js, ts = _states(runs["metrics"]["jax"]), _states(runs["metrics"]["torch"])
    assert len(js) == len(ts) == 4
    for j, t in zip(js, ts):
        assert (j["iteration"], j["coordinate"]) == (t["iteration"],
                                                     t["coordinate"])
        assert t["objective"] == pytest.approx(j["objective"], rel=1e-4)
    objs = [s["objective"] for s in ts]
    assert objs[3] <= objs[1] * (1 + 1e-6)


def test_validation_metrics_agree_per_update(runs):
    js, ts = _states(runs["metrics"]["jax"]), _states(runs["metrics"]["torch"])
    for j, t in zip(js, ts):
        assert set(t["validation_metrics"]) == {"AUC", "LOGISTIC_LOSS",
                                                "AUC:userId"}
        for name in ("AUC", "AUC:userId"):
            assert abs(t["validation_metrics"][name]
                       - j["validation_metrics"][name]) <= 1e-4, name
        assert t["validation_metrics"]["LOGISTIC_LOSS"] == pytest.approx(
            j["validation_metrics"]["LOGISTIC_LOSS"], rel=1e-4)
    best_j = runs["metrics"]["jax"]["best"]["metric"]
    best_t = runs["metrics"]["torch"]["best"]["metric"]
    assert abs(best_t - best_j) <= 1e-4


def _coefs(model):
    """coordinate -> {raw id or shard: {feature index: f32 value}} as
    host numpy, for either package's loaded GameModel."""
    out = {}
    for cid, m in model.models.items():
        if hasattr(m, "entity_ids"):
            out[cid] = {str(e): np.asarray(m.coefficients[i], np.float32)
                        for i, e in enumerate(m.entity_ids)}
        else:
            out[cid] = {m.feature_shard_id: np.asarray(
                m.model.coefficients.means, np.float32)}
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_side_reads_the_others_model_exactly(runs, writer):
    best = os.path.join(runs["out"][writer], "best")
    with jax.enable_x64(False):
        jmodel, jmaps = jio.load_game_model(best)
        jc = _coefs(jmodel)
    tmodel, tmaps = tio.load_game_model(best)
    tc = _coefs(tmodel)
    assert set(jmaps) == set(tmaps) == {"global", "user"}
    for shard in jmaps:
        assert dict(jmaps[shard].items()) == dict(tmaps[shard].items())
    assert set(jc) == set(tc) == {"fixed", "perUser"}
    for cid in jc:
        assert set(jc[cid]) == set(tc[cid])
        for key in jc[cid]:
            assert np.array_equal(jc[cid][key], tc[cid][key]), (cid, key)
    assert len(tc["perUser"]) == 8
    if writer == "torch":
        # ... and equal what the port's writer held in memory, read back
        # through the training driver's own index maps
        from photon_ml_tpu_torch.io.data_format import NameAndTermFeatureSets

        sets = NameAndTermFeatureSets.from_paths(
            [str(runs["dir"] / "train.avro")],
            ["globalFeatures", "userFeatures"])
        maps = {"global": sets.index_map(["globalFeatures"], True),
                "user": sets.index_map(["userFeatures"], True)}
        held = runs["result"].best_model.models
        raw = held["perUser"].to_raw()
        back = _coefs(tio.load_game_model(best, maps)[0])
        assert np.array_equal(back["fixed"]["global"],
                              held["fixed"].model.coefficients.means.numpy())
        for i, code in enumerate(raw.entity_codes):
            assert np.array_equal(back["perUser"][f"user{code}"],
                                  raw.coefficients[i].numpy())


@pytest.mark.parametrize("model_side", ["jax", "torch"])
def test_each_scoring_driver_scores_the_others_model(runs, model_side):
    model = os.path.join(runs["out"][model_side], "best")
    common = ["--input-data-dirs", runs["val"],
              "--game-model-input-dir", model,
              "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
              "--random-effect-id-set", "userId", "--evaluator-type", "AUC"]
    out_j = str(runs["dir"] / f"score_jax_{model_side}")
    out_t = str(runs["dir"] / f"score_torch_{model_side}")
    with jax.enable_x64(False):
        jax_score_main(common + ["--output-dir", out_j])
    driver = tsd.run(common + ["--output-dir", out_t, "--device", "cpu"])
    part = os.path.join("scores", "part-00000.avro")
    js = {r["uid"]: r["predictionScore"]
          for r in jio.load_scored_items(os.path.join(out_j, part))}
    ts = {r["uid"]: r["predictionScore"]
          for r in tio.load_scored_items(os.path.join(out_t, part))}
    assert len(ts) == 200 and set(js) == set(ts)
    assert max(abs(js[u] - ts[u]) for u in js) <= 1e-5
    assert all(np.isfinite(v) for v in ts.values())
    if model_side == "torch":
        # the port scores its own best model to the AUC its training
        # driver recorded for the state that became best/
        recorded = runs["metrics"]["torch"]["best"]["metric"]
        assert abs(driver.metrics["AUC"] - recorded) <= 1e-6


@pytest.fixture(scope="module")
def second_order_runs(runs):
    """Both training drivers on the second-order argvs of chip_smoke.py
    phase 8 (c) (linear TRON + L2 with ``--compute-variance``, Poisson
    L-BFGS + elastic net), on the same fixture."""
    d = runs["dir"]
    out = {}
    for case in SECOND_ORDER_CASES:
        base = [*runs["base"], *GLMIX_CASES[case].argv()]
        out[case] = {"jax": str(d / f"jax_{case}"),
                     "torch": str(d / f"torch_{case}")}
        with jax.enable_x64(False):
            jax_train_main(base + ["--output-dir", out[case]["jax"]])
        ttd.run(base + ["--output-dir", out[case]["torch"], "--device",
                        "cpu"])
    return out


@pytest.mark.parametrize("case", SECOND_ORDER_CASES)
def test_second_order_objectives_agree_per_update(second_order_runs,
                                                  case):
    metrics = {k: json.load(open(os.path.join(v, "metrics.json")))
               for k, v in second_order_runs[case].items()}
    js, ts = _states(metrics["jax"]), _states(metrics["torch"])
    assert len(js) == len(ts) == 4
    for j, t in zip(js, ts):
        assert (j["iteration"], j["coordinate"]) == (t["iteration"],
                                                     t["coordinate"])
        assert t["objective"] == pytest.approx(j["objective"], rel=1e-4)
        assert set(t["validation_metrics"]) == set(j["validation_metrics"])
        for name, v in t["validation_metrics"].items():
            assert v == pytest.approx(j["validation_metrics"][name],
                                      rel=1e-4), name
    objs = [s["objective"] for s in ts]
    assert all(np.isfinite(objs)) and objs[3] <= objs[1] * (1 + 1e-6)


@pytest.mark.parametrize("model_side", ["jax", "torch"])
@pytest.mark.parametrize("case", SECOND_ORDER_CASES)
def test_second_order_models_cross_read_and_score(runs, second_order_runs,
                                                  case, model_side):
    """Each side reads the other's ``best/`` exactly and scores it to the
    other side's scores."""
    best = os.path.join(second_order_runs[case][model_side], "best")
    with jax.enable_x64(False):
        jc = _coefs(jio.load_game_model(best)[0])
    tc = _coefs(tio.load_game_model(best)[0])
    assert set(jc) == set(tc) == {"fixed", "perUser"}
    for cid in jc:
        assert set(jc[cid]) == set(tc[cid])
        for key in jc[cid]:
            assert np.array_equal(jc[cid][key], tc[cid][key]), (cid, key)
    common = ["--input-data-dirs", runs["val"],
              "--game-model-input-dir", best,
              "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
              "--random-effect-id-set", "userId"]
    out_j = str(runs["dir"] / f"score_{case}_jax_{model_side}")
    out_t = str(runs["dir"] / f"score_{case}_torch_{model_side}")
    with jax.enable_x64(False):
        jax_score_main(common + ["--output-dir", out_j])
    tsd.run(common + ["--output-dir", out_t, "--device", "cpu"])
    part = os.path.join("scores", "part-00000.avro")
    js = {r["uid"]: r["predictionScore"]
          for r in jio.load_scored_items(os.path.join(out_j, part))}
    ts = {r["uid"]: r["predictionScore"]
          for r in tio.load_scored_items(os.path.join(out_t, part))}
    assert len(ts) == 200 and set(js) == set(ts)
    assert max(abs(js[u] - ts[u]) for u in js) <= 1e-5


def test_compute_variance_leaves_game_models_without_variances(
        second_order_runs):
    """The JAX GAME driver passes ``--compute-variance`` to the fixed
    effect, whose ``run_lazy`` computes no variances, so its model has
    none; the port carries that over (ROADMAP Queue 3)."""
    assert "--compute-variance" in GLMIX_CASES["linear_tron"].argv()
    for side, out in second_order_runs["linear_tron"].items():
        best = os.path.join(out, "best")
        with jax.enable_x64(False):
            jmodel = jio.load_game_model(best)[0]
        tmodel = tio.load_game_model(best)[0]
        assert jmodel.models["fixed"].model.coefficients.variances is None
        assert tmodel.models["fixed"].model.coefficients.variances is None


@pytest.mark.parametrize("extra", [
    ["--fixed-effect-optimization-configurations",
     "fixed:15,1e-5,10,1,TRON,L1"],
    ["--task-type", "SMOOTHED_HINGE_LOSS_LINEAR_SVM",
     "--fixed-effect-optimization-configurations",
     "fixed:15,1e-5,10,1,TRON,L2"],
], ids=["tron_l1", "smoothed_hinge_tron"])
def test_refused_optimizers_fail_as_in_the_jax_driver(runs, tmp_path,
                                                      extra):
    """TRON with L1 and TRON for the smoothed hinge raise ``ValueError``
    out of both drivers (no clean-abort exit code in either)."""
    argv = [*runs["base"], *extra]
    with jax.enable_x64(False), pytest.raises(ValueError):
        jax_train_main(argv + ["--output-dir", str(tmp_path / "j")])
    with pytest.raises(ValueError):
        ttd.main(argv + ["--output-dir", str(tmp_path / "t"), "--device",
                         "cpu"])


def test_native_ingest_trains_as_the_records_path(runs, tmp_path,
                                                  monkeypatch):
    """Both drivers above read the fixture through their native decoders.
    The port's driver with every part declined (the records path) writes
    the same objectives and validation metrics, ends on the same states,
    and its scoring driver writes the same scores."""
    from photon_ml_tpu.io.native_avro import read_columnar as jax_columnar

    load_jax_native_lib(monkeypatch)
    train = str(runs["dir"] / "train.avro")
    assert jax_columnar(train) is not None and jax_columnar(
        runs["val"]) is not None
    # scan + load of the training file, load of the validation file
    assert runs["ingest"] == {"native_parts": 3, "declined_parts": 0,
                              "records_parts": 0}
    score_argv = ["--input-data-dirs", runs["val"],
                  "--feature-shard-id-to-feature-section-keys-map",
                  SECTIONS, "--random-effect-id-set", "userId",
                  "--device", "cpu"]
    tsd.run(score_argv + ["--game-model-input-dir",
                          os.path.join(runs["out"]["torch"], "best"),
                          "--output-dir", str(tmp_path / "score_native")])

    monkeypatch.setattr(tdf, "read_columnar", lambda path: None)
    tdf.reset_ingest_stats()
    out = str(tmp_path / "records")
    result = ttd.run(runs["base"] + ["--output-dir", out, "--device",
                                     "cpu"]).best_result
    assert tdf.INGEST_STATS == {"native_parts": 0, "declined_parts": 3,
                                "records_parts": 3}
    got = _states(json.load(open(os.path.join(out, "metrics.json"))))
    want = _states(runs["metrics"]["torch"])
    assert [(s["iteration"], s["coordinate"], s["objective"],
             s["validation_metrics"]) for s in got] == [
        (s["iteration"], s["coordinate"], s["objective"],
         s["validation_metrics"]) for s in want]
    held, native = result.best_model.models, runs["result"].best_model.models
    assert torch.equal(held["fixed"].model.coefficients.means,
                       native["fixed"].model.coefficients.means)
    assert torch.equal(held["perUser"].coefficients_projected,
                       native["perUser"].coefficients_projected)
    tsd.run(score_argv + ["--game-model-input-dir",
                          os.path.join(out, "best"),
                          "--output-dir", str(tmp_path / "score_records")])
    part = os.path.join("scores", "part-00000.avro")
    assert tio.load_scored_items(str(tmp_path / "score_records" / part)) \
        == tio.load_scored_items(str(tmp_path / "score_native" / part))


def test_validation_matches_users_by_raw_id(runs, tmp_path):
    """A validation set whose users are not the training set's (user0
    missing, so every other user's code shifts by one): the port matches
    rows to per-user models by raw id, so the best state's validation AUC
    is the AUC the scoring driver gets from the saved best model."""
    val = str(tmp_path / "val.avro")
    make_game_avro(val, n=300, seed=2, skip_users=("user0",))
    out = str(tmp_path / "train")
    trainer = ttd.run(["--train-input-dirs", str(runs["dir"] / "train.avro"),
                       "--validate-input-dirs", val, "--output-dir", out,
                       *TRAIN_FLAGS, "--evaluator-type", "AUC:userId,AUC",
                       "--device", "cpu"])
    assert list(trainer.validate_data.id_vocabs["userId"]) == [
        f"user{i}" for i in range(8)]
    scorer = tsd.run(["--input-data-dirs", val,
                      "--game-model-input-dir", os.path.join(out, "best"),
                      "--output-dir", str(tmp_path / "score"),
                      "--feature-shard-id-to-feature-section-keys-map",
                      SECTIONS, "--random-effect-id-set", "userId",
                      "--evaluator-type", "AUC:userId", "--device", "cpu"])
    best = json.load(open(os.path.join(out, "metrics.json")))["best"]
    assert abs(scorer.metrics["AUC:userId"] - best["metric"]) <= 1e-6


def test_python_m_entry_points_run_on_cpu(runs, tmp_path):
    """The two commands a user types, as subprocesses, ``--device cpu``."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    train = str(runs["dir"] / "train.avro")
    out = str(tmp_path / "train")
    r = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.game_training_driver",
         "--train-input-dirs", train, "--validate-input-dirs", runs["val"],
         "--output-dir", out, *TRAIN_FLAGS, "--num-iterations", "1",
         "--device", "cpu"], cwd=repo, env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert {"metrics.json", "best"} <= set(os.listdir(out))
    r = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.game_scoring_driver",
         "--input-data-dirs", runs["val"],
         "--game-model-input-dir", os.path.join(out, "best"),
         "--output-dir", str(tmp_path / "score"),
         "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
         "--random-effect-id-set", "userId", "--device", "cpu"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert os.path.exists(tmp_path / "score" / "scores" / "part-00000.avro")


#: the multi-process flags, refused with exit 3 until the gang was ported
TRAIN_UNPORTED = [
    ("--num-processes", ["--num-processes", "2"]),
    ("--max-worker-restarts", ["--num-processes", "2",
                               "--max-worker-restarts", "1"]),
]
#: the device mesh's flags, refused until the mesh was ported: the
#: driver takes them; on the CPU it grants the entity shards asked for
#: (the mesh repeats the CPU for each), and ``auto`` is the one CPU
TRAIN_MESH_FLAGS = [
    ("--re-entity-shards", ["--re-entity-shards", "2"]),
    ("--re-entity-shards", ["--re-entity-shards", "auto"]),
    ("--collective-quant", ["--collective-quant", "int8"]),
]


@pytest.mark.parametrize("flag,extra", TRAIN_UNPORTED,
                         ids=[f"{f}={e[-1]}" for f, e in TRAIN_UNPORTED])
def test_training_driver_refuses_unported_flags(tmp_path, capsys, flag,
                                                extra):
    """Taken now: without ``--coordinator`` the multi-process check refuses
    the argv in both drivers with one message, before anything is
    written (``tests/test_torch_multihost.py`` runs the gang)."""
    argv = ["--train-input-dirs", str(tmp_path / "none.avro"),
            "--output-dir", str(tmp_path / "out"), *TRAIN_FLAGS, *extra]
    with pytest.raises(ValueError) as want:
        jax_train_main(argv)
    with pytest.raises(ValueError, match="--coordinator") as got:
        ttd.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "PHOTON_ABORT" not in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("flag,extra", TRAIN_MESH_FLAGS,
                         ids=[f"{f}={e[-1]}" for f, e in TRAIN_MESH_FLAGS])
def test_training_driver_accepts_the_mesh_flags(tmp_path, flag, extra):
    argv = ["--train-input-dirs", str(tmp_path / "none.avro"),
            "--output-dir", str(tmp_path / "out"), *TRAIN_FLAGS,
            "--device", "cpu", *extra]
    ns = ttd.parse_args(argv)
    ttd.check_unported(ns)
    ttd.resolve_entity_shards(ns)
    driver = ttd.GameTrainingDriver(ns)
    assert ns.re_entity_shards == (2 if extra[-1] == "2" else 1)
    assert driver.ns.collective_quant == ("int8" if flag.endswith("quant")
                                          else "none")


def test_training_driver_runs_precision_bf16(runs, tmp_path, monkeypatch):
    """``--precision bf16`` is no longer refused: the fixed effect and the
    per-user blocks are built in bf16 and the run ends as the f32 one
    does, with objectives within 1% of it (bf16 rounding of X)."""
    built = []
    orig = ttd.build_fixed_effect_dataset
    monkeypatch.setattr(ttd, "build_fixed_effect_dataset",
                        lambda *a, **k: built.append(k["dtype"])
                        or orig(*a, **k))
    out = str(tmp_path / "bf16")
    driver = ttd.run(runs["base"] + ["--output-dir", out, "--precision",
                                     "bf16", "--device", "cpu"])
    assert built == [torch.bfloat16]
    assert {"metrics.json", "best"} <= set(os.listdir(out))
    got = [s["objective"] for s in _states(json.load(open(
        os.path.join(out, "metrics.json"))))]
    want = [s["objective"] for s in _states(runs["metrics"]["torch"])]
    assert got != want
    np.testing.assert_allclose(got, want, rtol=1e-2)
    assert driver.best_result is not None


#: refused with exit 3 until the process split was ported
SCORE_UNPORTED = [
    ("--num-processes", ["--num-processes", "2", "--process-id", "2"]),
]


@pytest.mark.parametrize("flag,extra", SCORE_UNPORTED,
                         ids=[f for f, _ in SCORE_UNPORTED])
def test_scoring_driver_refuses_unported_flags(tmp_path, capsys, flag,
                                               extra):
    """Taken now: a process id out of range is refused by both drivers
    with one message, before the port writes anything."""
    from photon_ml_tpu.cli.game_scoring_driver import (
        GameScoringDriver as JaxScoringDriver,
        parse_args as jax_score_args,
    )

    argv = ["--input-data-dirs", str(tmp_path / "none.avro"),
            "--game-model-input-dir", str(tmp_path / "model"),
            "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
            *extra]
    with pytest.raises(ValueError) as want:
        JaxScoringDriver(jax_score_args(
            argv + ["--output-dir", str(tmp_path / "jax")])).run()
    with pytest.raises(ValueError, match=flag) as got:
        tsd.main(argv + ["--output-dir", str(tmp_path / "out"), "--device",
                         "cpu"])
    assert str(got.value) == str(want.value)
    assert "PHOTON_ABORT" not in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "out")

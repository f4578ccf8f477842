"""PyTorch port vs the JAX package: the training drivers with the
coordinate-descent extensions.

Both training drivers run one argv on the fixture of
``tests/test_torch_drivers.py`` (400 training and 200 validation rows, a
fixed effect and a per-user random effect, validation after every update)
with ``tools/glmix_cases.CD_EXTENSION_FLAGS``: ``--cd-pipeline-depth 1
--cd-block-size 2 --re-lane-compaction-chunk auto`` and the fixed effect
down-sampled at rate 0.5. The JAX side runs inside
``jax.enable_x64(False)`` (f32, like the port; ``tests/test_torch_game.py``
says why).

- ``metrics.json`` agrees update by update: objectives and validation
  metrics to rel 1e-4, the best metric to 1e-4; both drivers take one
  epilogue read for the block of two updates;
- each package reads the other's ``best/`` exactly and scores it to the
  other's scores within 1e-5;
- the flags parse to the JAX driver's defaults (block size 1, pipeline
  depth unset and run as 1, compaction chunk 0, ``auto`` as -1), and
  ``_lane_chunk`` maps them as the JAX driver does.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import game_training_driver as jtd
from photon_ml_tpu.cli.game_scoring_driver import main as jax_score_main
from photon_ml_tpu.game import coordinate_descent as jcd
from photon_ml_tpu.io import model_io as jio
from photon_ml_tpu_torch.cli import game_scoring_driver as tsd
from photon_ml_tpu_torch.cli import game_training_driver as ttd
from photon_ml_tpu_torch.game import coordinate_descent as tcd
from photon_ml_tpu_torch.io import model_io as tio
from photon_ml_tpu_torch.tools.glmix_cases import CD_EXTENSION_FLAGS
from test_torch_drivers import (
    SECTIONS,
    TRAIN_FLAGS,
    _coefs,
    _states,
    make_game_avro,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cd_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("drivers_cd")
    train, val = str(d / "train.avro"), str(d / "val.avro")
    make_game_avro(train, seed=0)
    make_game_avro(val, n=200, seed=1)
    base = ["--train-input-dirs", train, "--validate-input-dirs", val,
            *TRAIN_FLAGS, *CD_EXTENSION_FLAGS]
    out = {"jax": str(d / "jax"), "torch": str(d / "torch")}
    hot = {}
    with jax.enable_x64(False):
        jcd.reset_hot_loop_stats()
        jtd.main(base + ["--output-dir", out["jax"]])
        hot["jax"] = dict(jcd.HOT_LOOP_STATS)
    tcd.reset_hot_loop_stats()
    ttd.run(base + ["--output-dir", out["torch"], "--device", "cpu"])
    hot["torch"] = dict(tcd.HOT_LOOP_STATS)
    metrics = {k: json.load(open(os.path.join(v, "metrics.json")))
               for k, v in out.items()}
    return dict(dir=d, val=val, out=out, metrics=metrics, hot=hot)


def test_metrics_agree_update_by_update(cd_runs):
    js = _states(cd_runs["metrics"]["jax"])
    ts = _states(cd_runs["metrics"]["torch"])
    assert len(js) == len(ts) == 4
    for j, t in zip(js, ts):
        assert (j["iteration"], j["coordinate"]) == (t["iteration"],
                                                     t["coordinate"])
        assert t["objective"] == pytest.approx(j["objective"], rel=1e-4)
        assert set(t["validation_metrics"]) == set(j["validation_metrics"])
        for name, v in t["validation_metrics"].items():
            assert v == pytest.approx(j["validation_metrics"][name],
                                      rel=1e-4), name
    assert all(np.isfinite([s["objective"] for s in ts]))
    best_j = cd_runs["metrics"]["jax"]["best"]["metric"]
    best_t = cd_runs["metrics"]["torch"]["best"]["metric"]
    assert abs(best_t - best_j) <= 1e-4


def test_one_read_per_block_in_both_drivers(cd_runs):
    for side in ("jax", "torch"):
        hot = cd_runs["hot"][side]
        assert hot["updates"] == 4, side
        assert hot["epilogue_fetches"] == 2, side


@pytest.mark.parametrize("model_side", ["jax", "torch"])
def test_models_cross_read_and_score(cd_runs, model_side):
    best = os.path.join(cd_runs["out"][model_side], "best")
    with jax.enable_x64(False):
        jc = _coefs(jio.load_game_model(best)[0])
    tc = _coefs(tio.load_game_model(best)[0])
    assert set(jc) == set(tc) == {"fixed", "perUser"}
    for cid in jc:
        assert set(jc[cid]) == set(tc[cid])
        for key in jc[cid]:
            assert np.array_equal(jc[cid][key], tc[cid][key]), (cid, key)
    common = ["--input-data-dirs", cd_runs["val"],
              "--game-model-input-dir", best,
              "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
              "--random-effect-id-set", "userId", "--evaluator-type", "AUC"]
    out_j = str(cd_runs["dir"] / f"score_jax_{model_side}")
    out_t = str(cd_runs["dir"] / f"score_torch_{model_side}")
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
    recorded = cd_runs["metrics"][model_side]["best"]["metric"]
    assert abs(driver.metrics["AUC"] - recorded) <= 1e-4


BASE = ["--train-input-dirs", "x", "--task-type", "LOGISTIC_REGRESSION",
        "--feature-shard-id-to-feature-section-keys-map", "g:f",
        "--updating-sequence", "fixed"]


@pytest.mark.parametrize("extra", [
    [], ["--cd-block-size", "4", "--cd-pipeline-depth", "0"],
    ["--re-lane-compaction-chunk", "auto"],
    ["--re-lane-compaction-chunk", "8"],
    ["--re-lane-compaction-chunk", "-3"]],
    ids=["defaults", "block4_depth0", "auto", "chunk8", "negative"])
def test_flags_parse_as_the_jax_driver_parses_them(tmp_path, extra):
    argv = BASE + ["--output-dir", str(tmp_path)] + extra
    jns = jtd.parse_args(argv)
    tns = ttd.parse_args(argv + ["--device", "cpu"])
    for name in ("cd_block_size", "cd_pipeline_depth",
                 "re_lane_compaction_chunk"):
        assert getattr(tns, name) == getattr(jns, name), name
    assert ttd.GameTrainingDriver(tns)._lane_chunk() == \
        jtd.GameTrainingDriver(jns)._lane_chunk()
    ttd.check_unported(tns)

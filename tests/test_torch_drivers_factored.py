"""PyTorch port vs the JAX package: factored random effects and RANDOM
projection through the GAME drivers.

The JAX driver suite's ``fixed_factored`` argv
(``tests/test_drivers.py:512-519``: a fixed effect and an
IDENTITY-projected per-user coordinate trained as a factored random
effect, latent dimension 2, two inner iterations, two sweeps) and a
RANDOM-projected (``random=2``) plain per-user coordinate, on the same
fixture as there (300 training rows, seed 30; 120 scoring rows, seed 31),
through both packages' training drivers (the JAX side inside
``jax.enable_x64(False)``, the port's with ``--device cpu``):

- metrics.json's objectives agree update by update, to rel 1e-4
  (measured 3.8e-5 factored, 3.9e-7 random; ``tests/test_torch_factored.py``
  explains why a factored update is held to 1e-4);
- the factored coordinate is saved as a plain random-effect directory;
  each package loads the other's ``best/`` to the same coefficients (to
  5e-3: the two trainings' f32 end points, as in
  ``tests/test_torch_game.py``), and each scoring driver scores both
  models, to 1e-5 abs by uid for the same model;
- ``--random-effect-block-buckets`` leaves a factored coordinate's
  dataset in one block (the run is bit-equal to one without the flag);
- a factored config for a coordinate that is not a random effect of the
  updating sequence raises ``ValueError`` before any data is read.
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
from photon_ml_tpu_torch.cli import game_scoring_driver as tsd
from photon_ml_tpu_torch.cli import game_training_driver as ttd
from photon_ml_tpu_torch.io import model_io as tio

from test_torch_drivers import make_game_avro

torch.set_num_threads(1)
SECTIONS = "global:globalFeatures|user:userFeatures"
BASE = [
    "--task-type", "LOGISTIC_REGRESSION",
    "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
    "--num-iterations", "2",
    "--fixed-effect-data-configurations", "fixed:global,1",
    "--fixed-effect-optimization-configurations",
    "fixed:30,1e-7,0.1,1,LBFGS,L2",
]
FACTORED = [
    "--updating-sequence", "fixed,perUserFactored",
    "--random-effect-data-configurations",
    "perUserFactored:userId,user,1,-,-,-,identity",
    "--factored-random-effect-optimization-configurations",
    "perUserFactored:20,1e-7,1.0,1,LBFGS,L2:20,1e-7,0.1,1,LBFGS,L2:2,2",
]
VARIANTS = {
    "fixed_factored": FACTORED,
    "fixed_random_projected": [
        "--updating-sequence", "fixed,perUser",
        "--random-effect-data-configurations",
        "perUser:userId,user,1,-,-,-,random=2",
        "--random-effect-optimization-configurations",
        "perUser:30,1e-7,1.0,1,LBFGS,L2"],
}


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("drivers_factored")
    train, score = str(d / "train.avro"), str(d / "score.avro")
    make_game_avro(train, n=300, seed=30)
    make_game_avro(score, n=120, seed=31)
    return dict(dir=d, train=train, score=score)


@pytest.fixture(scope="module")
def runs(fixture):
    out = {}
    for name, extra in VARIANTS.items():
        argv = ["--train-input-dirs", fixture["train"], *BASE, *extra]
        out[name] = {"jax": str(fixture["dir"] / f"jax_{name}"),
                     "torch": str(fixture["dir"] / f"torch_{name}")}
        with jax.enable_x64(False):
            jax_train_main(argv + ["--output-dir", out[name]["jax"]])
        ttd.run(argv + ["--output-dir", out[name]["torch"], "--device",
                        "cpu"])
    return out


def _states(out_dir):
    with open(os.path.join(out_dir, "metrics.json")) as fh:
        (grid,) = json.load(fh)["grid"]
    return grid["states"]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_objectives_agree_update_by_update(runs, variant):
    js = _states(runs[variant]["jax"])
    ts = _states(runs[variant]["torch"])
    assert len(js) == len(ts) == 4
    for j, t in zip(js, ts):
        assert (j["iteration"], j["coordinate"]) == (t["iteration"],
                                                     t["coordinate"])
        assert np.isfinite(t["objective"])
        assert t["objective"] == pytest.approx(j["objective"], rel=1e-4)


def _coefs(model):
    return {cid: ({str(e): np.asarray(m.coefficients[i], np.float32)
                   for i, e in enumerate(m.entity_ids)}
                  if hasattr(m, "entity_ids")
                  else {"": np.asarray(m.model.coefficients.means,
                                       np.float32)})
            for cid, m in model.models.items()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_models_cross_read(runs, variant):
    re_cid = "perUserFactored" if variant == "fixed_factored" else "perUser"
    loaded = {}
    for side in ("jax", "torch"):
        best = os.path.join(runs[variant][side], "best")
        assert sorted(os.listdir(os.path.join(best, "random-effect"))) == \
            [re_cid]
        with jax.enable_x64(False):
            jc = _coefs(jio.load_game_model(best)[0])
        tc = _coefs(tio.load_game_model(best)[0])
        for cid in jc:
            assert set(jc[cid]) == set(tc[cid])
            for key in jc[cid]:
                assert np.array_equal(jc[cid][key], tc[cid][key])
        loaded[side] = tc
    assert len(loaded["torch"][re_cid]) == 8
    for cid, by_key in loaded["jax"].items():
        for key, v in by_key.items():
            np.testing.assert_allclose(loaded["torch"][cid][key], v,
                                       rtol=1e-3, atol=5e-3)


@pytest.mark.parametrize("model_side", ["jax", "torch"])
def test_each_scoring_driver_scores_both_factored_models(runs, fixture,
                                                         model_side):
    best = os.path.join(runs["fixed_factored"][model_side], "best")
    common = ["--input-data-dirs", fixture["score"],
              "--game-model-input-dir", best,
              "--feature-shard-id-to-feature-section-keys-map", SECTIONS,
              "--random-effect-id-set", "userId"]
    out_j = str(fixture["dir"] / f"score_jax_{model_side}")
    out_t = str(fixture["dir"] / f"score_torch_{model_side}")
    with jax.enable_x64(False):
        jax_score_main(common + ["--output-dir", out_j])
    tsd.run(common + ["--output-dir", out_t, "--device", "cpu"])
    part = os.path.join("scores", "part-00000.avro")
    js = {r["uid"]: r["predictionScore"]
          for r in jio.load_scored_items(os.path.join(out_j, part))}
    ts = {r["uid"]: r["predictionScore"]
          for r in tio.load_scored_items(os.path.join(out_t, part))}
    assert len(ts) == 120 and set(js) == set(ts)
    assert max(abs(js[u] - ts[u]) for u in js) <= 1e-5


def test_block_buckets_leave_a_factored_coordinate_in_one_block(
        runs, fixture):
    out = str(fixture["dir"] / "torch_factored_buckets")
    driver = ttd.run(["--train-input-dirs", fixture["train"], *BASE,
                      *FACTORED, "--random-effect-block-buckets", "4",
                      "--output-dir", out, "--device", "cpu"])
    fac = driver.best_result.model.models["perUserFactored"]
    assert type(fac).__name__ == "FactoredRandomEffectModel"
    assert [s["objective"] for s in _states(out)] == \
        [s["objective"] for s in _states(runs["fixed_factored"]["torch"])]


@pytest.mark.parametrize("sequence,configs", [
    ("fixed,perUser", "perUserX:20,1e-7,1,1,LBFGS,L2:20,1e-7,1,1,LBFGS,L2"
                      ":2,2"),
    ("fixed", "perUser:20,1e-7,1,1,LBFGS,L2:20,1e-7,1,1,LBFGS,L2:2,2"),
])
def test_factored_config_for_an_unknown_coordinate_is_refused(
        tmp_path, sequence, configs):
    argv = ["--train-input-dirs", str(tmp_path / "none.avro"),
            "--output-dir", str(tmp_path / "out"), *BASE,
            "--updating-sequence", sequence,
            "--random-effect-data-configurations",
            "perUser:userId,user,1,-,-,-,identity",
            "--factored-random-effect-optimization-configurations", configs,
            "--device", "cpu"]
    with pytest.raises(ValueError, match="factored configs for unknown "
                                         "coordinates"):
        ttd.run(argv)
    assert not os.path.exists(tmp_path / "out")

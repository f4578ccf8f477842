"""PyTorch port vs the JAX package: IDENTITY and RANDOM projection, the
matrix-factorization model and its LatentFactorAvro files.

A small GAME fixture (1,200 rows, 20 power-law users, 15 movies, 12
half-sparse per-user features; per-user active cap 32, so some users have
passive rows) built in both packages from the same numpy data:

- IDENTITY- and RANDOM-projected (``random=5``) random-effect datasets
  are equal array for array, active blocks and passive rows, single-block
  and bucketed (three buckets asked, two needed), the random projector's
  matrix included;
- a RANDOM-projected coordinate's solve (f64 blocks) and its published
  model's raw coefficients and scores agree with the JAX package's
  (rtol 1e-8; the raw map is the projector's transpose, the same numpy
  product);
- the MF model scores on the device as the JAX package scores on the host
  (rel 1e-6: the row-wise sum of 8 products, in another order), by code
  and by raw id, ids without factors scoring 0;
- a LatentFactorAvro directory written by either package reads back in
  the other to the same ids and f32 tables, and scores the same;
- ``save_game_model`` writes a factored coordinate as a plain
  random-effect directory that both packages load to the same raw
  coefficients, and refuses an MF coordinate with the JAX package's
  ``TypeError``;
- ``serve.scoring.materialize_model`` turns projected and factored
  coordinates into raw ones that score the same bit for bit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.game import dataset as jds
from photon_ml_tpu.game import models as jmodels
from photon_ml_tpu.game import random_effect as jre
from photon_ml_tpu.io import model_io as jio
from photon_ml_tpu.io.index_map import IndexMap as JIndexMap
from photon_ml_tpu.optimize import config as jcfg
from photon_ml_tpu.projector import projectors as jproj
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.game import coordinate as tco
from photon_ml_tpu_torch.game import dataset as tds
from photon_ml_tpu_torch.game import models as tmodels
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.io import model_io as tio
from photon_ml_tpu_torch.io.index_map import IndexMap as TIndexMap
from photon_ml_tpu_torch.optimize import config as tcfg
from photon_ml_tpu_torch.projector import projectors as tproj
from photon_ml_tpu_torch.serve.scoring import materialize_model

torch.set_num_threads(1)
N, USERS, MOVIES, D_USER, LATENT = 1200, 20, 15, 12, 8


def _game_dataset(mod, seed=5):
    rng = np.random.default_rng(seed)
    users = (rng.zipf(1.3, size=N) % USERS).astype(np.int64)
    movies = rng.integers(0, MOVIES, N)
    Xu = (rng.normal(size=(N, D_USER))
          * (rng.uniform(size=(N, D_USER)) < 0.5)).astype(np.float32)
    y = (rng.uniform(size=N) < 1 / (1 + np.exp(-Xu.sum(1)))).astype(
        np.float64)
    data = mod.GameDataset(responses=y, offsets=rng.normal(size=N) * 0.1,
                           feature_shards={"user": sp.csr_matrix(Xu)})
    data.encode_ids("userId", users)
    data.encode_ids("movieId", movies)
    return data


@pytest.fixture(scope="module")
def data():
    return dict(j=_game_dataset(jds), t=_game_dataset(tds))


def _config(mod, proj, projector):
    return mod.RandomEffectDataConfiguration(
        "userId", "user", num_active_data_points_upper_bound=32,
        projector=proj.ProjectorConfig.parse(projector))


def _build(data, projector, num_buckets=1, dtype=None):
    jkw = {} if dtype is None else {"dtype": jnp.float64}
    tkw = {} if dtype is None else {"dtype": torch.float64}
    return (jds.build_random_effect_dataset(
                data["j"], _config(jds, jproj, projector),
                num_buckets=num_buckets, **jkw),
            tds.build_random_effect_dataset(
                data["t"], _config(tds, tproj, projector),
                num_buckets=num_buckets, device="cpu", **tkw))


def _equal(a, b):
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("num_buckets", [1, 3])
@pytest.mark.parametrize("projector", ["identity", "random=5"])
def test_datasets_match_jax(data, projector, num_buckets):
    j, t = _build(data, projector, num_buckets)
    assert t.projectors is None
    if projector == "identity":
        assert t.random_projector is None and t.reduced_dim == D_USER
    else:
        assert t.reduced_dim == 5
        _equal(j.random_projector.matrix, t.random_projector.matrix)
    _equal(j.entity_codes, t.entity_codes)
    assert (j.num_entities, j.reduced_dim, j.num_passive) == \
        (t.num_entities, t.reduced_dim, t.num_passive)
    assert t.num_passive > 0
    fields = ("X", "labels", "base_offsets", "weights", "row_ids")
    if num_buckets == 1:
        assert j.buckets is None and t.buckets is None
        pairs = [(j, t)]
    else:
        assert len(j.buckets) == len(t.buckets) > 1
        pairs = list(zip(j.buckets, t.buckets))
        for jb, tb in pairs:
            assert (jb.entity_start, jb.num_real) == (tb.entity_start,
                                                      tb.num_real)
    for a, b in pairs:
        for f in fields:
            _equal(getattr(a, f), getattr(b, f))
    for f in ("passive_X", "passive_entity", "passive_row_ids",
              "passive_offsets"):
        _equal(getattr(j, f), getattr(t, f))


def _l2(cfg):
    return cfg.GLMOptimizationConfiguration(
        max_iterations=20, tolerance=1e-7, regularization_weight=1.0,
        optimizer_type=cfg.OptimizerType.LBFGS,
        regularization_context=cfg.RegularizationContext(
            cfg.RegularizationType.L2))


def test_random_projected_solve_and_model_match_jax(data):
    j, t = _build(data, "random=5", num_buckets=3, dtype="f64")
    jout = jre.RandomEffectOptimizationProblem(
        config=_l2(jcfg), task=jcfg.TaskType.LOGISTIC_REGRESSION).run(
            j, j.offsets_with(jnp.zeros(N)))
    tout = tre.RandomEffectOptimizationProblem(
        config=_l2(tcfg), task=tcfg.TaskType.LOGISTIC_REGRESSION).run(
            t, t.offsets_with(torch.zeros(N, dtype=torch.float64)))
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    coefs = np.asarray(jout[0]).astype(np.float32)
    jm = jmodels.RandomEffectModelInProjectedSpace(
        "userId", "user", j.entity_codes, jnp.asarray(coefs),
        random_projector=j.random_projector)
    tm = tco.RandomEffectCoordinate(dataset=t, problem=None).publish(
        torch.from_numpy(coefs))
    assert tm.random_projector is t.random_projector
    _equal(jm.to_raw().coefficients, tm.to_raw().coefficients)
    np.testing.assert_allclose(tm.score(data["t"], device="cpu").numpy(),
                               np.asarray(jm.score(data["j"])), rtol=1e-6,
                               atol=1e-6)


def _factors(seed=2, rows=USERS, cols=MOVIES):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, LATENT)).astype(np.float32),
            rng.normal(size=(cols, LATENT)).astype(np.float32))


@pytest.mark.parametrize("by_ids", [False, True])
def test_mf_scores_match_jax(data, by_ids):
    # the tables miss the last users and movies: their rows score 0
    rf, cf = _factors(rows=USERS - 3, cols=MOVIES - 2)
    ids = {}
    if by_ids:
        ids = dict(row_ids=np.asarray(data["j"].id_vocabs["userId"])[
                       :USERS - 3][::-1].astype(str),
                   col_ids=np.asarray(data["j"].id_vocabs["movieId"])[
                       :MOVIES - 2].astype(str))
        rf = rf.copy()
    jm = jmodels.MatrixFactorizationModel(
        "userId", "movieId", jnp.asarray(rf), jnp.asarray(cf), **ids)
    tm = convert.matrix_factorization_from_numpy(
        "userId", "movieId", rf, cf, device="cpu", **ids)
    assert tm.num_latent_factors == LATENT
    got = tm.score(data["t"], device="cpu")
    assert got.dtype == torch.float32 and got.shape == (N,)
    want = np.asarray(jm.score(data["j"]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    unseen = (data["t"].id_columns["userId"] >= USERS - 3) | \
        (data["t"].id_columns["movieId"] >= MOVIES - 2)
    if by_ids:
        unseen = ~np.isin(
            np.asarray(data["t"].id_vocabs["userId"])[
                data["t"].id_columns["userId"]].astype(str),
            ids["row_ids"]) | (data["t"].id_columns["movieId"]
                               >= MOVIES - 2)
    assert unseen.any() and not unseen.all()
    assert np.all(got.numpy()[unseen] == 0.0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_latent_factor_files_cross_read(data, tmp_path, writer):
    rf, cf = _factors()
    vocabs = {t: data["j"].id_vocabs[t] for t in ("userId", "movieId")}
    jm = jmodels.MatrixFactorizationModel("userId", "movieId",
                                          jnp.asarray(rf), jnp.asarray(cf))
    tm = convert.matrix_factorization_from_numpy("userId", "movieId", rf,
                                                 cf, device="cpu")
    out = str(tmp_path / "mf")
    if writer == "port":
        tio.save_matrix_factorization_model(tm, out, entity_vocabs=vocabs,
                                            num_output_files=2)
    else:
        jio.save_matrix_factorization_model(jm, out, entity_vocabs=vocabs,
                                            num_output_files=2)
    assert sorted(os.listdir(os.path.join(out, "userId"))) == \
        ["part-00000.avro", "part-00001.avro"]
    jback = jio.load_matrix_factorization_model(out, "userId", "movieId")
    tback = tio.load_matrix_factorization_model(out, "userId", "movieId")
    assert list(tback.row_ids) == list(jback.row_ids)
    assert list(tback.col_ids) == list(jback.col_ids)
    _equal(jback.row_factors, tback.row_factors)
    _equal(jback.col_factors, tback.col_factors)
    _equal(rf, tback.row_factors)
    got = tback.score(data["t"], device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jback.score(data["j"])),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, tm.score(data["t"], device="cpu"),
                               rtol=1e-6, atol=1e-6)


def _index_map(mod_map):
    from photon_ml_tpu_torch.io.index_map import feature_key

    return mod_map.from_keys([feature_key(f"u{j}", "")
                              for j in range(D_USER)])


def test_factored_model_saves_as_a_plain_random_effect(data, tmp_path):
    _, t = _build(data, "identity")
    rng = np.random.default_rng(4)
    coefs = rng.normal(size=(t.num_entities, 3)).astype(np.float32)
    B = rng.normal(size=(3, D_USER)).astype(np.float32)
    fac = tmodels.FactoredRandomEffectModel(
        "userId", "user", t.entity_codes, torch.from_numpy(coefs),
        torch.from_numpy(B))
    out = str(tmp_path / "game")
    vocabs = {"userId": data["t"].id_vocabs["userId"]}
    tio.save_game_model(tmodels.GameModel({"fac": fac}), out,
                        {"user": _index_map(TIndexMap)},
                        entity_vocabs=vocabs)
    assert sorted(os.listdir(os.path.join(out, "random-effect"))) == ["fac"]
    with open(os.path.join(out, "random-effect", "fac", "id-info")) as fh:
        assert fh.read().split() == ["userId", "user"]
    jmodel, _ = jio.load_game_model(out, {"user": _index_map(JIndexMap)})
    tmodel, _ = tio.load_game_model(out, {"user": _index_map(TIndexMap)})
    raw = fac.to_raw().coefficients.numpy()
    ids = np.asarray(vocabs["userId"])[t.entity_codes].astype(str)
    for m in (jmodel.models["fac"], tmodel.models["fac"]):
        order = np.argsort(np.asarray(m.entity_ids).astype(str))
        want = raw[np.argsort(ids)]
        np.testing.assert_allclose(np.asarray(m.coefficients)[order], want,
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tmodel.score(data["t"], device="cpu").numpy(),
        fac.score(data["t"], device="cpu").numpy(), rtol=1e-5, atol=1e-5)


def test_game_directory_refuses_an_mf_model(tmp_path):
    rf, cf = _factors()
    jm = jmodels.MatrixFactorizationModel("userId", "movieId",
                                          jnp.asarray(rf), jnp.asarray(cf))
    tm = convert.matrix_factorization_from_numpy("userId", "movieId", rf,
                                                 cf, device="cpu")
    with pytest.raises(TypeError) as je:
        jio.save_game_model(jmodels.GameModel({"mf": jm}),
                            str(tmp_path / "j"), {})
    with pytest.raises(TypeError) as te:
        tio.save_game_model(tmodels.GameModel({"mf": tm}),
                            str(tmp_path / "t"), {})
    assert str(te.value) == str(je.value)


def test_materialize_scores_the_same(data):
    _, t = _build(data, "random=5")
    rng = np.random.default_rng(6)
    proj = tmodels.RandomEffectModelInProjectedSpace(
        "userId", "user", t.entity_codes, torch.from_numpy(
            rng.normal(size=(t.num_entities, 5)).astype(np.float32)),
        random_projector=t.random_projector)
    fac = tmodels.FactoredRandomEffectModel(
        "userId", "user", t.entity_codes,
        torch.from_numpy(rng.normal(size=(t.num_entities, 2)).astype(
            np.float32)),
        torch.from_numpy(rng.normal(size=(2, D_USER)).astype(np.float32)))
    model = tmodels.GameModel({"proj": proj, "fac": fac})
    raw = materialize_model(model)
    assert all(type(m) is tmodels.RandomEffectModel
               for m in raw.models.values())
    assert torch.equal(raw.score(data["t"], device="cpu"),
                       model.score(data["t"], device="cpu"))

"""PyTorch port vs the JAX package: the GLMix slice end to end.

One small MovieLens-shaped GLMix (3,000 rows, 40 users, 60 movies, 8
global features; per-user active cap 64 and feature cap 24, four entity
buckets) goes through the JAX package and the port on the same numpy data.

- The dataset builds agree array for array (``np.array_equal``).
- The random-effect solve runs in f64 on both sides (f64 blocks): the
  coefficients agree to rtol 1e-8, iteration counts and codes exactly.
- Scoring and coordinate descent run in f32 on both sides, the
  production dtype. The suite turns on JAX x64, under which the JAX
  package computes its canonical score total (``coordinate_descent.py:193``)
  and warm-start solver state in f64, and an f32 warm start then fails its
  line search's dtype checks; so the JAX coordinate-descent runs here take
  place inside ``jax.enable_x64(False)``, where the JAX side computes in
  f32 throughout, like the port. Both sides start from the same explicit
  f32 zero states. Objectives agree to rel 1e-4 per update. The final
  states agree to rtol 1e-3 / atol 5e-3: many f32 solves end on
  ObjectiveNotImproving, i.e. where the f32 objective stops resolving
  progress, and two such end points may lie sqrt(2 eps f / lambda) apart —
  about 2e-3 for a per-user solve (f ~ 44, lambda 1) and 5e-3 for the
  fixed effect (f ~ 1860, lambda 10), with eps = 6e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.game import coordinate as jco
from photon_ml_tpu.game import coordinate_descent as jcd
from photon_ml_tpu.game import dataset as jds
from photon_ml_tpu.game import random_effect as jre
from photon_ml_tpu.optimize import config as jcfg
from photon_ml_tpu.optimize.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.game import coordinate as tco
from photon_ml_tpu_torch.game import coordinate_descent as tcd
from photon_ml_tpu_torch.game import dataset as tds
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.optimize import config as tcfg
from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem as TProblem

torch.set_num_threads(1)
N, USERS, MOVIES, D_GLOBAL = 3000, 40, 60, 8
RE_CONFIG = dict(random_effect_type="userId", feature_shard_id="per_user",
                 num_active_data_points_upper_bound=64,
                 num_features_to_keep_upper_bound=24)


def _game_dataset(mod, seed=7):
    """The MovieLens-shaped recipe of bench.py:581, on ``mod.GameDataset``."""
    rng = np.random.default_rng(seed)
    users = (rng.zipf(1.3, size=N) % USERS).astype(np.int64)
    movies = rng.integers(0, MOVIES, N)
    Xg = (rng.normal(size=(N, D_GLOBAL)) / np.sqrt(D_GLOBAL)).astype(
        np.float32)
    wg = rng.normal(size=D_GLOBAL).astype(np.float32)
    logits = Xg @ wg + 0.5 * rng.normal(size=USERS)[users].astype(np.float32)
    y = (rng.uniform(size=N) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    one = np.ones(N, np.float32)
    data = mod.GameDataset(responses=y, feature_shards={
        "global": sp.csr_matrix(Xg),
        "per_user": sp.csr_matrix((one, (np.arange(N), movies)),
                                  shape=(N, MOVIES))})
    data.encode_ids("userId", users)
    return data


def _l2(cfg, lam, iters):
    return cfg.GLMOptimizationConfiguration(
        max_iterations=iters, tolerance=1e-7, regularization_weight=lam,
        optimizer_type=cfg.OptimizerType.LBFGS,
        regularization_context=cfg.RegularizationContext(
            cfg.RegularizationType.L2))


@pytest.fixture(scope="module")
def sides():
    jdata, tdata = _game_dataset(jds), _game_dataset(tds)
    jfe = jds.build_fixed_effect_dataset(jdata, "global")
    tfe = tds.build_fixed_effect_dataset(tdata, "global", device="cpu")
    jre_ds = jds.build_random_effect_dataset(
        jdata, jds.RandomEffectDataConfiguration(**RE_CONFIG), num_buckets=4)
    tre_ds = tds.build_random_effect_dataset(
        tdata, tds.RandomEffectDataConfiguration(**RE_CONFIG), num_buckets=4,
        device="cpu")
    task_j = jcfg.TaskType.LOGISTIC_REGRESSION
    task_t = tcfg.TaskType.LOGISTIC_REGRESSION
    jcoords = {
        "fixed": jco.FixedEffectCoordinate(
            dataset=jfe, problem=JProblem(config=_l2(jcfg, 10.0, 40),
                                          task=task_j)),
        "per-user": jco.RandomEffectCoordinate(
            dataset=jre_ds, problem=jre.RandomEffectOptimizationProblem(
                config=_l2(jcfg, 1.0, 20), task=task_j))}
    tcoords = {
        "fixed": tco.FixedEffectCoordinate(
            dataset=tfe, problem=TProblem(config=_l2(tcfg, 10.0, 40),
                                          task=task_t)),
        "per-user": tco.RandomEffectCoordinate(
            dataset=tre_ds, problem=tre.RandomEffectOptimizationProblem(
                config=_l2(tcfg, 1.0, 20), task=task_t))}
    return dict(jdata=jdata, tdata=tdata, jcoords=jcoords, tcoords=tcoords)


def _zero_states(ds):
    return {"fixed": np.zeros(D_GLOBAL, np.float32),
            "per-user": np.zeros((ds.num_entities, ds.reduced_dim),
                                 np.float32)}


def _jax_cd(sides, sweeps, states):
    d = sides["jdata"]
    with jax.enable_x64(False):
        res = jcd.run_coordinate_descent(
            sides["jcoords"], sweeps, jcfg.TaskType.LOGISTIC_REGRESSION,
            jnp.asarray(d.responses, jnp.float32),
            jnp.asarray(d.weights, jnp.float32),
            jnp.asarray(d.offsets, jnp.float32),
            initial_states={k: jnp.asarray(v) for k, v in states.items()},
            pipeline_depth=0)
        scores = np.asarray(res.model.score(d))
    return res, scores


def _jax_states(res):
    m = res.model.models
    return {"fixed": np.asarray(m["fixed"].model.coefficients.means),
            "per-user": np.asarray(m["per-user"].coefficients_projected)}


@pytest.fixture(scope="module")
def jax_runs(sides):
    zeros = _zero_states(sides["tcoords"]["per-user"].dataset)
    two, two_scores = _jax_cd(sides, 2, zeros)
    one, _ = _jax_cd(sides, 1, zeros)
    return dict(two=two, two_scores=two_scores, one=one, zeros=zeros)


def _equal(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert np.array_equal(a, b), (a.shape, b.shape)


def test_fixed_effect_dataset_matches_jax(sides):
    jb = sides["jcoords"]["fixed"].dataset.batch
    tb = sides["tcoords"]["fixed"].dataset.batch
    for f in ("X", "labels", "offsets", "weights"):
        _equal(getattr(jb, f), getattr(tb, f))
    assert tb.X.dtype == torch.float32


@pytest.mark.parametrize("num_buckets", [1, 4])
def test_random_effect_dataset_matches_jax(sides, num_buckets):
    j = jds.build_random_effect_dataset(
        sides["jdata"], jds.RandomEffectDataConfiguration(**RE_CONFIG),
        num_buckets=num_buckets)
    t = tds.build_random_effect_dataset(
        sides["tdata"], tds.RandomEffectDataConfiguration(**RE_CONFIG),
        num_buckets=num_buckets, device="cpu")
    _equal(j.entity_codes, t.entity_codes)
    _equal(j.projectors.raw_indices, t.projectors.raw_indices)
    _equal(j.projectors.reduced_dims, t.projectors.reduced_dims)
    assert (j.num_entities, j.reduced_dim, j.num_passive) == \
        (t.num_entities, t.reduced_dim, t.num_passive)
    fields = ("X", "labels", "base_offsets", "weights", "row_ids")
    if num_buckets == 1:
        assert j.buckets is None and t.buckets is None
        for f in fields:
            _equal(getattr(j, f), getattr(t, f))
    else:
        assert len(j.buckets) == len(t.buckets) == 4
        for jb, tb in zip(j.buckets, t.buckets):
            assert (jb.entity_start, jb.num_real) == (tb.entity_start,
                                                      tb.num_real)
            for f in fields:
                _equal(getattr(jb, f), getattr(tb, f))
    for f in ("passive_X", "passive_entity", "passive_row_ids",
              "passive_offsets"):
        _equal(getattr(j, f), getattr(t, f))


def test_random_effect_problem_run_matches_jax(sides):
    """f64 blocks on both sides: the solves are compared in f64."""
    cfg_j, cfg_t = _l2(jcfg, 1.0, 20), _l2(tcfg, 1.0, 20)
    j = jds.build_random_effect_dataset(
        sides["jdata"], jds.RandomEffectDataConfiguration(**RE_CONFIG),
        num_buckets=4, dtype=jnp.float64)
    t = tds.build_random_effect_dataset(
        sides["tdata"], tds.RandomEffectDataConfiguration(**RE_CONFIG),
        num_buckets=4, dtype=torch.float64, device="cpu")
    jout = jre.RandomEffectOptimizationProblem(
        config=cfg_j, task=jcfg.TaskType.LOGISTIC_REGRESSION).run(
            j, j.offsets_with(jnp.zeros(N)))
    tout = tre.RandomEffectOptimizationProblem(
        config=cfg_t, task=tcfg.TaskType.LOGISTIC_REGRESSION).run(
            t, t.offsets_with(torch.zeros(N, dtype=torch.float64)))
    jc, jit, jv, jk = (np.asarray(a) for a in jout)
    tc, tit, tv, tk = (a.numpy() for a in tout)
    assert tc.dtype == np.float64
    np.testing.assert_array_equal(tit, jit)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_allclose(tc, jc, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(tv, jv, rtol=1e-8)


def test_score_random_effect_matches_jax(sides):
    jds_, tds_ = (sides[k]["per-user"].dataset for k in ("jcoords",
                                                          "tcoords"))
    coefs = np.random.default_rng(4).normal(
        size=(tds_.num_entities, tds_.reduced_dim)).astype(np.float32)
    want = np.asarray(jre.score_random_effect(jds_, jnp.asarray(coefs)))
    got = tre.score_random_effect(tds_, torch.from_numpy(coefs))
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_game_model_score_matches_jax(sides):
    rng = np.random.default_rng(5)
    ds = sides["tcoords"]["per-user"].dataset
    states = {"fixed": rng.normal(size=D_GLOBAL).astype(np.float32),
              "per-user": rng.normal(size=(ds.num_entities, ds.reduced_dim)
                                     ).astype(np.float32)}
    jmodel = jcd.publish_game_model(
        sides["jcoords"], {k: jnp.asarray(v) for k, v in states.items()})
    tmodel = tcd.publish_game_model(
        sides["tcoords"], convert.states_from_numpy(states, device="cpu"))
    got = tmodel.score(sides["tdata"], device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmodel.score(sides["jdata"])),
                               rtol=1e-5, atol=1e-5)


def _port_cd(sides, sweeps, states):
    d = sides["tdata"]
    return tcd.run_coordinate_descent(
        sides["tcoords"], sweeps, tcfg.TaskType.LOGISTIC_REGRESSION,
        d.responses, d.weights, d.offsets,
        initial_states=convert.states_from_numpy(states, device="cpu"),
        device="cpu")


def _assert_states_close(got, want):
    for cid in ("fixed", "per-user"):
        np.testing.assert_allclose(got[cid], want[cid], rtol=1e-3,
                                   atol=5e-3)


def _port_states(res):
    m = res.model.models
    return convert.states_to_numpy({
        "fixed": m["fixed"].model.coefficients.means,
        "per-user": m["per-user"].coefficients_projected})


def test_coordinate_descent_two_sweeps_matches_jax(sides, jax_runs):
    # the counts below are this run's: a blocked sweep earlier in the
    # process leaves fewer epilogue fetches than updates behind
    tcd.reset_hot_loop_stats()
    res = _port_cd(sides, 2, jax_runs["zeros"])
    want = [s.objective for s in jax_runs["two"].states]
    got = [s.objective for s in res.states]
    assert [s.coordinate_id for s in res.states] == \
        [s.coordinate_id for s in jax_runs["two"].states]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    _assert_states_close(_port_states(res), _jax_states(jax_runs["two"]))
    # one blocking epilogue fetch per update
    assert tcd.HOT_LOOP_STATS["epilogue_fetches"] >= 4
    assert tcd.HOT_LOOP_STATS["epilogue_fetches"] == \
        tcd.HOT_LOOP_STATS["updates"]
    # a score is one per-user coefficient (one-hot movie feature) plus the
    # fixed-effect margin: the states' bound carries over
    scores = res.model.score(sides["tdata"], device="cpu").numpy()
    np.testing.assert_allclose(scores, jax_runs["two_scores"], rtol=1e-3,
                               atol=5e-3)


def test_two_sweeps_check_holds_after_a_blocked_sweep(sides, jax_runs):
    """The leaking sequence in one process: a blocked sweep (one epilogue
    read per block of two updates) runs first, then the two-sweep check,
    which reads ``HOT_LOOP_STATS``."""
    d = sides["tdata"]
    tcd.run_coordinate_descent(
        sides["tcoords"], 1, tcfg.TaskType.LOGISTIC_REGRESSION,
        d.responses, d.weights, d.offsets, block_size=2,
        initial_states=convert.states_from_numpy(jax_runs["zeros"],
                                                 device="cpu"),
        device="cpu")
    assert tcd.HOT_LOOP_STATS["epilogue_fetches"] < \
        tcd.HOT_LOOP_STATS["updates"]
    test_coordinate_descent_two_sweeps_matches_jax(sides, jax_runs)


def test_jax_trained_states_score_the_same_in_the_port(sides, jax_runs):
    states = _jax_states(jax_runs["two"])
    tmodel = tcd.publish_game_model(
        sides["tcoords"], convert.states_from_numpy(states, device="cpu"))
    np.testing.assert_allclose(
        tmodel.score(sides["tdata"], device="cpu").numpy(),
        jax_runs["two_scores"], rtol=1e-5, atol=1e-5)


def test_port_resumes_jax_sweep_one_into_sweep_two(sides, jax_runs):
    res = _port_cd(sides, 1, _jax_states(jax_runs["one"]))
    want = [s.objective for s in jax_runs["two"].states[2:]]
    np.testing.assert_allclose([s.objective for s in res.states], want,
                               rtol=1e-4)
    _assert_states_close(_port_states(res), _jax_states(jax_runs["two"]))


def test_states_round_trip():
    states = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b": np.ones(4, np.float32)}
    back = convert.states_to_numpy(
        convert.states_from_numpy(states, device="cpu"))
    for k in states:
        np.testing.assert_array_equal(back[k], states[k])

"""PyTorch port vs the JAX package: the PRNG, the down-samplers and the
down-sampled fixed-effect update.

- ``utils/prng.py``: the key words and the f32 ``uniform`` bits equal
  ``jax.random.PRNGKey`` / ``jax.random.uniform`` (threefry2x32,
  partitionable, x64 off) for seeds {0, 1, 7, 2**31 - 1} and sizes {1, 7,
  1000, 65,537}.
- ``sampler/samplers.py``: both samplers' weights equal the JAX package's
  for the same key, batch and rate (f32, the JAX side inside
  ``jax.enable_x64(False)``); a rate of 1 or more returns the batch; a
  rate outside (0, 1) raises ``ValueError`` in both packages.
- ``FixedEffectCoordinate.update`` down-samples with key ``seed +
  update count``, and two updates equal the JAX coordinate's to rel 1e-10
  in f64. Under x64 ``jax.random.uniform`` draws f64 (other bits), so the
  JAX samplers' masks are run here with the f32 draw that production
  (x64 off) makes; the draw itself is the one the tests above hold equal.
- The update counts go into snapshots as the JAX package writes them, and
  a down-sampled run killed mid-sweep and resumed ends ``array_equal`` to
  its uninterrupted run.
- A random effect ignores its config's rate, as the JAX coordinate does.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data.batch import dense_batch as jdense_batch
from photon_ml_tpu.game import coordinate as jco
from photon_ml_tpu.game import coordinate_descent as jcd
from photon_ml_tpu.game import dataset as jds
from photon_ml_tpu.game import random_effect as jre
from photon_ml_tpu.optimize import config as jcfg
from photon_ml_tpu.optimize.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.sampler import samplers as jsamplers
from photon_ml_tpu.utils import checkpoint as jck
from photon_ml_tpu_torch.data.batch import dense_batch as tdense_batch
from photon_ml_tpu_torch.game import coordinate as tco
from photon_ml_tpu_torch.game import coordinate_descent as tcd
from photon_ml_tpu_torch.game import dataset as tds
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.optimize import config as tcfg
from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem as TProblem
from photon_ml_tpu_torch.sampler import samplers as tsamplers
from photon_ml_tpu_torch.utils import checkpoint as tck
from photon_ml_tpu_torch.utils import faults as tfaults
from photon_ml_tpu_torch.utils import prng

torch.set_num_threads(1)
N, USERS, MOVIES, D_GLOBAL = 1500, 20, 30, 8
RE_CONFIG = dict(random_effect_type="userId", feature_shard_id="per_user",
                 num_active_data_points_upper_bound=64,
                 num_features_to_keep_upper_bound=24)
SEEDS = [0, 1, 7, 2**31 - 1]
SIZES = [1, 7, 1000, 65_537]
SAMPLERS = ["default_down_sample", "binary_classification_down_sample"]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bits_equal_jax(seed, n):
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.uniform(key, (n,)))
        words = np.asarray(key)
    np.testing.assert_array_equal(prng.PRNGKey(seed), words)
    got = prng.uniform(prng.PRNGKey(seed), (n,))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def _batches(n=2000, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.4).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return (jdense_batch(jnp.asarray(X), jnp.asarray(y), weights=jnp.asarray(w)),
            tdense_batch(X, y, weights=w, device="cpu"))


@pytest.mark.parametrize("rate", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_sampler_weights_equal_jax(sampler, rate):
    with jax.enable_x64(False):
        jb, tb = _batches()
        want = np.asarray(getattr(jsamplers, sampler)(
            jb, rate, jax.random.PRNGKey(11)).weights)
    got = getattr(tsamplers, sampler)(tb, rate, prng.PRNGKey(11)).weights
    np.testing.assert_array_equal(got.numpy(), want)
    kept = got.numpy() > 0
    assert 0 < kept.sum() < len(kept)
    if sampler == "binary_classification_down_sample":
        pos = tb.labels.numpy() > 0.5
        np.testing.assert_array_equal(got.numpy()[pos],
                                      tb.weights.numpy()[pos])


@pytest.mark.parametrize("rate", [0.0, 1.0, -0.5, 1.5])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_rate_outside_the_open_interval_raises(sampler, rate):
    jb, tb = _batches(n=10)
    with pytest.raises(ValueError, match="down-sampling rate"):
        getattr(jsamplers, sampler)(jb, rate, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="down-sampling rate"):
        getattr(tsamplers, sampler)(tb, rate, prng.PRNGKey(0))


@pytest.mark.parametrize("rate", [1.0, 1.5])
def test_rate_of_one_or_more_is_a_no_op(rate):
    _, tb = _batches(n=10)
    for classification in (False, True):
        assert tsamplers.down_sample(tb, rate, prng.PRNGKey(0),
                                     classification) is tb


def _game_dataset(mod, seed=11):
    rng = np.random.default_rng(seed)
    users = (rng.zipf(1.3, size=N) % USERS).astype(np.int64)
    movies = rng.integers(0, MOVIES, N)
    Xg = (rng.normal(size=(N, D_GLOBAL)) / np.sqrt(D_GLOBAL)).astype(
        np.float32)
    wg = rng.normal(size=D_GLOBAL).astype(np.float32)
    logits = Xg @ wg + 0.5 * rng.normal(size=USERS)[users].astype(np.float32)
    y = (rng.uniform(size=N) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    data = mod.GameDataset(responses=y, feature_shards={
        "global": sp.csr_matrix(Xg),
        "per_user": sp.csr_matrix((np.ones(N, np.float32),
                                   (np.arange(N), movies)),
                                  shape=(N, MOVIES))})
    data.encode_ids("userId", users)
    return data


@pytest.fixture(scope="module")
def data():
    return {"jdata": _game_dataset(jds), "tdata": _game_dataset(tds)}


def _cfg(mod, task, rate):
    opt = "LBFGS" if task == "LOGISTIC_REGRESSION" else "TRON"
    return mod.GLMOptimizationConfiguration.parse(
        f"40,1e-9,10,{rate},{opt},L2")


@pytest.fixture
def jax_f32_draws(monkeypatch):
    """The JAX samplers' masks with the f32 draw of production (x64 off)
    while the rest of the JAX side runs in f64 (jitted with a static rate,
    as the package's masks are)."""
    @partial(jax.jit, static_argnames=("rate",))
    def uniform_mask(key, weights, rate):
        keep = jax.random.uniform(key, weights.shape, jnp.float32) < rate
        return jnp.where(keep, weights / rate, 0.0)

    @partial(jax.jit, static_argnames=("rate",))
    def negative_mask(key, weights, labels, rate):
        keep = jax.random.uniform(key, weights.shape, jnp.float32) < rate
        return jnp.where(labels > 0.5, weights,
                         jnp.where(keep, weights / rate, 0.0))

    monkeypatch.setattr(jsamplers, "_uniform_mask", uniform_mask)
    monkeypatch.setattr(jsamplers, "_negative_mask", negative_mask)


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION"])
def test_down_sampled_fixed_effect_update_matches_jax(data, jax_f32_draws,
                                                      task):
    """f64 on both sides; two updates (keys seed + 0 and seed + 1) from
    different offsets, with the binary sampler for logistic regression
    and the uniform one for linear regression."""
    jfe = jds.build_fixed_effect_dataset(data["jdata"], "global",
                                         dtype=jnp.float64)
    tfe = tds.build_fixed_effect_dataset(data["tdata"], "global",
                                         dtype=torch.float64, device="cpu")
    jc = jco.FixedEffectCoordinate(
        dataset=jfe, seed=5, problem=JProblem(
            config=_cfg(jcfg, task, 0.6), task=jcfg.TaskType[task]))
    tc = tco.FixedEffectCoordinate(
        dataset=tfe, seed=5, problem=TProblem(
            config=_cfg(tcfg, task, 0.6), task=tcfg.TaskType[task]))
    jx = tx = None
    rng = np.random.default_rng(1)
    for _ in range(2):
        extra = rng.normal(size=N) * 0.2
        jx, jtr = jc.update(jx, jnp.asarray(extra))
        tx, ttr = tc.update(tx, torch.tensor(extra))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-10,
                                   atol=1e-13)
        assert ttr.result.iterations == jtr.result.iterations
    assert tc._update_count == jc._update_count == 2
    # the count advances with a rate of 1 too, where nothing is sampled
    plain = tco.FixedEffectCoordinate(dataset=tfe, problem=TProblem(
        config=_cfg(tcfg, task, 1.0), task=tcfg.TaskType[task]))
    plain.update(None, torch.zeros(N, dtype=torch.float64))
    assert plain._update_count == 1


def test_random_effect_ignores_the_rate(data):
    ds = tds.build_random_effect_dataset(
        data["tdata"], tds.RandomEffectDataConfiguration(**RE_CONFIG),
        num_buckets=2, device="cpu")
    extra = torch.tensor(np.random.default_rng(2).normal(size=N) * 0.2,
                         dtype=torch.float32)
    out = []
    for rate in (1.0, 0.5):
        coord = tco.RandomEffectCoordinate(
            dataset=ds, problem=tre.RandomEffectOptimizationProblem(
                config=_cfg(tcfg, "LOGISTIC_REGRESSION", rate),
                task=tcfg.TaskType.LOGISTIC_REGRESSION))
        out.append(coord.update(None, extra)[0])
    assert torch.equal(out[0], out[1])


def _sampled_coords(side, data, rate=0.5):
    mod, co, prob, re_, ds_, dd = (
        (tcfg, tco, TProblem, tre, tds, data["tdata"]) if side == "torch"
        else (jcfg, jco, JProblem, jre, jds, data["jdata"]))
    kw = {"device": "cpu"} if side == "torch" else {}
    task = mod.TaskType.LOGISTIC_REGRESSION
    return {
        "fixed": co.FixedEffectCoordinate(
            dataset=ds_.build_fixed_effect_dataset(dd, "global", **kw),
            problem=prob(config=_cfg(mod, "LOGISTIC_REGRESSION", rate),
                         task=task)),
        "per-user": co.RandomEffectCoordinate(
            dataset=ds_.build_random_effect_dataset(
                dd, ds_.RandomEffectDataConfiguration(**RE_CONFIG),
                num_buckets=2, **kw),
            problem=re_.RandomEffectOptimizationProblem(
                config=_cfg(mod, "LOGISTIC_REGRESSION", 1.0), task=task))}


def _port(data, **kw):
    d = data["tdata"]
    return tcd.run_coordinate_descent(
        _sampled_coords("torch", data), 2,
        tcfg.TaskType.LOGISTIC_REGRESSION, d.responses, d.weights,
        d.offsets, device="cpu", **kw)


def test_update_counts_in_snapshots_and_resume_is_bit_exact(data, tmp_path):
    ref = _port(data)
    mgr = tck.CheckpointManager(str(tmp_path / "port"))
    tfaults.arm("cd.update", "raise", tag="1.1")
    try:
        with pytest.raises(tfaults.InjectedFault):
            _port(data, checkpoint_manager=mgr,
                  checkpoint_every_coordinates=1)
    finally:
        tfaults.disarm_all()
    port_counts = {s: mgr.restore(step=s)["update_counts"]
                   for s in mgr.all_steps()}
    # the JAX package's snapshots of the same run carry the same counts
    jmgr = jck.CheckpointManager(str(tmp_path / "jax"))
    d = data["jdata"]
    coords = _sampled_coords("jax", data)
    with jax.enable_x64(False):
        jcd.run_coordinate_descent(
            coords, 1, jcfg.TaskType.LOGISTIC_REGRESSION,
            jnp.asarray(d.responses, jnp.float32),
            jnp.asarray(d.weights, jnp.float32),
            jnp.asarray(d.offsets, jnp.float32),
            initial_states={
                "fixed": jnp.zeros(D_GLOBAL, jnp.float32),
                "per-user": jnp.zeros(
                    (coords["per-user"].dataset.num_entities,
                     coords["per-user"].dataset.reduced_dim), jnp.float32)},
            checkpoint_manager=jmgr, checkpoint_every_coordinates=1)
    jax_counts = {s: jmgr.restore(step=s)["update_counts"]
                  for s in jmgr.all_steps()}
    assert jax_counts == {1: {"fixed": 1}, 2: {"fixed": 1}}
    assert port_counts == {1: {"fixed": 1}, 2: {"fixed": 1},
                           3: {"fixed": 2}}
    snap = mgr.restore()
    res = _port(data, resume_snapshot=snap)
    assert [(s.iteration, s.coordinate_id) for s in res.states] == \
        [(1, "per-user")]
    assert res.states[0].objective == ref.states[-1].objective
    for cid, m in res.model.models.items():
        got = getattr(m, "coefficients_projected", None)
        want = getattr(ref.model.models[cid], "coefficients_projected",
                       None)
        if got is None:
            got = m.model.coefficients.means
            want = ref.model.models[cid].model.coefficients.means
        assert torch.equal(got, want), cid


def test_sampled_run_differs_from_the_full_batch(data):
    """The sample is real: the down-sampled fixed effect ends elsewhere
    than the full-batch one, and its objective stays finite."""
    full = tcd.run_coordinate_descent(
        _sampled_coords("torch", data, rate=1.0), 1,
        tcfg.TaskType.LOGISTIC_REGRESSION, data["tdata"].responses,
        data["tdata"].weights, data["tdata"].offsets, device="cpu")
    sampled = _port(data)
    f = full.model.models["fixed"].model.coefficients.means
    s = sampled.model.models["fixed"].model.coefficients.means
    assert not torch.equal(f, s)
    assert np.all(np.isfinite([st.objective for st in sampled.states]))


def test_seed_field_defaults_to_zero():
    fields = {f.name: f.default
              for f in dataclasses.fields(tco.FixedEffectCoordinate)}
    jfields = {f.name: f.default
               for f in dataclasses.fields(jco.FixedEffectCoordinate)}
    assert fields["seed"] == jfields["seed"] == 0

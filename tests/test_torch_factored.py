"""PyTorch port vs the JAX package: the factored random-effect coordinate.

A small GAME fixture (1,500 rows, 25 power-law users, 6 dense global
features, 8 half-sparse per-user features; per-user active cap 40, so
some users have passive rows) built IDENTITY-projected, single block, in
both packages from the same numpy data. Latent dimension 3, two inner
iterations, L-BFGS + L2 everywhere.

- ``utils/prng.normal`` equals ``jax.random.normal`` bit for bit, under
  x64 too, and so does the coordinate's B₀.
- One update from the same B₀ in f64 blocks, the solvers run to
  tolerance 1e-12 so that both sides stop at the optimum: the JAX package
  computes its latent block ``X·Bᵀ`` and Kronecker rows in f32 even from
  f64 inputs (``einsum`` with ``preferred_element_type=float32``), the
  port in f64, so the latent coefficients and B agree to atol 1e-4
  (measured 3.6e-5) and each refit's final value to rel 1e-6 (measured
  5e-7), not to the f64 solver's 1e-8.
- Fixed + factored coordinate descent in f32 (the JAX side inside
  ``jax.enable_x64(False)``): objectives agree to rel 1e-4 per update
  (measured 2.2e-5), and a sweep resumed in the other package from a
  snapshot to rel 5e-4 (measured 2.2e-4), not the 1e-5 of the fixed
  effect: each alternation solves the latent per-entity problems and then
  refits B on their coefficients, both to tolerance 1e-7 in f32, and the
  per-entity solves stop one iteration apart in some entities
  (FunctionValuesConverged), end points sqrt(eps) apart
  (``tests/test_torch_game.py``) that the bilinear objective carries into
  the refit and the next alternation.
- In the port: the pipelined sweep, the pipelined sweep of blocks of one
  and lane compaction (chunk 4 and ``auto``) are bit-equal to the
  sequential, single-dispatch run; a blocked run resumed from its snapshot
  equals the uninterrupted blocked run; a run killed at update (1, 1) and
  resumed equals the uninterrupted one; a poisoned factored update is
  damped leaf by leaf and recovers; uncapped, every update lowers the
  objective, while under the active cap a factored update raises it.
- Snapshots holding the tuple state carry the JAX ``"tuple"`` node and
  each package finishes the other's.
- Both packages refuse a projected or bucketed dataset with the same
  ``ValueError``; the published model's raw coefficients and scores
  agree.
"""

import dataclasses
import json
import os

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
from photon_ml_tpu.projector import projectors as jproj
from photon_ml_tpu.utils import checkpoint as jck
from photon_ml_tpu.utils import faults as jfaults
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.game import coordinate as tco
from photon_ml_tpu_torch.game import coordinate_descent as tcd
from photon_ml_tpu_torch.game import dataset as tds
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.optimize import config as tcfg
from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem as TProblem
from photon_ml_tpu_torch.projector import projectors as tproj
from photon_ml_tpu_torch.utils import checkpoint as tck
from photon_ml_tpu_torch.utils import faults as tfaults
from photon_ml_tpu_torch.utils.prng import PRNGKey, normal_numpy

torch.set_num_threads(1)
N, USERS, D_GLOBAL, D_USER, K = 1500, 25, 6, 8, 3
JTASK = jcfg.TaskType.LOGISTIC_REGRESSION
TTASK = tcfg.TaskType.LOGISTIC_REGRESSION


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    monkeypatch.delenv("PHOTON_FAULTS", raising=False)
    tfaults.disarm_all()
    jfaults.disarm_all()
    yield
    tfaults.disarm_all()
    jfaults.disarm_all()


def _game_dataset(mod, seed=3):
    rng = np.random.default_rng(seed)
    users = (rng.zipf(1.3, size=N) % USERS).astype(np.int64)
    Xg = (rng.normal(size=(N, D_GLOBAL)) / np.sqrt(D_GLOBAL)).astype(
        np.float32)
    Xu = (rng.normal(size=(N, D_USER))
          * (rng.uniform(size=(N, D_USER)) < 0.5)).astype(np.float32)
    W = rng.normal(size=(USERS, D_USER)).astype(np.float32)
    logits = Xg @ rng.normal(size=D_GLOBAL) + 0.5 * np.sum(Xu * W[users], 1)
    y = (rng.uniform(size=N) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    data = mod.GameDataset(responses=y, feature_shards={
        "global": sp.csr_matrix(Xg), "user": sp.csr_matrix(Xu)})
    data.encode_ids("userId", users)
    return data


def _re_config(mod, proj, kind="IDENTITY"):
    return mod.RandomEffectDataConfiguration(
        "userId", "user", num_active_data_points_upper_bound=40,
        projector=proj.ProjectorConfig(proj.ProjectorType[kind]))


def _l2(cfg, lam, iters):
    return cfg.GLMOptimizationConfiguration(
        max_iterations=iters, tolerance=1e-7, regularization_weight=lam,
        optimizer_type=cfg.OptimizerType.LBFGS,
        regularization_context=cfg.RegularizationContext(
            cfg.RegularizationType.L2))


@pytest.fixture(scope="module")
def data():
    jdata, tdata = _game_dataset(jds), _game_dataset(tds)
    return dict(
        jdata=jdata, tdata=tdata,
        jfe=jds.build_fixed_effect_dataset(jdata, "global"),
        tfe=tds.build_fixed_effect_dataset(tdata, "global", device="cpu"),
        jre=jds.build_random_effect_dataset(jdata, _re_config(jds, jproj)),
        tre=tds.build_random_effect_dataset(tdata, _re_config(tds, tproj),
                                            device="cpu"))


def _jfactored(ds, **kw):
    return jco.FactoredRandomEffectCoordinate(
        dataset=ds, problem=jre.RandomEffectOptimizationProblem(
            config=_l2(jcfg, 1.0, 20), task=JTASK),
        latent_problem=JProblem(config=_l2(jcfg, 1.0, 20), task=JTASK),
        latent_dim=K, **kw)


def _tfactored(ds, chunk=0, **kw):
    return tco.FactoredRandomEffectCoordinate(
        dataset=ds, problem=tre.RandomEffectOptimizationProblem(
            config=_l2(tcfg, 1.0, 20), task=TTASK,
            lane_compaction_chunk=chunk),
        latent_problem=TProblem(config=_l2(tcfg, 1.0, 20), task=TTASK),
        latent_dim=K, **kw)


def _tcoords(data, chunk=0):
    return {"fixed": tco.FixedEffectCoordinate(
                dataset=data["tfe"],
                problem=TProblem(config=_l2(tcfg, 10.0, 30), task=TTASK)),
            "fac": _tfactored(data["tre"], chunk=chunk)}


def _jcoords(data):
    return {"fixed": jco.FixedEffectCoordinate(
                dataset=data["jfe"],
                problem=JProblem(config=_l2(jcfg, 10.0, 30), task=JTASK)),
            "fac": _jfactored(data["jre"])}


def _port(data, sweeps, chunk=0, **kw):
    d = data["tdata"]
    return tcd.run_coordinate_descent(
        _tcoords(data, chunk), sweeps, TTASK, d.responses, d.weights,
        d.offsets, device="cpu", **kw)


def _jax(data, sweeps, **kw):
    d = data["jdata"]
    with jax.enable_x64(False):
        return jcd.run_coordinate_descent(
            _jcoords(data), sweeps, JTASK,
            jnp.asarray(d.responses, jnp.float32),
            jnp.asarray(d.weights, jnp.float32),
            jnp.asarray(d.offsets, jnp.float32), pipeline_depth=0, **kw)


def _final(res) -> dict:
    m = res.model.models
    out = {"fixed": m["fixed"].model.coefficients.means,
           "coefs": m["fac"].coefficients_latent,
           "B": m["fac"].projection}
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


def _assert_bit_equal(a, b):
    assert [s.objective for s in a.states] == [s.objective for s in b.states]
    fa, fb = _final(a), _final(b)
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k


@pytest.fixture(scope="module")
def sequential(data):
    return _port(data, 2, pipeline_depth=0)


@pytest.fixture(scope="module")
def jax_run(data):
    return _jax(data, 2)


@pytest.mark.parametrize("seed,shape", [(0, (3, 8)), (7, (8, 65)),
                                        (12345, (2, 4097)), (2**31 - 1, (1,))])
def test_normal_matches_jax_bit_for_bit(seed, shape):
    got = normal_numpy(PRNGKey(seed), shape)
    with jax.enable_x64(False):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                            jnp.float32))
    with jax.enable_x64(True):
        want64 = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                              shape, jnp.float32))
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(got.view(np.uint32), want64.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 5])
def test_initial_state_matches_jax(data, seed):
    jc, jb = _jfactored(data["jre"], seed=seed).initial_state()
    tc, tb = _tfactored(data["tre"], seed=seed).initial_state()
    assert tb.dtype == torch.float32 and tb.shape == (K, D_USER)
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(tc.numpy(), np.asarray(jc))


def test_one_update_f64_matches_jax(data):
    jds64 = jds.build_random_effect_dataset(
        data["jdata"], _re_config(jds, jproj), dtype=jnp.float64)
    tds64 = tds.build_random_effect_dataset(
        data["tdata"], _re_config(tds, tproj), dtype=torch.float64,
        device="cpu")
    assert np.array_equal(np.asarray(jds64.X), tds64.X.numpy())
    extra = np.random.default_rng(1).normal(size=N) * 0.3
    tight = dict(tolerance=1e-12, max_iterations=300)
    jcoord = _jfactored(jds64)
    jcoord.problem = dataclasses.replace(
        jcoord.problem, config=dataclasses.replace(jcoord.problem.config,
                                                   **tight))
    jcoord.latent_problem = dataclasses.replace(
        jcoord.latent_problem, config=dataclasses.replace(
            jcoord.latent_problem.config, **tight))
    tcoord = _tfactored(tds64)
    tcoord.problem = dataclasses.replace(
        tcoord.problem, config=dataclasses.replace(tcoord.problem.config,
                                                   **tight))
    tcoord.latent_problem = dataclasses.replace(
        tcoord.latent_problem, config=dataclasses.replace(
            tcoord.latent_problem.config, **tight))
    (jc, jb), jtr = jcoord.update(None, jnp.asarray(extra))
    (tc, tb), ttr = tcoord.update(None, torch.from_numpy(extra))
    assert tc.dtype == tb.dtype == torch.float64
    assert len(ttr.inner) == len(jtr.inner) == 2
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                               atol=1e-4)
    for (_, jfe_t), (_, tfe_t) in zip(jtr.inner, ttr.inner):
        np.testing.assert_allclose(tfe_t.materialize().result.value,
                                   jfe_t.materialize().result.value,
                                   rtol=1e-6)


def test_coordinate_descent_matches_jax(data, sequential, jax_run):
    assert [(s.iteration, s.coordinate_id) for s in sequential.states] == \
        [(s.iteration, s.coordinate_id) for s in jax_run.states]
    got = [s.objective for s in sequential.states]
    want = [s.objective for s in jax_run.states]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    tscores = sequential.model.score(data["tdata"], device="cpu").numpy()
    jscores = np.asarray(jax_run.model.score(data["jdata"]))
    np.testing.assert_allclose(tscores, jscores, rtol=1e-2, atol=2e-2)


def test_published_model_matches_jax(data):
    rng = np.random.default_rng(9)
    coefs = rng.normal(size=(data["tre"].num_entities, K)).astype(np.float32)
    B = rng.normal(size=(K, D_USER)).astype(np.float32)
    jm = _jfactored(data["jre"]).publish((jnp.asarray(coefs),
                                          jnp.asarray(B)))
    tm = _tfactored(data["tre"]).publish(
        convert.states_from_numpy({"s": (coefs, B)}, device="cpu")["s"])
    assert np.array_equal(tm.to_raw().coefficients.numpy(),
                          np.asarray(jm.to_raw().coefficients))
    np.testing.assert_allclose(
        tm.score(data["tdata"], device="cpu").numpy(),
        np.asarray(jm.score(data["jdata"])), rtol=1e-6, atol=1e-6)
    state = (torch.from_numpy(coefs), torch.from_numpy(B))
    # the coordinate's own score: active and passive rows through X·Bᵀ
    np.testing.assert_allclose(
        _tfactored(data["tre"]).score(state).numpy(),
        np.asarray(_jfactored(data["jre"]).score(
            (jnp.asarray(coefs), jnp.asarray(B)))), rtol=1e-5, atol=1e-5)


def test_pipelined_is_sequential_bit_for_bit(data, sequential):
    _assert_bit_equal(_port(data, 2, pipeline_depth=1), sequential)
    _assert_bit_equal(_port(data, 2, pipeline_depth=1, block_size=1),
                      sequential)


@pytest.mark.parametrize("chunk", [4, tre.AUTO_COMPACTION_CHUNK])
def test_compacted_is_single_dispatch_bit_for_bit(data, sequential, chunk):
    tre.reset_solve_stats()
    res = _port(data, 2, chunk=chunk, pipeline_depth=0)
    assert tre.SOLVE_STATS["chunks"] > tre.SOLVE_STATS["dispatches"] / 2
    _assert_bit_equal(res, sequential)


def test_blocked_resume_is_bit_exact(data, tmp_path):
    blocked = _port(data, 2, block_size=2)
    assert [s.objective for s in blocked.states] != []
    mgr = tck.CheckpointManager(str(tmp_path), max_to_keep=None)
    tfaults.arm("cd.update", "raise", tag="1.1")
    with pytest.raises(tfaults.InjectedFault):
        _port(data, 2, block_size=2, checkpoint_manager=mgr,
              checkpoint_every_coordinates=1)
    snap = mgr.restore()
    assert (snap["sweep"], snap["coordinate_index"]) == (1, 0)
    assert isinstance(snap["states"]["fac"], tuple)
    res = _port(data, 2, block_size=2, resume_snapshot=snap)
    fa, fb = _final(res), _final(blocked)
    assert [s.objective for s in res.states] == \
        [s.objective for s in blocked.states[2:]]
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k


def test_mid_sweep_resume_is_bit_exact(data, sequential, tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path))
    tfaults.arm("cd.update", "raise", tag="1.1")
    with pytest.raises(tfaults.InjectedFault):
        _port(data, 2, checkpoint_manager=mgr,
              checkpoint_every_coordinates=1)
    snap = mgr.restore()
    assert (snap["sweep"], snap["coordinate_index"]) == (1, 1)
    coefs, B = snap["states"]["fac"]
    assert coefs.shape == (data["tre"].num_entities, K) and \
        B.shape == (K, D_USER)
    res = _port(data, 2, resume_snapshot=snap)
    assert res.states[0].objective == sequential.states[-1].objective
    for k, v in _final(res).items():
        assert np.array_equal(v, _final(sequential)[k]), k


def test_snapshot_holds_the_jax_tuple_node(data, tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path))
    _port(data, 1, checkpoint_manager=mgr)
    (step,) = mgr.all_steps()
    with open(os.path.join(tmp_path, f"step_{step:08d}",
                           "manifest.json")) as fh:
        text = json.dumps(json.load(fh))
    assert '"__kind__": "tuple"' in text
    jsnap = jck.CheckpointManager(str(tmp_path)).restore()
    tsnap = mgr.restore()
    for snap in (jsnap, tsnap):
        assert isinstance(snap["states"]["fac"], tuple)
        assert [a.dtype for a in snap["states"]["fac"]] == [np.float32] * 2
    for a, b in zip(jsnap["states"]["fac"], tsnap["states"]["fac"]):
        assert np.array_equal(a, b)


def test_port_finishes_a_jax_snapshot(data, jax_run, tmp_path):
    jmgr = jck.CheckpointManager(str(tmp_path))
    jfaults.arm("cd.update", "raise", tag="1.1")
    with pytest.raises(jfaults.InjectedFault):
        _jax(data, 2, checkpoint_manager=jmgr,
             checkpoint_every_coordinates=1)
    snap = tck.CheckpointManager(str(tmp_path)).restore()
    assert isinstance(snap["states"]["fac"], tuple)
    res = _port(data, 2, resume_snapshot=snap)
    np.testing.assert_allclose(res.states[0].objective,
                               jax_run.states[-1].objective, rtol=5e-4)


def test_jax_finishes_a_port_snapshot(data, sequential, tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path))
    tfaults.arm("cd.update", "raise", tag="1.1")
    with pytest.raises(tfaults.InjectedFault):
        _port(data, 2, checkpoint_manager=mgr,
              checkpoint_every_coordinates=1)
    snap = jck.CheckpointManager(str(tmp_path)).restore()
    assert isinstance(snap["states"]["fac"], tuple)
    res = _jax(data, 2, resume_snapshot=snap)
    np.testing.assert_allclose(res.states[0].objective,
                               sequential.states[-1].objective, rtol=5e-4)


def test_poisoned_update_is_damped_leaf_by_leaf(data):
    tfaults.arm("cd.update", "nan", tag="0.1", times=1)
    res = _port(data, 1, recovery=tcd.RecoveryPolicy(max_retries=2))
    assert [s.coordinate_id for s in res.states] == ["fixed", "fac"]
    assert all(np.isfinite(v).all() for v in _final(res).values())
    good = (torch.zeros(2), torch.ones(3))
    cand = (torch.full((2,), 4.0), torch.full((3,), 3.0))
    damped = tcd._damp_toward(good, cand, 0.25)
    assert isinstance(damped, tuple)
    assert torch.equal(damped[0], torch.ones(2))
    assert torch.equal(damped[1], torch.full((3,), 1.5))


@pytest.mark.parametrize("case", ["index_map", "random", "bucketed"])
def test_refuses_what_the_jax_package_refuses(data, case):
    if case == "bucketed":
        jd = jds.build_random_effect_dataset(
            data["jdata"], _re_config(jds, jproj), num_buckets=3)
        td = tds.build_random_effect_dataset(
            data["tdata"], _re_config(tds, tproj), num_buckets=3,
            device="cpu")
        match = "single-block"
    else:
        kind = "INDEX_MAP" if case == "index_map" else "RANDOM"
        jcfg_ = _re_config(jds, jproj, kind)
        tcfg_ = _re_config(tds, tproj, kind)
        if kind == "RANDOM":
            jcfg_ = jds.RandomEffectDataConfiguration(
                "userId", "user", projector=jproj.ProjectorConfig.parse(
                    "random=4"))
            tcfg_ = tds.RandomEffectDataConfiguration(
                "userId", "user", projector=tproj.ProjectorConfig.parse(
                    "random=4"))
        jd = jds.build_random_effect_dataset(data["jdata"], jcfg_)
        td = tds.build_random_effect_dataset(data["tdata"], tcfg_,
                                             device="cpu")
        match = "identity-projected"
    with pytest.raises(ValueError, match=match) as je:
        _jfactored(jd)
    with pytest.raises(ValueError, match=match) as te:
        _tfactored(td)
    assert str(je.value) == str(te.value)


@pytest.mark.parametrize("cap", [40, None])
def test_the_active_cap_makes_factored_updates_non_monotone(data, cap):
    """Uncapped, every update of three sweeps lowers the objective; with
    the cap (passive rows, and active rows weighted count/cap) a factored
    update raises it, as in the JAX package
    (``test_coordinate_descent_matches_jax`` holds the two sequences to
    rel 1e-4)."""
    d = data["tdata"]
    cfg = tds.RandomEffectDataConfiguration(
        "userId", "user", num_active_data_points_upper_bound=cap,
        projector=tproj.ProjectorConfig(tproj.ProjectorType.IDENTITY))
    coords = _tcoords(data)
    coords["fac"] = _tfactored(tds.build_random_effect_dataset(
        d, cfg, device="cpu"))
    res = tcd.run_coordinate_descent(coords, 3, TTASK, d.responses,
                                     d.weights, d.offsets, device="cpu")
    objs = np.array([s.objective for s in res.states])
    rises = np.diff(objs) > 0
    if cap is None:
        assert coords["fac"].dataset.num_passive == 0
        assert not rises.any(), objs
    else:
        assert coords["fac"].dataset.num_passive > 0
        assert rises[2::2].any(), objs  # a factored update's rise


def test_tuple_states_round_trip():
    states = {"fac": (np.arange(6, dtype=np.float32).reshape(3, 2),
                      np.ones((2, 4), np.float32)),
              "fixed": np.zeros(3, np.float32)}
    back = convert.states_to_numpy(
        convert.states_from_numpy(states, device="cpu"))
    assert isinstance(back["fac"], tuple)
    for a, b in zip(back["fac"], states["fac"]):
        assert np.array_equal(a, b)
    assert np.array_equal(back["fixed"], states["fixed"])
    host = tcd.fetch_to_host({"states": convert.states_from_numpy(
        states, device="cpu"), "best": None})
    assert host["best"] is None and isinstance(host["states"]["fac"], tuple)
    for a, b in zip(host["states"]["fac"], states["fac"]):
        assert np.array_equal(a, b)

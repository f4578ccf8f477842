"""PyTorch port vs the JAX package: resume, recovery and stop in
``run_coordinate_descent``.

A small GLMix (the MovieLens-shaped recipe of ``bench.py:581``: a fixed
effect over 8 dense columns plus a per-user random effect) runs through
both packages' sequential coordinate descent. The JAX side runs inside
``jax.enable_x64(False)`` (f32, like the port; ``tests/test_torch_game.py``
says why).

- The port's snapshot has exactly the JAX snapshot's keys, steps,
  shapes and dtypes for the same problem.
- The port killed mid-sweep (``cd.update@1.1=raise``) and resumed from
  its newest snapshot ends ``array_equal`` to its uninterrupted run, and
  so does a stop at a commit barrier.
- The port finishes a JAX-written mid-sweep snapshot (and the JAX package
  a port-written one) within the slice tolerance of
  ``tests/test_torch_game.py``: objectives rel 1e-4, states rtol 1e-3 /
  atol 5e-3.
- Under an ``optimizer.gradient`` NaN fault, ``RecoveryPolicy`` recover,
  skip, abort and quarantine make the JAX package's decisions: the same
  (iteration, coordinate) sequence, events, quarantined set and failure
  counters.
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
from photon_ml_tpu.utils import checkpoint as jck
from photon_ml_tpu.utils import events as jevents
from photon_ml_tpu.utils import faults as jfaults
from photon_ml_tpu.utils import preempt as jpreempt
from photon_ml_tpu_torch.game import coordinate as tco
from photon_ml_tpu_torch.game import coordinate_descent as tcd
from photon_ml_tpu_torch.game import dataset as tds
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.optimize import config as tcfg
from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem as TProblem
from photon_ml_tpu_torch.utils import checkpoint as tck
from photon_ml_tpu_torch.utils import events as tevents
from photon_ml_tpu_torch.utils import faults as tfaults
from photon_ml_tpu_torch.utils import preempt as tpreempt

torch.set_num_threads(1)
N, USERS, MOVIES, D_GLOBAL = 1500, 20, 30, 8
RE_CONFIG = dict(random_effect_type="userId", feature_shard_id="per_user",
                 num_active_data_points_upper_bound=64,
                 num_features_to_keep_upper_bound=24)
SNAPSHOT_KEYS = {"sweep", "coordinate_index", "iteration", "states",
                 "scores", "best_metric", "best_states", "update_counts",
                 "consecutive_failures", "coordinate_failures",
                 "quarantined"}


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    monkeypatch.delenv("PHOTON_FAULTS", raising=False)
    monkeypatch.delenv("PHOTON_FAULTS_STATE_DIR", raising=False)
    tfaults.disarm_all()
    jfaults.disarm_all()
    yield
    tfaults.disarm_all()
    jfaults.disarm_all()


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
        jre=jds.build_random_effect_dataset(
            jdata, jds.RandomEffectDataConfiguration(**RE_CONFIG),
            num_buckets=2),
        tre=tds.build_random_effect_dataset(
            tdata, tds.RandomEffectDataConfiguration(**RE_CONFIG),
            num_buckets=2, device="cpu"))


def _tcoords(data):
    """Fresh port coordinates (they carry update counts)."""
    task = tcfg.TaskType.LOGISTIC_REGRESSION
    return {"fixed": tco.FixedEffectCoordinate(
                dataset=data["tfe"],
                problem=TProblem(config=_l2(tcfg, 10.0, 40), task=task)),
            "per-user": tco.RandomEffectCoordinate(
                dataset=data["tre"],
                problem=tre.RandomEffectOptimizationProblem(
                    config=_l2(tcfg, 1.0, 20), task=task))}


def _jcoords(data):
    task = jcfg.TaskType.LOGISTIC_REGRESSION
    return {"fixed": jco.FixedEffectCoordinate(
                dataset=data["jfe"],
                problem=JProblem(config=_l2(jcfg, 10.0, 40), task=task)),
            "per-user": jco.RandomEffectCoordinate(
                dataset=data["jre"],
                problem=jre.RandomEffectOptimizationProblem(
                    config=_l2(jcfg, 1.0, 20), task=task))}


def _port(data, sweeps, **kw):
    d = data["tdata"]
    return tcd.run_coordinate_descent(
        _tcoords(data), sweeps, tcfg.TaskType.LOGISTIC_REGRESSION,
        d.responses, d.weights, d.offsets, device="cpu", **kw)


def _jax(data, sweeps, **kw):
    d = data["jdata"]
    with jax.enable_x64(False):
        return jcd.run_coordinate_descent(
            _jcoords(data), sweeps, jcfg.TaskType.LOGISTIC_REGRESSION,
            jnp.asarray(d.responses, jnp.float32),
            jnp.asarray(d.weights, jnp.float32),
            jnp.asarray(d.offsets, jnp.float32),
            initial_states={"fixed": jnp.zeros(D_GLOBAL, jnp.float32),
                            "per-user": jnp.zeros(
                                (data["jre"].num_entities,
                                 data["jre"].reduced_dim), jnp.float32)},
            pipeline_depth=0, **kw)


def _final_states(res):
    m = res.model.models
    out = {"fixed": m["fixed"].model.coefficients.means,
           "per-user": m["per-user"].coefficients_projected}
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


def _assert_states_close(got, want):
    for cid in ("fixed", "per-user"):
        np.testing.assert_allclose(got[cid], want[cid], rtol=1e-3,
                                   atol=5e-3)


@pytest.fixture(scope="module")
def uninterrupted(data):
    """The port's and the JAX package's two sweeps without checkpoints."""
    port = _port(data, 2)
    jres = _jax(data, 2)
    return dict(port=port, port_states=_final_states(port),
                jax=jres, jax_states=_final_states(jres))


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return (tree.shape, str(tree.dtype))
    return type(tree).__name__


def test_snapshot_keys_match_jax(data, tmp_path):
    tmgr = tck.CheckpointManager(str(tmp_path / "t"), max_to_keep=None)
    jmgr = jck.CheckpointManager(str(tmp_path / "j"), max_to_keep=None)
    tcd.reset_hot_loop_stats()
    tck.reset_checkpoint_stats()
    _port(data, 1, checkpoint_manager=tmgr, checkpoint_every_coordinates=1)
    _jax(data, 1, checkpoint_manager=jmgr, checkpoint_every_coordinates=1)
    assert tmgr.all_steps() == jmgr.all_steps() == [1, 2]
    for step in (1, 2):
        tsnap, jsnap = tmgr.restore(step), jmgr.restore(step)
        assert set(tsnap) == set(jsnap) == SNAPSHOT_KEYS
        assert _keys(tsnap) == _keys(jsnap)
        for k in ("sweep", "coordinate_index", "iteration",
                  "update_counts", "consecutive_failures",
                  "coordinate_failures", "quarantined", "best_states"):
            assert tsnap[k] == jsnap[k], k
        _assert_states_close(tsnap["states"], jsnap["states"])
    # the payload left the host... in one fetch per snapshot written
    assert tcd.HOT_LOOP_STATS["snapshot_fetches"] == 2 == \
        tck.CHECKPOINT_STATS["saves"]


def test_mid_sweep_resume_is_bit_exact(data, uninterrupted, tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path))
    tfaults.arm("cd.update", "raise", tag="1.1")
    with pytest.raises(tfaults.InjectedFault):
        _port(data, 2, checkpoint_manager=mgr,
              checkpoint_every_coordinates=1)
    snap = mgr.restore()
    assert (snap["sweep"], snap["coordinate_index"]) == (1, 1)
    res = _port(data, 2, checkpoint_manager=mgr,
                checkpoint_every_coordinates=1, resume_snapshot=snap)
    assert [(s.iteration, s.coordinate_id) for s in res.states] == \
        [(1, "per-user")]
    assert res.states[0].objective == uninterrupted["port"].states[-1] \
        .objective
    for cid, want in uninterrupted["port_states"].items():
        assert np.array_equal(_final_states(res)[cid], want), cid
    final = mgr.restore()
    assert (final["sweep"], final["coordinate_index"]) == (2, 0)
    assert final["update_counts"] == {"fixed": 2}


def test_f64_snapshot_leaves_are_cast_to_f32(data, uninterrupted, tmp_path):
    """A JAX snapshot taken under x64 holds f64 leaves: the port resumes it
    in f32 (exact here, since the values were f32 before)."""
    mgr = tck.CheckpointManager(str(tmp_path))
    tfaults.arm("cd.update", "raise", tag="1.0")
    with pytest.raises(tfaults.InjectedFault):
        _port(data, 2, checkpoint_manager=mgr,
              checkpoint_every_coordinates=1)
    snap = mgr.restore()
    for group in ("states", "scores"):
        snap[group] = {k: v.astype(np.float64)
                       for k, v in snap[group].items()}
    res = _port(data, 2, resume_snapshot=snap)
    for cid, want in uninterrupted["port_states"].items():
        got = _final_states(res)[cid]
        assert got.dtype == np.float32 and np.array_equal(got, want), cid


def test_stop_at_a_barrier_then_resume_is_bit_exact(data, uninterrupted,
                                                    tmp_path):
    class StopAt:
        def __init__(self, n):
            self.polls, self.n = 0, n

        def should_stop(self):
            self.polls += 1
            return "test:stop" if self.polls >= self.n else None

    mgr = tck.CheckpointManager(str(tmp_path))
    with pytest.raises(tpreempt.PreemptionRequested) as e:
        _port(data, 2, checkpoint_manager=mgr, stop=StopAt(3))
    with pytest.raises(jpreempt.PreemptionRequested) as je:
        _jax(data, 2, stop=StopAt(3))
    assert e.value.step == je.value.step == "1.0"
    snap = mgr.restore()
    assert (snap["sweep"], snap["coordinate_index"]) == (1, 0)
    res = _port(data, 2, resume_snapshot=snap)
    for cid, want in uninterrupted["port_states"].items():
        assert np.array_equal(_final_states(res)[cid], want), cid


def test_port_finishes_a_jax_snapshot(data, uninterrupted, tmp_path):
    jmgr = jck.CheckpointManager(str(tmp_path))
    jfaults.arm("cd.update", "raise", tag="1.1")
    with pytest.raises(jfaults.InjectedFault):
        _jax(data, 2, checkpoint_manager=jmgr,
             checkpoint_every_coordinates=1)
    snap = tck.CheckpointManager(str(tmp_path)).restore()
    assert (snap["sweep"], snap["coordinate_index"]) == (1, 1)
    res = _port(data, 2, resume_snapshot=snap)
    np.testing.assert_allclose(res.states[0].objective,
                               uninterrupted["jax"].states[-1].objective,
                               rtol=1e-4)
    _assert_states_close(_final_states(res), uninterrupted["jax_states"])


def test_jax_finishes_a_port_snapshot(data, uninterrupted, tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path))
    tfaults.arm("cd.update", "raise", tag="1.1")
    with pytest.raises(tfaults.InjectedFault):
        _port(data, 2, checkpoint_manager=mgr,
              checkpoint_every_coordinates=1)
    snap = jck.CheckpointManager(str(tmp_path)).restore()
    res = _jax(data, 2, resume_snapshot=snap)
    np.testing.assert_allclose(res.states[0].objective,
                               uninterrupted["port"].states[-1].objective,
                               rtol=1e-4)
    _assert_states_close(_final_states(res), uninterrupted["port_states"])


RECOVERY_CASES = {
    # one poisoned solve: retried with damping, recovered
    "recover": (dict(on_exhausted="skip"), 1),
    # every attempt of the first fixed-effect update poisoned
    "skip": (dict(on_exhausted="skip"), 3),
    "abort": (dict(on_exhausted="abort"), 3),
    "quarantine": (dict(on_exhausted="skip", quarantine_after=1), 3),
}


def _event_log(events):
    return [(type(e).__name__, getattr(e, "action", None),
             getattr(e, "coordinate_id", None), getattr(e, "iteration", None),
             getattr(e, "attempts", None), getattr(e, "point", None))
            for e in events]


def _recovery_run(side, data, tmp_path, policy, times):
    faults, cd, ck, ev = ((tfaults, tcd, tck, tevents) if side == "port"
                          else (jfaults, jcd, jck, jevents))
    run = _port if side == "port" else _jax
    faults.arm("optimizer.gradient", "nan", times=times)
    seen = []
    bus = ev.EventEmitter()
    bus.register_listener(seen.append)
    mgr = ck.CheckpointManager(str(tmp_path / side))
    try:
        res = run(data, 2, recovery=cd.RecoveryPolicy(max_retries=2,
                                                      **policy),
                  events=bus, checkpoint_manager=mgr,
                  checkpoint_every_coordinates=1)
    except RuntimeError as e:
        return dict(error=str(e).split(":")[0], events=_event_log(seen))
    snap = mgr.restore()
    return dict(
        sequence=[(s.iteration, s.coordinate_id) for s in res.states],
        objectives=[s.objective for s in res.states],
        quarantined=res.quarantined, events=_event_log(seen),
        counters={k: snap[k] for k in ("consecutive_failures",
                                       "coordinate_failures",
                                       "quarantined", "update_counts")},
        states=_final_states(res))


@pytest.mark.parametrize("case", list(RECOVERY_CASES))
def test_recovery_ladder_makes_the_jax_decisions(data, tmp_path, case):
    policy, times = RECOVERY_CASES[case]
    got = _recovery_run("port", data, tmp_path, policy, times)
    want = _recovery_run("jax", data, tmp_path, policy, times)
    assert got["events"] == want["events"] and got["events"]
    if case == "abort":
        assert got["error"] == want["error"] == \
            "coordinate descent aborted"
        return
    for k in ("sequence", "quarantined", "counters"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["objectives"], want["objectives"],
                               rtol=1e-4)
    _assert_states_close(got["states"], want["states"])
    if case == "quarantine":
        assert got["quarantined"] == ["fixed"]
        assert got["sequence"] == [(0, "per-user"), (1, "per-user")]


def test_divergence_without_recovery_propagates(data):
    tfaults.arm("cd.update", "nan", tag="0.0")
    res = _port(data, 1)
    assert np.isnan(res.states[0].objective)


def test_failed_save_is_contained(data, tmp_path):
    tfaults.arm("ckpt.write_bytes", "enospc", times=999)
    seen = []
    bus = tevents.EventEmitter()
    bus.register_listener(seen.append)
    before = tck.CHECKPOINT_STATS["save_failures"]
    res = _port(data, 1, checkpoint_manager=tck.CheckpointManager(
        str(tmp_path)), checkpoint_every_coordinates=1, events=bus)
    assert len(res.states) == 2
    # steps 1 and 2 on cadence, then step 2 again at the sweep's end: a
    # failed save is tried again at the next point
    assert tck.CHECKPOINT_STATS["save_failures"] - before == 3
    assert [e.point for e in seen] == ["ckpt.write_bytes"] * 3


def test_fetch_to_host_is_one_batch_of_f32():
    got = tcd.fetch_to_host({"states": {"a": torch.arange(6.0).reshape(2, 3),
                                        "b": torch.ones(0)},
                             "scores": {"a": torch.full((4,), 2.0)},
                             "best_states": None})
    assert got["best_states"] is None
    assert got["states"]["a"].shape == (2, 3)
    np.testing.assert_array_equal(got["states"]["a"],
                                  np.arange(6.0).reshape(2, 3))
    assert got["states"]["b"].shape == (0,)
    assert got["scores"]["a"].dtype == np.float32
    with pytest.raises(TypeError):
        tcd.fetch_to_host({"states": {"a": torch.ones(2, dtype=torch.int64)}})

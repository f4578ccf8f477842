"""The port's pipelined and block-parallel coordinate descent.

Port of the JAX package's parity suite ``tests/test_cd_pipeline.py``
(``:149-528``; its ``REGISTRY`` gauge, multi-host and live-bytes checks
have no counterpart in the port), on the same three-coordinate logistic
GAME data (fixed effect, per-user and per-item random effects, so a block
size of 2 cuts a sweep into blocks of 2 and 1):

- the pipelined sweep (``pipeline_depth=1``, the default) equals the
  sequential one bit for bit, and its hot-loop counters show the overlap;
- block sweeps stay within tolerance of the sequential optimum, take one
  epilogue read per block, and block size 1 is the sequential sweep;
- recovery one update late: a divergence found by a pipelined read rolls
  the speculative dispatch back (update counts included) and the run
  lands on the sequential recovery run float for float;
- snapshots land only at block boundaries, never hold a rolled-back
  update count, and a blocked run resumed from one is bit-exact;
- two ``run_lazy`` results stay independent when forced out of order.

And against the JAX package at f32 (its side inside
``jax.enable_x64(False)``): the pipelined run's objectives within rel
1e-5 of the JAX package's, and the blocked run's too, with as many
epilogue reads.
"""

import dataclasses

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
from photon_ml_tpu_torch.game import coordinate as tco
from photon_ml_tpu_torch.game import coordinate_descent as cd
from photon_ml_tpu_torch.game import dataset as tds
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.game.coordinate_descent import (
    RecoveryPolicy,
    run_coordinate_descent,
)
from photon_ml_tpu_torch.optimize import config as tcfg
from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem as TProblem
from photon_ml_tpu_torch.utils import faults
from photon_ml_tpu_torch.utils.checkpoint import CheckpointManager
from photon_ml_tpu_torch.utils.events import EventEmitter

torch.set_num_threads(1)
TASK = tcfg.TaskType.LOGISTIC_REGRESSION


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("PHOTON_FAULTS", raising=False)
    faults.disarm_all()
    yield
    faults.disarm_all()


def make_data(mod, rng, n=400, d_global=6, d_entity=3, n_users=10,
              n_items=7):
    """Fixed + per-user + per-item logistic GAME data on
    ``mod.GameDataset`` (``tests/test_cd_pipeline.py:76``)."""
    Xg = rng.normal(size=(n, d_global))
    Xu = rng.normal(size=(n, d_entity))
    Xi = rng.normal(size=(n, d_entity))
    users = rng.integers(0, n_users, size=n)
    items = rng.integers(0, n_items, size=n)
    w = rng.normal(size=d_global)
    Wu = rng.normal(size=(n_users, d_entity))
    Wi = rng.normal(size=(n_items, d_entity))
    margin = (Xg @ w + np.einsum("nd,nd->n", Xu, Wu[users])
              + np.einsum("nd,nd->n", Xi, Wi[items]))
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(
        np.float64)
    data = mod.GameDataset(
        responses=y,
        feature_shards={"global": sp.csr_matrix(Xg),
                        "per_user": sp.csr_matrix(Xu),
                        "per_item": sp.csr_matrix(Xi)})
    data.encode_ids("userId", users)
    data.encode_ids("itemId", items)
    return data


@pytest.fixture
def data(rng):
    return make_data(tds, rng)


def l2_config(mod=tcfg, lam=0.5, max_iter=25, rate=1.0):
    return mod.GLMOptimizationConfiguration(
        max_iterations=max_iter, tolerance=1e-8, regularization_weight=lam,
        optimizer_type=mod.OptimizerType.LBFGS, down_sampling_rate=rate,
        regularization_context=mod.RegularizationContext(
            mod.RegularizationType.L2))


def build_coords(data, rate=1.0):
    """Fresh coordinates (they hold update counts) over the same data."""
    def re(id_type, shard):
        return tco.RandomEffectCoordinate(
            dataset=tds.build_random_effect_dataset(
                data, tds.RandomEffectDataConfiguration(id_type, shard, 1),
                device="cpu"),
            problem=tre.RandomEffectOptimizationProblem(
                config=l2_config(), task=TASK))

    return {
        "fixed": tco.FixedEffectCoordinate(
            dataset=tds.build_fixed_effect_dataset(data, "global",
                                                   device="cpu"),
            problem=TProblem(config=l2_config(rate=rate), task=TASK)),
        "perUser": re("userId", "per_user"),
        "perItem": re("itemId", "per_item"),
    }


def run_cd(data, iters=2, coords=None, **kwargs):
    return run_coordinate_descent(
        coords if coords is not None else build_coords(data), iters, TASK,
        data.responses, data.weights, data.offsets, device="cpu", **kwargs)


def final_states(result):
    out = {}
    for cid, m in result.model.models.items():
        out[cid] = (m.model.coefficients.means if hasattr(m, "model")
                    else m.coefficients_projected).numpy()
    return out


def assert_states_equal(a, b):
    fa, fb = final_states(a), final_states(b)
    assert sorted(fa) == sorted(fb)
    for cid in fa:
        np.testing.assert_array_equal(fa[cid], fb[cid])


class TestDoubleBufferingParity:
    def test_block1_pipelined_bitexact_vs_sequential(self, data):
        seq = run_cd(data, pipeline_depth=0)
        pipe = run_cd(data, pipeline_depth=1)
        assert [s.objective for s in seq.states] \
            == [s.objective for s in pipe.states]
        assert_states_equal(seq, pipe)

    def test_pipeline_overlap_telemetry(self, data):
        cd.reset_hot_loop_stats()
        run_cd(data, pipeline_depth=1)
        hot = cd.HOT_LOOP_STATS
        assert hot["max_inflight"] >= 2
        assert hot["pipelined_resolves"] >= 1
        assert hot["overlap_secs"] >= 0.0
        assert hot["epilogue_fetches"] == hot["updates"] == 6
        assert hot["update_dispatch_secs"] > 0.0
        cd.reset_hot_loop_stats()
        run_cd(data, pipeline_depth=0)
        assert cd.HOT_LOOP_STATS["max_inflight"] == 0
        assert cd.HOT_LOOP_STATS["pipelined_resolves"] == 0

    def test_depth_and_block_validation(self, data):
        with pytest.raises(ValueError, match="pipeline_depth"):
            run_cd(data, iters=1, pipeline_depth=2)
        with pytest.raises(ValueError, match="block_size"):
            run_cd(data, iters=1, block_size=0)


class TestBlockParallelSweeps:
    def test_blocked_matches_sequential_within_tolerance(self, data):
        """Stale block-start partials are Jacobi-style updates that each
        sweep corrects: after 8 sweeps the blocked objective is within
        1e-3 of the sequential one, and closer than after 5."""
        seq5 = run_cd(data, iters=5, pipeline_depth=0)
        seq8 = run_cd(data, iters=8, pipeline_depth=0)
        for bs in (2, 3):
            blk5 = run_cd(data, iters=5, block_size=bs)
            blk8 = run_cd(data, iters=8, block_size=bs)
            gap5 = abs(blk5.states[-1].objective
                       - seq5.states[-1].objective)
            gap8 = abs(blk8.states[-1].objective
                       - seq8.states[-1].objective)
            assert blk8.states[-1].objective == pytest.approx(
                seq8.states[-1].objective, rel=1e-3)
            assert gap8 < gap5
            fs, fb = final_states(seq8), final_states(blk8)
            for cid in fs:
                np.testing.assert_allclose(fb[cid], fs[cid], rtol=0.1,
                                           atol=0.1)

    def test_block_amortizes_fetches(self, data):
        cd.reset_hot_loop_stats()
        run_cd(data, block_size=2)
        # blocks of (2, 1): 2 reads for 3 updates a sweep
        assert cd.HOT_LOOP_STATS["updates"] == 6
        assert cd.HOT_LOOP_STATS["epilogue_fetches"] == 4

    def test_block1_is_sequential_semantics(self, data):
        a = run_cd(data, block_size=1, pipeline_depth=0)
        b = run_cd(data, block_size=1, pipeline_depth=1)
        np.testing.assert_array_equal([s.objective for s in a.states],
                                      [s.objective for s in b.states])


class TestRecoveryOneUpdateLate:
    def test_transient_fault_while_in_flight_recovers_bitexact(self, data):
        """A NaN poisons coordinate 1's update; pipelined, it surfaces at
        the read after coordinate 2 was dispatched against the poisoned
        total. The ladder retries from last-good, the speculative
        successor is rolled back and run again, and the result matches
        the sequential recovery run float for float."""
        policy = RecoveryPolicy(max_retries=2, on_exhausted="abort",
                                damping=1.0)
        faults.arm("cd.update", "nan", times=1, tag="0.1")
        seq = run_cd(data, pipeline_depth=0, recovery=policy)
        faults.arm("cd.update", "nan", times=1, tag="0.1")
        seen = []
        emitter = EventEmitter()
        emitter.register_listener(seen.append)
        pipe = run_cd(data, pipeline_depth=1, recovery=policy,
                      events=emitter)
        kinds = [type(e).__name__ for e in seen]
        assert "FaultEvent" in kinds and "RecoveryEvent" in kinds
        objs = [s.objective for s in pipe.states]
        assert np.isfinite(objs).all()
        assert objs == [s.objective for s in seq.states]
        assert_states_equal(seq, pipe)

    def test_injected_fault_at_speculative_dispatch(self, data):
        faults.arm("cd.update", "raise", times=1, tag="0.2")
        seen = []
        emitter = EventEmitter()
        emitter.register_listener(seen.append)
        res = run_cd(data, pipeline_depth=1,
                     recovery=RecoveryPolicy(max_retries=2,
                                             on_exhausted="abort"),
                     events=emitter)
        assert len(res.states) == 6
        assert np.isfinite([s.objective for s in res.states]).all()
        actions = [getattr(e, "action", None) for e in seen]
        assert "retried" in actions and "recovered" in actions

    def test_quarantine_under_blocked_pipeline(self, data, tmp_path):
        """A coordinate raising in every sweep inside a block is
        quarantined by its own budget while the rest go on, and snapshots
        keep landing at RAW block boundaries."""
        for it in range(4):
            faults.arm("cd.update", "raise", times=100, tag=f"{it}.1")
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        res = run_cd(data, iters=4, block_size=2,
                     recovery=RecoveryPolicy(max_retries=0,
                                             on_exhausted="abort",
                                             quarantine_after=2),
                     checkpoint_manager=mgr,
                     checkpoint_every_coordinates=1)
        assert res.quarantined == ["perUser"]
        per_sweep = {}
        for s in res.states:
            per_sweep.setdefault(s.iteration, []).append(s.coordinate_id)
        assert all("fixed" in v and "perItem" in v
                   for v in per_sweep.values())
        indices = {mgr.restore(step=s).get("coordinate_index")
                   for s in mgr.all_steps()}
        assert indices <= {0, 2}, sorted(indices)


def _with_downsampled_fixed(data, order):
    """``build_coords`` with the fixed effect down-sampled at 0.7, in the
    coordinate order ``order``."""
    coords = build_coords(data, rate=0.7)
    return {cid: coords[cid] for cid in order}


class TestSnapshotConsistencyUnderFaults:
    def test_quarantine_snapshot_excludes_speculative_rng_advance(
            self, data, tmp_path):
        """The per-user coordinate diverges for good while the
        down-sampled fixed effect's speculative dispatch is in flight; the
        quarantine snapshot must hold the rolled-back update count, and a
        resume from it is bit-exact."""
        def run(**kw):
            return run_cd(data, coords=_with_downsampled_fixed(
                data, ["perUser", "fixed"]),
                recovery=RecoveryPolicy(max_retries=0,
                                        on_exhausted="abort",
                                        quarantine_after=1), **kw)

        faults.arm("cd.update", "nan", times=100, tag="0.0")
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        full = run(checkpoint_manager=mgr, checkpoint_every_coordinates=1)
        faults.disarm_all()
        assert full.quarantined == ["perUser"]
        snap = mgr.restore(step=1)
        assert snap.get("update_counts", {}).get("fixed", 0) == 0
        resumed = run(resume_snapshot=snap)
        assert_states_equal(full, resumed)

    def test_pending_ladder_snapshot_after_dispatch_fault(self, data,
                                                          tmp_path):
        """The speculative successor's dispatch raises while the pending
        update is in flight; the pending update then diverges and its
        ladder quarantines and snapshots "about to run the successor":
        that snapshot holds the successor's count from before its failed
        dispatch."""
        faults.arm("cd.update", "nan", times=100, tag="0.1")
        faults.arm("cd.update", "raise", times=1, tag="0.2")
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        res = run_cd(data, iters=1, coords=_with_downsampled_fixed(
            data, ["perUser", "perItem", "fixed"]),
            recovery=RecoveryPolicy(max_retries=1, on_exhausted="abort",
                                    quarantine_after=1),
            checkpoint_manager=mgr)
        assert res.quarantined == ["perItem"]
        snap = mgr.restore(step=2)
        assert snap.get("update_counts", {}).get("fixed", 0) == 0

    def test_block_dispatch_fault_restores_rng_positions(self, data):
        """A fault in the middle of a 2-wide block's dispatch, after the
        down-sampled member advanced its count, restores every member's
        count before the members replay."""
        coords = _with_downsampled_fixed(data,
                                         ["fixed", "perUser", "perItem"])
        faults.arm("cd.update", "raise", times=1, tag="0.1")
        run_cd(data, coords=coords, block_size=2,
               recovery=RecoveryPolicy(max_retries=2, on_exhausted="abort"))
        assert coords["fixed"]._update_count == 2

    def test_block_replay_never_snapshots_mid_block(self, data, tmp_path):
        def run(**kw):
            return run_cd(data, block_size=2,
                          recovery=RecoveryPolicy(max_retries=2,
                                                  on_exhausted="abort",
                                                  damping=1.0), **kw)

        faults.arm("cd.update", "nan", times=1, tag="0.1")
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        full = run(checkpoint_manager=mgr, checkpoint_every_coordinates=1)
        faults.disarm_all()
        steps = mgr.all_steps()
        indices = {mgr.restore(step=s).get("coordinate_index")
                   for s in steps}
        assert indices <= {0, 2}, sorted(indices)
        mid = [s for s in steps
               if mgr.restore(step=s).get("coordinate_index") == 2]
        assert mid
        resumed = run(resume_snapshot=mgr.restore(step=mid[0]))
        assert_states_equal(full, resumed)


class TestBlockCheckpointBoundaries:
    def test_blocked_resume_is_bitexact(self, data, tmp_path):
        ref = run_cd(data, block_size=2)
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        full = run_cd(data, block_size=2, checkpoint_manager=mgr,
                      checkpoint_every_coordinates=1)
        steps = mgr.all_steps()
        indices = {mgr.restore(step=s).get("coordinate_index")
                   for s in steps}
        assert 1 not in indices
        mid = [s for s in steps
               if mgr.restore(step=s).get("coordinate_index", 0) != 0]
        assert mid
        resumed = run_cd(data, block_size=2,
                         resume_snapshot=mgr.restore(step=mid[0]))
        assert_states_equal(full, resumed)
        assert_states_equal(ref, full)


class TestLazyMultiInFlight:
    def test_deferred_results_force_out_of_order(self, data):
        ds = tds.build_fixed_effect_dataset(data, "global", device="cpu")
        prob = TProblem(config=l2_config(), task=TASK)
        b1 = ds.with_offsets(torch.zeros(data.num_samples))
        b2 = ds.with_offsets(torch.full((data.num_samples,), 0.25))
        lazy1 = prob.run_lazy(b1)
        lazy2 = prob.run_lazy(b2)
        _, eager1 = prob.run(b1)
        _, eager2 = prob.run(b2)
        assert lazy2.value == pytest.approx(eager2.value)
        assert lazy1.value == pytest.approx(eager1.value)
        assert lazy1.iterations == eager1.iterations
        assert lazy2.iterations == eager2.iterations


def _jax_run(rng_seed, **kw):
    """The JAX package's run of the same data at f32 (x64 off)."""
    jdata = make_data(jds, np.random.default_rng(rng_seed))
    task = jcfg.TaskType.LOGISTIC_REGRESSION

    def re(id_type, shard):
        return jco.RandomEffectCoordinate(
            dataset=jds.build_random_effect_dataset(
                jdata, jds.RandomEffectDataConfiguration(id_type, shard, 1)),
            problem=jre.RandomEffectOptimizationProblem(
                config=l2_config(jcfg), task=task))

    with jax.enable_x64(False):
        coords = {"fixed": jco.FixedEffectCoordinate(
                      dataset=jds.build_fixed_effect_dataset(jdata,
                                                             "global"),
                      problem=JProblem(config=l2_config(jcfg), task=task)),
                  "perUser": re("userId", "per_user"),
                  "perItem": re("itemId", "per_item")}
        init = {cid: jnp.zeros_like(c.initial_state(), jnp.float32)
                for cid, c in coords.items()}
        jcd.reset_hot_loop_stats()
        res = jcd.run_coordinate_descent(
            coords, 2, task, jnp.asarray(jdata.responses, jnp.float32),
            jnp.asarray(jdata.weights, jnp.float32),
            jnp.asarray(jdata.offsets, jnp.float32), initial_states=init,
            **kw)
        return res, dict(jcd.HOT_LOOP_STATS)


@pytest.mark.parametrize("kw", [dict(pipeline_depth=1),
                                dict(block_size=2, pipeline_depth=1)],
                         ids=["pipelined", "blocked"])
def test_objectives_match_jax(kw):
    jres, jhot = _jax_run(42, **kw)
    cd.reset_hot_loop_stats()
    res = run_cd(make_data(tds, np.random.default_rng(42)), **kw)
    hot = dict(cd.HOT_LOOP_STATS)
    assert [(s.iteration, s.coordinate_id) for s in res.states] == \
        [(s.iteration, s.coordinate_id) for s in jres.states]
    np.testing.assert_allclose([s.objective for s in res.states],
                               [s.objective for s in jres.states],
                               rtol=1e-5)
    assert hot["epilogue_fetches"] == jhot["epilogue_fetches"]
    assert hot["updates"] == jhot["updates"] == 6
    assert hot["max_inflight"] == jhot["max_inflight"]


def test_default_depth_is_the_jax_default():
    import inspect

    for fn in (run_coordinate_descent, jcd.run_coordinate_descent):
        params = inspect.signature(fn).parameters
        assert params["pipeline_depth"].default == 1
        assert params["block_size"].default == 1


def test_blocked_down_sampled_run_is_finite(data):
    coords = _with_downsampled_fixed(data, ["fixed", "perUser", "perItem"])
    res = run_cd(data, coords=coords, block_size=3)
    assert np.isfinite([s.objective for s in res.states]).all()
    assert coords["fixed"]._update_count == 2
    assert dataclasses.replace(l2_config(), down_sampling_rate=0.7) == \
        coords["fixed"].problem.config

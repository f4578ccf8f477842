"""The telemetry drift the port's photonlint found, repaired and held
against the JAX package on the same inputs.

- A contained listener exception counts ``listener_errors{listener}`` on
  the metrics registry in both packages.
- The compacted per-user solve observes ``re_chunk_active_lanes`` once
  per chunk: the same observation count and sum as the JAX package's on
  a small GLMix, and once per chunk on the port's entity-sharded loop.
- The service's stage spans are named in a literal table at the emit
  site; the spans it records and the stage observations it makes equal
  the JAX service's for the same request and timestamps.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.game import dataset as jds
from photon_ml_tpu.game import random_effect as jre
from photon_ml_tpu.obs import metrics as jmetrics
from photon_ml_tpu.obs import trace as jtrace
from photon_ml_tpu.optimize import config as jcfg
from photon_ml_tpu.serve import batcher as jbatcher
from photon_ml_tpu.serve import service as jservice
from photon_ml_tpu.utils import events as jevents
from photon_ml_tpu_torch.game import dataset as tds
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.obs import metrics as tmetrics
from photon_ml_tpu_torch.obs import trace as ttrace
from photon_ml_tpu_torch.optimize import config as tcfg
from photon_ml_tpu_torch.parallel import mesh as tmesh
from photon_ml_tpu_torch.serve import batcher as tbatcher
from photon_ml_tpu_torch.serve import service as tservice
from photon_ml_tpu_torch.utils import events as tevents

torch.set_num_threads(1)


# -- listener_errors ----------------------------------------------------------

def test_listener_errors_counted_on_the_registry_as_in_jax():
    def broken(event):
        raise RuntimeError("listener down")

    got = {}
    for name, events, metrics in (("jax", jevents, jmetrics),
                                  ("port", tevents, tmetrics)):
        counter = metrics.REGISTRY.counter("listener_errors")
        before = counter.by_label("listener")
        bus = events.EventEmitter()
        seen = []
        bus.register_listener(broken)
        bus.register_listener(seen.append)
        for _ in range(2):
            bus.send_event(events.TrainingStartEvent(timestamp=1.0))
        assert len(seen) == 2, name  # the other listener still runs
        after = counter.by_label("listener")
        got[name] = {k: after[k] - before.get(k, 0) for k in after
                     if after[k] != before.get(k, 0)}
    assert got["port"] == got["jax"] == {broken.__qualname__: 2}
    assert not hasattr(tevents, "LISTENER_ERRORS")


# -- re_chunk_active_lanes ----------------------------------------------------

N, USERS, MOVIES = 2000, 30, 40
RE_CONFIG = dict(random_effect_type="userId", feature_shard_id="per_user",
                 num_active_data_points_upper_bound=64,
                 num_features_to_keep_upper_bound=24)
PER_USER = "20,1e-7,1,1,LBFGS,L2"


def _game_dataset(mod, seed=5):
    rng = np.random.default_rng(seed)
    users = (rng.zipf(1.3, size=N) % USERS).astype(np.int64)
    movies = rng.integers(0, MOVIES, N)
    y = (rng.uniform(size=N) < 0.4).astype(np.float64)
    data = mod.GameDataset(responses=y, feature_shards={
        "per_user": sp.csr_matrix((np.ones(N, np.float32),
                                   (np.arange(N), movies)),
                                  shape=(N, MOVIES))})
    data.encode_ids("userId", users)
    return data


def _lanes(registry):
    snap = registry.histogram("re_chunk_active_lanes").snapshot()
    return (0, 0.0) if snap is None else (snap["count"], snap["sum"])


@pytest.fixture
def clean_histograms():
    for reg in (jmetrics.REGISTRY, tmetrics.REGISTRY):
        reg.histogram("re_chunk_active_lanes").reset()
    yield
    tmesh.set_default_mesh(None)


def test_compacted_solve_observes_chunk_lanes_as_in_jax(clean_histograms):
    scores = np.random.default_rng(3).normal(size=N) * 0.3
    j = jds.build_random_effect_dataset(
        _game_dataset(jds), jds.RandomEffectDataConfiguration(**RE_CONFIG),
        dtype=jnp.float64)
    t = tds.build_random_effect_dataset(
        _game_dataset(tds), tds.RandomEffectDataConfiguration(**RE_CONFIG),
        dtype=torch.float64, device="cpu")
    jre.RandomEffectOptimizationProblem(
        config=jcfg.GLMOptimizationConfiguration.parse(PER_USER),
        task=jcfg.TaskType.LOGISTIC_REGRESSION,
        lane_compaction_chunk=4).run(j, j.offsets_with(jnp.asarray(scores)))
    tre.reset_solve_stats()
    tre.RandomEffectOptimizationProblem(
        config=tcfg.GLMOptimizationConfiguration.parse(PER_USER),
        task=tcfg.TaskType.LOGISTIC_REGRESSION,
        lane_compaction_chunk=4).run(t, t.offsets_with(torch.tensor(scores)))
    count, total = _lanes(tmetrics.REGISTRY)
    assert (count, total) == _lanes(jmetrics.REGISTRY)
    assert count == tre.SOLVE_STATS["chunks"] > 1
    assert total == sum(tre.SOLVE_STATS["lane_counts"]) + t.X.shape[0]


def test_sharded_chunk_loop_observes_once_per_chunk(clean_histograms):
    """The entity-sharded loop's chunking follows its per-shard layout,
    so it is held to its own chunk count and lane counts."""
    rng = np.random.default_rng(0)
    users = rng.integers(0, 33, size=700)
    data = tds.GameDataset(
        responses=(rng.uniform(size=700) < 0.5).astype(np.float64),
        feature_shards={"per_user": sp.csr_matrix(rng.normal(size=(700, 5)))})
    data.encode_ids("userId", users)
    ds = tds.build_random_effect_dataset(
        data, tds.RandomEffectDataConfiguration(
            random_effect_type="userId", feature_shard_id="per_user",
            num_partitions=1),
        entity_axis_size=4, dtype=torch.float64, device="cpu")
    tmesh.set_default_mesh(tmesh.make_mesh(num_data=2, num_entity=4,
                                           devices=["cpu"] * 8))
    tre.reset_solve_stats()
    tre.RandomEffectOptimizationProblem(
        config=tcfg.GLMOptimizationConfiguration.parse(
            "25,1e-9,0.5,1,LBFGS,L2"),
        task=tcfg.TaskType.LOGISTIC_REGRESSION, lane_compaction_chunk=5,
        entity_shards=4).run(ds, ds.offsets_with(torch.zeros(700)))
    count, total = _lanes(tmetrics.REGISTRY)
    assert count == tre.SOLVE_STATS["chunks"] >= 2
    assert tre.SOLVE_STATS["shard_lane_counts"]
    assert total == sum(tre.SOLVE_STATS["lane_counts"]) + ds.X.shape[0]


# -- the service's stage spans ------------------------------------------------

def _score_work(mod):
    return mod.ScoreWork(rows=[{}], request_id=7, reply=lambda r: None,
                         trace_id="t" * 32, span_id="s" * 16,
                         parent_span=None, sampled=True, read_ns=1_000,
                         enqueued_ns=2_000, picked_ns=5_000)


def test_stage_spans_equal_the_jax_service():
    formed, scored, reply, end = 9_000, 40_000, 41_000, 47_500
    stages = {"tier_gather": 6_000, "device_score": 20_000}
    out = {}
    for name, service, batcher, trace, metrics in (
            ("jax", jservice.ServeService, jbatcher, jtrace, jmetrics),
            ("port", tservice.ServeService, tbatcher, ttrace, tmetrics)):
        fake = types.SimpleNamespace(_registry=metrics.MetricsRegistry(),
                                     _exemplar_path=None)
        w = _score_work(batcher)
        tracer = trace.enable()
        try:
            if name == "port":
                service._observe_stages(fake, w, formed, scored, stages)
            service._finish_request_trace(fake, w, formed, scored, stages,
                                          reply, end)
        finally:
            trace.disable()
        spans = [(e["name"], e["depth"], e["dur_us"], e["labels"])
                 for e in tracer.events()]
        observed = [(r["labels"]["stage"], r["count"], r["sum"])
                    for r in fake._registry.histogram(
                        "serve_stage_ms").records()]
        out[name] = (spans, sorted(observed))
    assert out["port"] == out["jax"]
    names = [s[0] for s in out["port"][0]]
    assert names == ["serve.batch_form", "serve.tier_gather",
                     "serve.device_score", "serve.reply", "serve.request"]

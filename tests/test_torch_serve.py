"""The port's serving path held against the JAX package's, on the CPU.

Counterparts of ``tests/test_serve.py``'s classes for
``photon_ml_tpu_torch/serve`` and ``obs``: the batcher, the tiered store
(f32 and bf16 tiers), the typed wire errors, ``ServingScorer`` (equal to
the port's ``score_game_dataset`` bit for bit with the f32 tier, and to
the JAX package's ``ServingScorer`` within rel 1e-6 with either tier),
``GenerationStore``, the hot-swap state machine in process on a unix
socket, probation rollback, the JAX client against the port's service
(byte-identical messages), and one subprocess run of ``python -m
photon_ml_tpu_torch.serve.service --device cpu`` (ready line, scores
equal to the port's scoring driver by uid, SIGTERM → 75). Model
directories are written by the JAX package (``test_serve._build_model_dir``)
and read by both.
"""

from __future__ import annotations

import glob
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from photon_ml_tpu.io.avro import write_container
from photon_ml_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from photon_ml_tpu.serve import protocol as jproto
from photon_ml_tpu.serve.scoring import ServingScorer as JaxScorer
from photon_ml_tpu.serve.scoring import load_scoring_model as jax_load
from photon_ml_tpu.serve.tiers import TieredCoefficientStore as JaxStore
from photon_ml_tpu_torch.game.models import RandomEffectModel
from photon_ml_tpu_torch.io.data_format import game_dataset_from_records
from photon_ml_tpu_torch.io.model_io import load_scored_items
from photon_ml_tpu_torch.obs.metrics import MetricsRegistry
from photon_ml_tpu_torch.serve import protocol as tproto
from photon_ml_tpu_torch.serve.batcher import (
    MicroBatcher,
    ScoreWork,
    bucket_rows,
)
from photon_ml_tpu_torch.serve.protocol import ServeClient
from photon_ml_tpu_torch.serve.scoring import (
    GenerationStore,
    ServingScorer,
    load_scoring_model,
    materialize_model,
    score_game_dataset,
)
from photon_ml_tpu_torch.serve.service import ServeService
from photon_ml_tpu_torch.serve.tiers import TieredCoefficientStore
from test_serve import (
    GAME_SCHEMA,
    SECTIONS,
    SECTIONS_FLAG,
    _build_model_dir,
    _make_records,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREEMPTED_EXIT = 75
CPU = "cpu"

#: bf16 tier: a device-tier row is each f32 coefficient rounded to bf16
#: (relative error at most 2^-8 per element), so a row's contribution
#: moves by at most 2^-8 * sum_j |x_j w_j|; the tests hold scores to that
#: bound (plus f32 rounding of the sums).
BF16_REL = 2.0 ** -8


# ---------------------------------------------------------------------------
# bucket_rows + MicroBatcher
# ---------------------------------------------------------------------------


class TestBucketRows:
    def test_power_of_two_with_floor(self):
        assert bucket_rows(1) == 8 and bucket_rows(8) == 8
        assert bucket_rows(9) == 16
        assert bucket_rows(100) == 128

    def test_min_and_max_bucket(self):
        assert bucket_rows(1, min_bucket=1) == 1
        assert bucket_rows(3, min_bucket=1) == 4
        assert bucket_rows(500, max_bucket=64) == 64


def _work(n_rows, rid="r"):
    return ScoreWork(rows=[{} for _ in range(n_rows)], request_id=rid,
                     reply=lambda _obj: None)


class TestMicroBatcher:
    def test_arrival_order_batch_respects_row_cap(self):
        b = MicroBatcher(1000, 10, registry=MetricsRegistry())
        for i in range(4):
            assert b.submit(_work(4, rid=i)) is None
        batch = b.next_batch(timeout=0.01)
        assert [w.request_id for w in batch] == [0, 1]
        assert b.queue_depth() == 8

    def test_oversize_request_yields_alone(self):
        b = MicroBatcher(1000, 10, registry=MetricsRegistry())
        b.submit(_work(25, rid="wide"))
        b.submit(_work(1, rid="next"))
        assert [w.request_id for w in b.next_batch(timeout=0.01)] == [
            "wide"]

    def test_queue_full_sheds_without_blocking(self):
        reg = MetricsRegistry()
        b = MicroBatcher(10, 10, registry=reg)
        assert b.submit(_work(8)) is None
        t0 = time.monotonic()
        assert b.submit(_work(8)) == "queue_full"
        assert time.monotonic() - t0 < 0.5
        assert reg.counter("serve_shed").value(reason="queue_full") == 1
        assert b.queue_depth() == 8

    def test_next_batch_never_mixes_generations(self):
        b = MicroBatcher(1000, 100, registry=MetricsRegistry())
        for rid, gen in (("a", 1), ("b", 1), ("c", 2), ("d", 2),
                         ("e", 3)):
            b.submit(ScoreWork(rows=[{}], request_id=rid,
                               reply=lambda _obj: None, generation=gen))
        assert [w.request_id for w in b.next_batch(0.01)] == ["a", "b"]
        assert [w.request_id for w in b.next_batch(0.01)] == ["c", "d"]
        assert [w.request_id for w in b.next_batch(0.01)] == ["e"]

    def test_close_sheds_new_work_but_drains_queued(self):
        reg = MetricsRegistry()
        b = MicroBatcher(100, 100, registry=reg)
        b.submit(_work(2, rid="queued"))
        b.close()
        assert b.submit(_work(1)) == "closed"
        assert reg.counter("serve_shed").value(reason="closed") == 1
        assert [w.request_id for w in b.next_batch(0.01)] == ["queued"]
        assert b.next_batch(0.01) == []


# ---------------------------------------------------------------------------
# Tiered coefficient store
# ---------------------------------------------------------------------------


def _block(n=12, d=3, seed=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32)


def _tier_model(n=12, d=3, seed=2):
    return RandomEffectModel(
        random_effect_type="userId", feature_shard_id="user",
        entity_codes=np.arange(n),
        coefficients=torch.from_numpy(_block(n, d, seed)),
        entity_ids=np.asarray([f"user{u}" for u in range(n)]))


def _store(model=None, budget=4 * 12, registry=None, **kw):
    return TieredCoefficientStore(
        "c", model or _tier_model(), hbm_budget_bytes=budget,
        registry=registry or MetricsRegistry(), device=CPU, **kw)


def _ids(*users):
    return np.asarray([f"user{u}" for u in users], dtype=object)


def _rows(store, ids):
    """The coefficient row per request row of ``store.lookup``, on the
    host."""
    table, rows = store.lookup(ids)
    return table[torch.from_numpy(rows)].numpy()


class TestReqtrace:
    """The port's request-trace identity against the JAX package's, on
    the same seeds and arrival orders: equal ids, sampling decisions and
    slowest-N keeps."""

    def test_ids_and_sampling_equal_the_jax_packages(self):
        from photon_ml_tpu.serve import reqtrace as jrt
        from photon_ml_tpu_torch.serve import reqtrace as trt

        j, t = jrt.TraceIdMinter("seed"), trt.TraceIdMinter("seed")
        ids = [t.mint() for _ in range(16)]
        assert ids == [j.mint() for _ in range(16)]
        assert len(set(ids)) == 16
        for tid in ids[:4]:
            for name, seq in (("serve.reply", 0), ("serve.reply", 1),
                              ("serve.tier_gather", 0)):
                assert trt.child_span_id(tid, name, seq) == \
                    jrt.child_span_id(tid, name, seq)
        for rate in (0.0, 0.05, 0.3, 1.0):
            js, ts = jrt.HeadSampler(rate), trt.HeadSampler(rate)
            got = [ts.should_sample() for _ in range(100)]
            assert got == [js.should_sample() for _ in range(100)]
            # evenly paced: one in 1/rate, to the accumulator's rounding
            assert abs(sum(got) - 100 * rate) <= 1

    def test_exemplar_reservoir_keeps_the_jax_packages_slowest(self):
        from photon_ml_tpu.serve import reqtrace as jrt
        from photon_ml_tpu_torch.serve import reqtrace as trt

        with pytest.raises(ValueError):
            trt.ExemplarReservoir(0)
        j, t = jrt.ExemplarReservoir(5), trt.ExemplarReservoir(5)
        rng = np.random.default_rng(8)
        for i, ms in enumerate(rng.exponential(20.0, size=200)):
            rec = {"request_id": str(i), "latency_ms": float(ms)}
            assert t.offer(float(ms), rec) == j.offer(float(ms), rec)
        assert t.snapshot() == j.snapshot() and len(t) == 5
        assert t.generation() == j.generation()
        kept = [r["latency_ms"] for r in t.snapshot()]
        assert kept == sorted(kept, reverse=True)


class TestTieredCoefficientStore:
    def test_requires_raw_entity_ids(self):
        m = _tier_model()
        m = RandomEffectModel(
            random_effect_type=m.random_effect_type,
            feature_shard_id=m.feature_shard_id,
            entity_codes=m.entity_codes, coefficients=m.coefficients)
        with pytest.raises(ValueError, match="entity_ids"):
            _store(m)
        with pytest.raises(ValueError, match="device_dtype"):
            _store(device_dtype="f16")

    def test_capacity_follows_the_budget_and_the_tier_dtype(self):
        reg = MetricsRegistry()
        store = _store(registry=reg)  # row_bytes = 12
        assert store.capacity == 4 and store.row_bytes == 12
        assert reg.gauge("serve_tier_device_bytes").value(
            coordinate="c") == 4 * 12
        # the bf16 tier halves row_bytes: twice the entities, same budget
        half = _store(device_dtype="bf16")
        assert half.row_bytes == 6 and half.capacity == 8
        assert half._device_block.dtype == torch.bfloat16

    def test_every_tier_serves_the_exact_model_rows(self):
        block = _block()
        store = _store()
        for users in ((0, 1, 2, 3), (0, 1, 2, 3), (4, 5, 6, 7),
                      (0, 1, 2, 3), (0, 11, 11, 2)):
            got = _rows(store, _ids(*users))
            np.testing.assert_array_equal(got, block[list(users)],
                                          err_msg=str(users))

    def test_bf16_tier_rounds_device_rows_only(self):
        block = _block()
        store = _store(budget=2 * 6, device_dtype="bf16")  # 2 slots
        want = torch.from_numpy(block).to(torch.bfloat16).float().numpy()
        got = _rows(store, _ids(0, 1))  # promoted to the device tier
        np.testing.assert_array_equal(got, want[[0, 1]])
        assert np.all(np.abs(got - block[[0, 1]])
                      <= BF16_REL * np.abs(block[[0, 1]]))
        # four entities, two slots: the overflow comes from the model
        # block, exact
        got = _rows(store, _ids(2, 3, 4, 5))
        from_model = [i for i, u in enumerate((2, 3, 4, 5))
                      if f"user{u}" not in store._slot_of]
        assert from_model
        np.testing.assert_array_equal(got[from_model],
                                      block[[2, 3, 4, 5]][from_model])

    def test_unknown_entity_scores_zero(self):
        store = _store(budget=1 << 20)
        got = _rows(store, np.asarray(["user0", "ghost"], dtype=object))
        np.testing.assert_array_equal(got[1], np.zeros(3, np.float32))
        assert np.any(got[0] != 0)

    def test_lru_eviction_and_promotion_counters(self):
        reg = MetricsRegistry()
        store = _store(registry=reg)
        hits = reg.counter("serve_tier_hits")
        _rows(store, _ids(0, 1, 2, 3))
        assert hits.value(coordinate="c", tier="model") == 4
        _rows(store, _ids(0, 1, 2, 3))
        assert hits.value(coordinate="c", tier="device") == 4
        _rows(store, _ids(4, 5, 6, 7))
        assert reg.counter("serve_tier_evict").value(
            coordinate="c", tier="device") == 4
        assert store.stats()["host_entities"] == 4
        _rows(store, _ids(0, 1))
        assert hits.value(coordinate="c", tier="host") == 2
        assert reg.counter("serve_tier_promote").value(
            coordinate="c", tier="host") == 2

    def test_batch_wider_than_device_capacity_overflows_to_model(self):
        block = _block()
        store = _store()
        users = tuple(range(12))
        np.testing.assert_array_equal(_rows(store, _ids(*users)),
                                      block[list(users)])
        assert store.stats()["device_entities"] <= store.capacity

    def test_release_then_rewarm_is_bit_exact(self):
        block = _block()
        store = _store()
        _rows(store, _ids(0, 1, 2, 3))
        store.release()
        assert store.stats()["released"]
        np.testing.assert_array_equal(_rows(store, _ids(0, 1, 2, 3)),
                                      block[[0, 1, 2, 3]])
        assert not store.stats()["released"]

    def test_host_tier_capacity_bounds_demotions(self):
        reg = MetricsRegistry()
        store = _store(registry=reg, host_capacity=2)
        _rows(store, _ids(0, 1, 2, 3))
        _rows(store, _ids(4, 5, 6, 7))
        assert store.stats()["host_entities"] == 2
        assert reg.counter("serve_tier_evict").value(
            coordinate="c", tier="host") == 2

    def test_device_bytes_gauge_survives_release_and_rewarm(self):
        reg = MetricsRegistry()
        g = reg.gauge("serve_tier_device_bytes")
        store = _store(registry=reg)
        assert g.value(coordinate="c") == 48
        store.release()
        assert g.value(coordinate="c") == 0
        assert store.stats()["device_bytes"] == 0
        _rows(store, _ids(0, 1))
        assert g.value(coordinate="c") == 48
        store.release()
        assert g.value(coordinate="c") == 0
        _rows(store, _ids(2, 3))
        assert g.value(coordinate="c") == 48
        assert store.stats()["device_bytes"] == 48

    def test_device_bytes_gauge_sums_overlapping_stores(self):
        reg = MetricsRegistry()
        a = _store(registry=reg)
        b = _store(_tier_model(seed=5), budget=2 * 12, registry=reg)
        g = reg.gauge("serve_tier_device_bytes")
        assert g.value(coordinate="c") == 4 * 12 + 2 * 12
        a.release()
        assert g.value(coordinate="c") == 2 * 12
        b.release()
        assert g.value(coordinate="c") == 0

    @pytest.mark.parametrize("tier", ["f32", "bf16"])
    def test_tiers_and_counts_equal_the_jax_store(self, tier):
        """One churning request sequence (a 5-slot device tier, a 3-entry
        host tier, 40 entities, repeats and unknown ids) through both
        packages' stores: after every lookup the same rows, the same
        device and host residents in the same LRU order (which fixes
        each row's tier), and the same hit, promote and evict counts."""
        import jax.numpy as jnp

        from photon_ml_tpu.game.models import (
            RandomEffectModel as JaxModel,
        )

        n, d = 40, 3
        block = _block(n, d, seed=9)
        ids = np.asarray([f"user{u}" for u in range(n)])
        row_bytes = d * (4 if tier == "f32" else 2)
        j_reg, t_reg = JaxRegistry(), MetricsRegistry()
        j = JaxStore("c", JaxModel("userId", "user", np.arange(n),
                                   jnp.asarray(block), entity_ids=ids),
                     5 * row_bytes, host_capacity=3, device_dtype=tier,
                     registry=j_reg)
        t = _store(_tier_model(n, d, seed=9), budget=5 * row_bytes,
                   registry=t_reg, host_capacity=3, device_dtype=tier)
        rng = np.random.default_rng(4)
        for step in range(60):
            users = rng.zipf(1.3, size=int(rng.integers(1, 9))) - 1
            req = np.asarray([f"user{u}" if u < n + 2 else "ghost"
                              for u in users], dtype=object)
            np.testing.assert_array_equal(_rows(t, req), j.lookup(req),
                                          err_msg=f"step {step}")
            assert list(t._slot_of) == list(j._slot_of), step
            assert list(t._host) == list(j._host), step
            for name in ("serve_tier_hits", "serve_tier_promote",
                         "serve_tier_evict"):
                assert (t_reg.counter(name).by_label("tier")
                        == j_reg.counter(name).by_label("tier")), \
                    (step, name)
        hits = t_reg.counter("serve_tier_hits").by_label("tier")
        assert {"device", "host", "model"} <= set(hits)
        assert t_reg.counter("serve_tier_evict").value(
            coordinate="c", tier="host") > 0


# ---------------------------------------------------------------------------
# typed client-side errors
# ---------------------------------------------------------------------------


class TestTypedErrors:
    def test_non_error_responses_parse_to_none(self):
        assert tproto.typed_error({"kind": "scores", "scores": []}) is None
        assert tproto.typed_error({"kind": "pong"}) is None

    def test_shed_grammar_parses_to_shed_error(self):
        err = tproto.typed_error({"kind": "error",
                                  "error": "shed:queue_full"})
        assert isinstance(err, tproto.ShedError)
        assert err.reason == "queue_full"

    def test_shard_unavailable_parses_typed(self):
        err = tproto.typed_error(
            {"kind": "error", "error": "ShardUnavailableError: shard 2 "
                                       "has no live member"})
        assert isinstance(err, tproto.ShardUnavailableError)

    def test_swap_refusal_parses_typed_from_swap_result(self):
        err = tproto.typed_error(
            {"kind": "swap_result", "outcome": "refused",
             "error": "ModelSwapRefusedError: canary diverged"})
        assert isinstance(err, tproto.ModelSwapRefusedError)
        assert err.reason == "canary diverged"

    def test_unknown_error_shapes_land_on_the_base(self):
        err = tproto.typed_error(
            {"kind": "error", "error": "TypeError: row 3 is not an object"})
        assert isinstance(err, tproto.ServeRequestError)
        assert not isinstance(err, tproto.ShedError)
        assert "row 3" in err.message

    def test_wire_encoders_equal_the_jax_packages(self):
        """Every server message the port builds is the JAX package's
        byte for byte, and the endpoint grammar parses alike."""
        pairs = [
            (tproto.hello("m", ["fixed", "per-user"], 3),
             jproto.hello("m", ["fixed", "per-user"], 3)),
            (tproto.scores_response("r", [0.5, -1.25], ["a", "b"], "t1"),
             jproto.scores_response("r", [0.5, -1.25], ["a", "b"], "t1")),
            (tproto.error_response("r", "shed:closed"),
             jproto.error_response("r", "shed:closed")),
            (tproto.swap_response("r", "refused", 1, "m", reason="x",
                                  canary={"batches": 0}),
             jproto.swap_response("r", "refused", 1, "m", reason="x",
                                  canary={"batches": 0}))]
        for ours, theirs in pairs:
            assert tproto.encode(ours) == jproto.encode(theirs)
        for ep in ("127.0.0.1:7", "unix:/tmp/s.sock", "unix:///tmp/s",
                   "tcp://h:9", "file:/x", "/bare/path"):
            assert tproto.parse_endpoint(ep) == \
                jproto.parse_endpoint(ep), ep
        with pytest.raises(ValueError):
            tproto.parse_serve_endpoint("file:/x")


# ---------------------------------------------------------------------------
# ServingScorer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scorer_parts(tmp_path_factory):
    model_dir = _build_model_dir(str(tmp_path_factory.mktemp("scorer")))
    model, imaps = load_scoring_model(model_dir, None)
    return model_dir, materialize_model(model), imaps, _make_records()


def _scorer(model, imaps, **kw):
    return ServingScorer(model, SECTIONS, imaps,
                         registry=kw.pop("registry", MetricsRegistry()),
                         device=CPU, **kw)


class TestServingScorer:
    def test_equals_the_batch_core_bit_for_bit(self, scorer_parts):
        _, model, imaps, records = scorer_parts
        # a 2-row device budget forces promotion/eviction churn on every
        # batch: the tiers must never change a row's bits
        scorer = _scorer(model, imaps, hbm_budget_bytes=2 * 4 * 4)
        data = game_dataset_from_records(
            records, SECTIONS, imaps, id_types=("userId",),
            response_required=False)
        batch = score_game_dataset(model, data, device=CPU)
        first, uids = scorer.score_records(records)
        np.testing.assert_array_equal(first, batch.astype(np.float64))
        assert list(uids) == [r["uid"] for r in records]
        again, _ = scorer.score_records(records)
        np.testing.assert_array_equal(first, again)

    @pytest.mark.parametrize("data_dtype", [np.float64, np.float32])
    def test_device_row_dot_equals_the_host_form(self, data_dtype):
        """The serving row dot (products laid out by their place in the
        row, summed place after place) equals the scoring driver's host
        form bit for bit: rows of 0-40 entries in unsorted column order,
        values over six decades, so that another order of the adds would
        show in the last bits."""
        import scipy.sparse as sp

        from photon_ml_tpu_torch.game.models import (
            rowwise_sparse_dot_gathered,
            rowwise_sparse_dot_on_device,
        )

        rng = np.random.default_rng(12)
        n, d, e = 64, 200, 9
        counts = rng.integers(0, 41, size=n)
        counts[[3, 17]] = 0
        indptr = np.concatenate([[0], np.cumsum(counts)])
        indices = np.concatenate([rng.permutation(d)[:c] for c in counts])
        data = (rng.normal(size=indptr[-1])
                * 10.0 ** rng.uniform(-3, 3, indptr[-1])).astype(data_dtype)
        mat = sp.csr_matrix((data, indices, indptr), shape=(n, d))
        table = (rng.normal(size=(e, d))
                 * 10.0 ** rng.uniform(-3, 3, (e, d))).astype(np.float32)
        local = rng.integers(0, e, size=n)
        want = torch.as_tensor(rowwise_sparse_dot_gathered(mat, table, local),
                               dtype=torch.float32)
        got = rowwise_sparse_dot_on_device(mat, torch.from_numpy(table),
                                           local)
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
        # the data tells orders apart: a tree sum of the laid-out
        # products (torch's sum) differs from the host form's adds
        prod = mat.data * table[np.repeat(local, counts), mat.indices]
        laid = np.zeros((n, counts.max()), prod.dtype)
        laid[np.repeat(np.arange(n), counts),
             np.arange(mat.nnz) - np.repeat(indptr[:-1], counts)] = prod
        host = sp.csr_matrix((prod, mat.indices, indptr), shape=(n, d)) \
            @ np.ones(d, prod.dtype)
        assert not np.array_equal(torch.from_numpy(laid).sum(-1).numpy(),
                                  host)

    def test_chunk_boundaries_cannot_change_row_bits(self, scorer_parts):
        _, model, imaps, records = scorer_parts
        scorer = _scorer(model, imaps)
        full, _ = scorer.score_records(records)
        for k in (1, 3, 5, len(records)):
            part, _ = scorer.score_records(records[:k])
            np.testing.assert_array_equal(part, full[:k])

    def test_above_batch_cap_chunks_internally(self, scorer_parts):
        _, model, imaps, records = scorer_parts
        chunked, _ = _scorer(model, imaps,
                             max_batch_rows=8).score_records(records)
        whole, _ = _scorer(model, imaps).score_records(records)
        np.testing.assert_array_equal(chunked, whole)

    @pytest.mark.parametrize("tier", ["f32", "bf16"])
    def test_scores_match_the_jax_scorer(self, scorer_parts, tier):
        """The JAX package's ``ServingScorer`` over the same model
        directory and rows (x64 off, as in production), both with a
        churning 3-entity device tier: rel 1e-6. With the bf16 tier both
        round the same coefficients to bf16, so the bound holds there
        too; against the exact f32 scores the bf16 tier moves a score by
        at most 2^-8 of its terms' magnitudes."""
        import jax

        model_dir, model, imaps, records = scorer_parts
        budget = 3 * 4 * (4 if tier == "f32" else 2)
        with jax.enable_x64(False):
            jmodel, jmaps = jax_load(model_dir, None, materialize=True)
            want, juids = JaxScorer(
                jmodel, SECTIONS, jmaps, hbm_budget_bytes=budget,
                tier_dtype=tier, registry=JaxRegistry()).score_records(
                    records)
        got, uids = _scorer(model, imaps, hbm_budget_bytes=budget,
                            tier_dtype=tier).score_records(records)
        assert list(uids) == list(juids)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        if tier == "bf16":
            exact, _ = _scorer(model, imaps).score_records(records)
            data = game_dataset_from_records(
                records, SECTIONS, imaps, id_types=("userId",),
                response_required=False)
            re = model.models["per-user"]
            mag = np.asarray(abs(data.feature_shards["user"]) @ np.abs(
                re.coefficients.numpy()).T)
            rows = np.asarray(re.entity_ids).tolist()
            users = [rows.index(r["metadataMap"]["userId"])
                     for r in records]
            bound = BF16_REL * mag[np.arange(len(records)), users] + 1e-5
            assert np.all(np.abs(got - exact) <= bound)
            assert not np.array_equal(got, exact)

    def test_scorer_stats_and_release(self, scorer_parts):
        _, model, imaps, records = scorer_parts
        reg = MetricsRegistry()
        scorer = _scorer(model, imaps, registry=reg)
        scorer.score_records(records)
        stats = scorer.stats()
        assert stats["tiers"][0]["coordinate"] == "per-user"
        assert sum(stats["tier_hits"].values()) == len(records)
        assert reg.counter("serve_rows_scored").total() == len(records)
        scorer.release_device()
        assert scorer.stats()["tiers"][0]["released"]


# ---------------------------------------------------------------------------
# GenerationStore
# ---------------------------------------------------------------------------


class _FakeScorer:
    def __init__(self):
        self.generation = 0

    def release_device(self):
        pass


class TestGenerationStore:
    def test_pin_at_admission_survives_the_flip(self):
        reg = MetricsRegistry()
        f1, f2 = _FakeScorer(), _FakeScorer()
        store = GenerationStore(f1, "boot", registry=reg)
        old_pin = store.pin()
        assert old_pin == 1
        assert store.activate(f2, "cand") == 2
        assert store.pin() == 2
        assert store.scorer(old_pin) is f1 and store.scorer() is f2
        assert store.model_id() == "cand" and f2.generation == 2
        assert reg.gauge("serve_generation").value() == 2

    def test_reap_waits_for_the_last_pin_and_keeps_the_retained(self):
        f1, f2 = _FakeScorer(), _FakeScorer()
        store = GenerationStore(f1, "boot", registry=MetricsRegistry())
        pin = store.pin()
        store.activate(f2, "cand")
        assert store.reap() == []
        store.unpin(pin)
        assert store.reap() == [f1]
        assert store.stats()["retained_generation"] == 1
        store.release_previous()
        assert store.reap() == []
        assert 1 not in store.stats()["pins"]

    def test_rollback_reactivates_and_never_reuses_numbers(self):
        reg = MetricsRegistry()
        f1, f2, f3 = _FakeScorer(), _FakeScorer(), _FakeScorer()
        store = GenerationStore(f1, "boot", registry=reg)
        store.activate(f2, "cand")
        assert store.rollback() == 1
        assert store.generation == 1 and store.model_id() == "boot"
        assert reg.gauge("serve_generation").value() == 1
        assert store.reap() == [f2]
        assert store.activate(f3, "cand2") == 3


# ---------------------------------------------------------------------------
# The service in process: hot-swap, canary, probation
# ---------------------------------------------------------------------------


class _StopFlag:
    def __init__(self):
        self.reason = None

    def should_stop(self):
        return self.reason


def _swap_parts(root: str, **service_kw):
    """A port service with swap support on a unix socket (loader and
    make_scorer as ``service.main`` builds them), the boot and candidate
    model dirs and their reference scorers."""
    boot_dir = _build_model_dir(os.path.join(root, "boot"))
    cand_dir = _build_model_dir(os.path.join(root, "cand"), seed=11)
    reg = MetricsRegistry()

    def loader(model_dir):
        model, maps = load_scoring_model(model_dir, None)
        return materialize_model(model), maps

    def make_scorer(model, index_maps, generation=1):
        scorer = ServingScorer(model, SECTIONS, index_maps, registry=reg,
                               device=CPU)
        scorer.generation = generation
        return scorer

    model, imaps = loader(boot_dir)
    service = ServeService(
        make_scorer(model, imaps), MicroBatcher(100000, 64, registry=reg),
        "unix:" + os.path.join(root, "serve.sock"), model_id="boot-model",
        registry=reg, loader=loader, make_scorer=make_scorer, **service_kw)
    return {"service": service, "registry": reg, "candidate_dir": cand_dir,
            "ref_boot": make_scorer(model, imaps),
            "ref_candidate": make_scorer(*loader(cand_dir))}


def _run_service(parts):
    service = parts["service"]
    stop = _StopFlag()
    service.start()
    t = threading.Thread(target=service.serve_loop, args=(stop,),
                         daemon=True)
    t.start()

    def finish():
        stop.reason = "test done"
        t.join(timeout=60)
        service.shutdown()
        assert not t.is_alive(), "serve_loop failed to drain"

    return finish


_OPEN_GATE = dict(canary_threshold_pct=1e9, probation_secs=0.2)
_TIGHT_GATE = dict(canary_threshold_pct=5.0, canary_min_delta=1e-4,
                   probation_secs=0.2)


class TestHotSwapInProcess:
    def test_swap_flips_generation_and_scores_the_candidate(self,
                                                            tmp_path):
        parts = _swap_parts(str(tmp_path), **_OPEN_GATE)
        records = _make_records()
        ref_cand, _ = parts["ref_candidate"].score_records(records)
        finish = _run_service(parts)
        try:
            with ServeClient(parts["service"].endpoint) as client:
                assert client.generation == 1
                client.score(records)
                result = client.swap(parts["candidate_dir"],
                                     model_id="retrained")
                assert result["outcome"] == "ok", result
                assert result["generation"] == 2
                assert result["model_id"] == "retrained"
                assert result["canary"]["violations"] == []
                after = client.score(records)
                np.testing.assert_array_equal(np.asarray(after["scores"]),
                                              ref_cand)
                stats = client.stats()
                assert stats["generation"] == 2
                assert stats["last_swap"]["outcome"] == "ok"
                assert stats["stage_ms"]["device_score"]["count"] >= 2
                client.reconnect()
                assert client.generation == 2 and client.generation_changed
        finally:
            finish()

    def test_unreadable_candidate_refused_and_still_serving(self,
                                                            tmp_path):
        parts = _swap_parts(str(tmp_path), **_OPEN_GATE)
        records = _make_records()
        ref_boot, _ = parts["ref_boot"].score_records(records)
        finish = _run_service(parts)
        try:
            with ServeClient(parts["service"].endpoint) as client:
                result = client.swap(str(tmp_path / "no_such_model"))
                assert result["outcome"] == "refused", result
                assert result["error"].startswith("ModelSwapRefusedError")
                assert result["generation"] == 1
                resp = client.score(records)
                np.testing.assert_array_equal(np.asarray(resp["scores"]),
                                              ref_boot)
                assert client.stats()["last_swap"]["outcome"] == "refused"
        finally:
            finish()

    def test_canary_violation_never_flips(self, tmp_path):
        parts = _swap_parts(str(tmp_path), **_TIGHT_GATE)
        records = _make_records()
        ref_boot, _ = parts["ref_boot"].score_records(records)
        finish = _run_service(parts)
        try:
            with ServeClient(parts["service"].endpoint) as client:
                client.score(records)
                result = client.swap(parts["candidate_dir"])
                assert result["outcome"] == "refused", result
                assert "canary" in result["reason"]
                assert result["canary"]["checked_rows"] > 0
                assert client.stats()["generation"] == 1
                resp = client.score(records)
                np.testing.assert_array_equal(np.asarray(resp["scores"]),
                                              ref_boot)
        finally:
            finish()

    def test_concurrent_submits_partition_strictly_by_generation(
            self, tmp_path):
        parts = _swap_parts(str(tmp_path), **_OPEN_GATE)
        records = _make_records()
        ref_boot, _ = parts["ref_boot"].score_records(records)
        ref_cand, _ = parts["ref_candidate"].score_records(records)
        assert not np.array_equal(ref_boot, ref_cand)
        finish = _run_service(parts)
        swap_done = threading.Event()
        responses: list = []
        failures: list = []

        def client_loop():
            out = []
            try:
                with ServeClient(parts["service"].endpoint) as client:
                    tail = 2
                    while tail:
                        if swap_done.is_set():
                            tail -= 1
                        resp = client.score(records)
                        if resp.get("kind") != "scores":
                            failures.append(f"non-score reply: {resp}")
                            return
                        out.append(np.asarray(resp["scores"]))
            except Exception as e:  # noqa: BLE001
                failures.append(f"client error: {e!r}")
            responses.extend(out)

        threads = [threading.Thread(target=client_loop) for _ in range(3)]
        try:
            for t in threads:
                t.start()
            time.sleep(0.3)
            with ServeClient(parts["service"].endpoint) as client:
                assert client.swap(parts["candidate_dir"])["outcome"] == "ok"
            swap_done.set()
            for t in threads:
                t.join(timeout=60)
        finally:
            swap_done.set()
            finish()
        assert not failures, failures[:5]
        kinds = [0 if np.array_equal(s, ref_boot)
                 else 1 if np.array_equal(s, ref_cand) else -1
                 for s in responses]
        assert -1 not in kinds, "a response mixes generations"
        assert 0 in kinds and 1 in kinds

    def test_jax_client_gets_the_jax_packages_bytes(self, tmp_path):
        """The JAX package's ``ServeClient`` speaks to the port's service;
        the raw lines of the hello, a score reply, an error reply and a
        ping are what the JAX package's encoders make of their content,
        byte for byte."""
        parts = _swap_parts(str(tmp_path), **_OPEN_GATE)
        records = _make_records(n=5)
        ref, _ = parts["ref_boot"].score_records(records)
        finish = _run_service(parts)
        try:
            with jproto.ServeClient(parts["service"].endpoint) as client:
                assert client.hello["model_id"] == "boot-model"
                resp = client.score(records, request_id="q1")
                assert resp["scores"] == [float(s) for s in ref]
                assert client.ping() == {"kind": "pong", "proto": 1}
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.connect(parts["service"].endpoint[len("unix:"):])
            f = sock.makefile("rb")
            assert f.readline() == jproto.encode(jproto.hello(
                "boot-model", ["fixed", "per-user"], 1))
            sock.sendall(jproto.encode({"kind": "score", "id": "q2",
                                        "rows": records}))
            assert f.readline() == jproto.encode(jproto.scores_response(
                "q2", ref, [r["uid"] for r in records]))
            sock.sendall(jproto.encode({"kind": "bogus", "id": 7}))
            assert f.readline() == jproto.encode(jproto.error_response(
                7, "unknown kind 'bogus'"))
            sock.sendall(b"{not json\n")
            line = json.loads(f.readline())
            assert line["kind"] == "error" and line["id"] is None
            assert line["error"].startswith("bad json")
            f.close()
            sock.close()
        finally:
            finish()


class TestProbationRollback:
    def _flipped_service(self, tmp_path, **kw):
        parts = _swap_parts(str(tmp_path), **kw)
        service, reg = parts["service"], parts["registry"]
        service.gens.activate(parts["ref_candidate"], "cand")
        service._probation = {
            "until": time.monotonic() + 300.0, "from_generation": 1,
            "p99_baseline_ms": 5.0,
            "shed_baseline": reg.counter("serve_shed").total()}
        return parts

    def test_p99_regression_rolls_back(self, tmp_path):
        parts = self._flipped_service(tmp_path, probation_secs=300.0,
                                      probation_p99_pct=50.0,
                                      probation_p99_min_ms=1.0)
        service, reg = parts["service"], parts["registry"]
        try:
            reg.gauge("serve_p99_ms").set(100.0)
            service._check_probation()
            assert service.gens.generation == 1
            assert service.last_swap["outcome"] == "rolled_back"
            assert "p99" in service.last_swap["reason"]
            assert reg.counter("serve_swap").value(
                outcome="rolled_back") == 1
        finally:
            service.shutdown()

    def test_shed_budget_rolls_back(self, tmp_path):
        parts = self._flipped_service(tmp_path, probation_max_sheds=0)
        service, reg = parts["service"], parts["registry"]
        try:
            reg.counter("serve_shed").inc(reason="queue_full")
            service._check_probation()
            assert service.gens.generation == 1
            assert "shed" in service.last_swap["reason"]
        finally:
            service.shutdown()

    def test_quiet_probation_releases_the_previous_generation(self,
                                                              tmp_path):
        parts = self._flipped_service(tmp_path)
        service = parts["service"]
        try:
            service._probation["until"] = time.monotonic() - 1.0
            service._check_probation()
            assert service.gens.generation == 2
            assert service._probation is None
            assert service.gens.stats()["retained_generation"] is None
        finally:
            service.shutdown()


# ---------------------------------------------------------------------------
# End to end: the service as a process
# ---------------------------------------------------------------------------


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PHOTON_FAULTS")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_service_process_answers_like_the_scoring_driver(tmp_path):
    """``python -m photon_ml_tpu_torch.serve.service --device cpu``: the
    ready line, concurrent clients' scores equal by uid, bit for bit, to
    the port's scoring driver run as a process over the same rows (a
    2-row device budget keeps the tiers churning), the stats verb of the
    launcher, then SIGTERM → drain → exit 75 with no traceback."""
    model_dir = _build_model_dir(str(tmp_path))
    records = _make_records()
    avro = str(tmp_path / "in.avro")
    write_container(avro, GAME_SCHEMA, records)
    out = str(tmp_path / "scores_out")
    sock = str(tmp_path / "serve.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.serve.service",
         "--game-model-input-dir", model_dir, "--listen", "unix:" + sock,
         "--feature-shard-id-to-feature-section-keys-map", SECTIONS_FLAG,
         "--random-effect-id-set", "userId", "--max-batch-rows", "16",
         "--serve-hbm-budget-mb", str(2 * 4 * 4 / (1 << 20)),
         "--device", "cpu"],
        cwd=REPO, env=_env(), text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        driver = subprocess.run(
            [sys.executable, "-m",
             "photon_ml_tpu_torch.cli.game_scoring_driver",
             "--input-data-dirs", avro, "--game-model-input-dir",
             model_dir, "--output-dir", out,
             "--feature-shard-id-to-feature-section-keys-map",
             SECTIONS_FLAG, "--random-effect-id-set", "userId",
             "--device", "cpu"],
            cwd=REPO, env=_env(), capture_output=True, text=True,
            timeout=300)
        assert driver.returncode == 0, driver.stderr[-3000:]
        batch = {r["uid"]: r["predictionScore"]
                 for part in glob.glob(os.path.join(out, "scores",
                                                    "*.avro"))
                 for r in load_scored_items(part)}
        assert len(batch) == len(records)
        line = proc.stdout.readline().strip()
        assert line == f"PHOTON_SERVE ready endpoint=unix:{sock}", line
        endpoint = line.split("endpoint=", 1)[1]
        failures: list = []

        def client_loop(lo, hi):
            try:
                with ServeClient(endpoint) as client:
                    for _ in range(3):
                        resp = client.score(records[lo:hi])
                        for uid, s in zip(resp["uids"], resp["scores"]):
                            if batch[uid] != s:
                                failures.append(f"{uid}: {s!r} != "
                                                f"{batch[uid]!r}")
            except Exception as e:  # noqa: BLE001
                failures.append(f"client error: {e!r}")

        threads = [threading.Thread(target=client_loop, args=(lo, lo + 8))
                   for lo in (0, 8, 16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not failures, failures[:5]
        stats = subprocess.run(
            [sys.executable, "-m", "photon_ml_tpu_torch.tools.photon_serve",
             "stats", "--endpoint", endpoint], cwd=REPO, env=_env(),
            capture_output=True, text=True, timeout=120)
        assert stats.returncode == 0, stats.stderr[-2000:]
        stats = json.loads(stats.stdout)
        assert stats["generation"] == 1 and stats["p99_ms"] > 0
        assert stats["tier_hits"].get("host", 0) + stats["tier_hits"].get(
            "model", 0) > 0
        assert stats["stage_ms"]["tier_gather"]["count"] >= 9
    finally:
        proc.terminate()
        try:
            rc = proc.wait(timeout=90)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        _, err = proc.communicate()
    assert rc == PREEMPTED_EXIT, err[-2000:]
    assert "PHOTON_PREEMPTED" in err
    assert "Traceback (most recent call last)" not in err


def test_launcher_runs_the_fleet_verb(capsys):
    """The ``fleet`` verb is the port's fleet router (its help is the
    router's), which takes no ``--device``: the router touches none. The
    router itself is exercised in ``tests/test_torch_fleet.py``."""
    from photon_ml_tpu_torch.tools import photon_serve

    with pytest.raises(SystemExit) as exc:
        photon_serve.main(["fleet", "--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "photon-serve fleet" in out and "--members" in out
    with pytest.raises(SystemExit) as exc:
        photon_serve.main(["fleet", "--members", "a,b", "--device", "cuda"])
    assert exc.value.code == 2
    # (argparse reads ``--device`` as a prefix of ``--device-telemetry``)
    assert "unrecognized arguments: cuda" in capsys.readouterr().err

"""PyTorch port vs the JAX package: validation metrics and evaluators.

Every metric of ``evaluation/metrics.py`` and every evaluator of
``evaluation/evaluators.py`` runs in f64 on the same numpy inputs in both
packages and agrees to rtol 1e-10 (atol 1e-12 for values near zero). The
inputs have tied scores (scores rounded to a few levels), weights, and for
the sharded AUC and precision@k an entity whose rows are all one class,
one entity with a single row and one id with no rows at all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.evaluation import evaluators as jev
from photon_ml_tpu.evaluation import metrics as jm
from photon_ml_tpu.ops.losses import get_loss as jloss
from photon_ml_tpu_torch.evaluation import evaluators as tev
from photon_ml_tpu_torch.evaluation import metrics as tm
from photon_ml_tpu_torch.ops.losses import get_loss as tloss

N, ENTITIES = 300, 12


def _inputs(seed=0, tied=True):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=N)
    if tied:
        scores = np.round(scores * 2) / 2  # a handful of tie groups
    labels = (rng.uniform(size=N) < 0.4).astype(np.float64)
    weights = rng.uniform(0.2, 3.0, size=N)
    ids = rng.integers(0, ENTITIES - 2, size=N)
    ids[7] = ENTITIES - 2  # one row; id ENTITIES - 1 has none
    labels[ids == 3] = 1.0  # entity 3: positives only
    return scores, labels, weights, ids


def _close(t, j):
    t = float(t)
    j = float(np.asarray(j))
    assert t == pytest.approx(j, rel=1e-10, abs=1e-12)


def _both(seed, tied):
    s, y, w, ids = _inputs(seed, tied)
    t = {k: torch.from_numpy(v) for k, v in
         dict(s=s, y=y, w=w, ids=ids).items()}
    j = {k: jnp.asarray(v) for k, v in dict(s=s, y=y, w=w, ids=ids).items()}
    return t, j


CASES = [(0, True), (1, True), (2, False)]


@pytest.mark.parametrize("seed,tied", CASES)
@pytest.mark.parametrize("name", [
    "mean_absolute_error", "mean_squared_error", "root_mean_squared_error",
    "area_under_roc_curve", "area_under_pr_curve", "peak_f1",
    "logistic_log_likelihood", "poisson_log_likelihood",
    "linear_log_likelihood"])
@pytest.mark.parametrize("weighted", [True, False])
def test_metric_matches_jax(seed, tied, name, weighted):
    t, j = _both(seed, tied)
    tw, jw = (t["w"], j["w"]) if weighted else (None, None)
    y_t, y_j = t["y"], j["y"]
    if name == "poisson_log_likelihood":  # counts as labels
        y_t, y_j = t["y"] * 3, j["y"] * 3
    _close(getattr(tm, name)(y_t, t["s"], tw),
           getattr(jm, name)(y_j, j["s"], jw))


@pytest.mark.parametrize("loss", ["logistic", "poisson", "squared",
                                  "smoothed_hinge"])
def test_mean_loss_matches_jax(loss):
    t, j = _both(0, True)
    _close(tm.mean_loss(tloss(loss), t["y"], t["s"], t["w"]),
           jm.mean_loss(jloss(loss), j["y"], j["s"], j["w"]))


@pytest.mark.parametrize("k", [1, 5, 300])
def test_precision_at_k_matches_jax(k):
    t, j = _both(0, True)
    _close(tm.precision_at_k(t["y"], t["s"], k),
           jm.precision_at_k(j["y"], j["s"], k))
    valid = np.arange(N) % 3 != 0
    _close(tm.precision_at_k(t["y"], t["s"], k, torch.from_numpy(valid)),
           jm.precision_at_k(j["y"], j["s"], k, jnp.asarray(valid)))


def test_akaike_information_criterion():
    _close(tm.akaike_information_criterion(torch.tensor(-12.5), 4),
           jm.akaike_information_criterion(jnp.asarray(-12.5), 4))


def test_auc_single_class_is_neutral():
    s = torch.tensor([0.1, 0.4, 0.4])
    assert float(tm.area_under_roc_curve(torch.ones(3), s)) == 0.5


@pytest.mark.parametrize("seed,tied", CASES)
def test_segment_auc_stats_match_jax(seed, tied):
    t, j = _both(seed, tied)
    tout = tm.segment_auc_stats(t["y"], t["s"], t["w"], t["ids"], ENTITIES)
    jout = jm.segment_auc_stats(j["y"], j["s"], j["w"], j["ids"], ENTITIES)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)


SPECS = ["AUC", "RMSE", "LOGISTIC_LOSS", "POISSON_LOSS", "SQUARED_LOSS",
         "SMOOTHED_HINGE_LOSS", "AUC:userId", "precision@1:userId",
         "precision@3:userId", "precision@50:userId"]


@pytest.mark.parametrize("seed,tied", CASES)
@pytest.mark.parametrize("weighted", [True, False])
def test_evaluate_many_matches_jax(seed, tied, weighted):
    t, j = _both(seed, tied)
    tspecs = [tev.EvaluatorSpec.parse(s) for s in SPECS]
    jspecs = [jev.EvaluatorSpec.parse(s) for s in SPECS]
    assert [s.name for s in tspecs] == [s.name for s in jspecs]
    id_cols = {"userId": t["ids"].numpy()}
    vocabs = {"userId": np.arange(ENTITIES)}
    tids, tnum = tev.resolve_entity_ids(tspecs, id_cols, vocabs, "cpu")
    jids, jnum = jev.resolve_entity_ids(jspecs, id_cols, vocabs)
    assert tnum == jnum == {"userId": ENTITIES}
    before = tev.EVAL_FETCHES["count"]
    tvals = tev.evaluate_many(tspecs, t["s"], t["y"],
                              t["w"] if weighted else None, tids, tnum)
    assert tev.EVAL_FETCHES["count"] == before + 1  # one fetch for all
    jvals = jev.evaluate_many(jspecs, j["s"], j["y"],
                              j["w"] if weighted else None, jids, jnum)
    assert list(tvals) == list(jvals)
    for name in tvals:
        _close(tvals[name], jvals[name])


def test_sharded_metrics_skip_single_class_and_empty_entities():
    t, _ = _both(0, True)
    # entity 3 is positives only: its AUC is left out of the mean
    ids = t["ids"]
    num, pos, neg = tm.segment_auc_stats(t["y"], t["s"], None, ids,
                                         ENTITIES)
    assert float(neg[3]) == 0.0 and float(pos[ENTITIES - 1]) == 0.0
    valid = (pos * neg) > 0
    expect = float((num[valid] / (pos * neg)[valid]).mean())
    _close(tev.sharded_auc(t["y"], t["s"], ids, ENTITIES), expect)


@pytest.mark.parametrize("text,kind,id_type,k,larger", [
    ("AUC", "AUC", None, 1, True),
    ("logistic_loss", "LOGISTIC_LOSS", None, 1, False),
    ("RMSE", "RMSE", None, 1, False),
    ("AUC:userId", "SHARDED_AUC", "userId", 1, True),
    ("precision@5:songId", "SHARDED_PRECISION_AT_K", "songId", 5, True),
])
def test_evaluator_spec_parse(text, kind, id_type, k, larger):
    spec = tev.EvaluatorSpec.parse(text)
    jspec = jev.EvaluatorSpec.parse(text)
    assert spec.evaluator_type.value == jspec.evaluator_type.value == kind
    assert (spec.id_type, spec.k, spec.name) == (jspec.id_type, jspec.k,
                                                 jspec.name)
    assert spec.id_type == id_type and spec.k == k
    assert spec.better_than(1.0, 0.0) is larger


@pytest.mark.parametrize("bad", ["precision@5", "RMSE:userId", "AUC:",
                                 "NOPE"])
def test_evaluator_spec_parse_refuses(bad):
    with pytest.raises(ValueError):
        tev.EvaluatorSpec.parse(bad)

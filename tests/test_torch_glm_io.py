"""PyTorch port vs the JAX package: the single-GLM path's data, summary,
evaluation and model-file modules.

The same numpy inputs, made from seeds, go through both packages:

- ``summarize``: a sparse matrix gives the JAX summary exactly (the same
  numpy bincount form); a dense one, reduced in f32 on the device, agrees
  to rtol 1e-5, and with the sparse form of the same matrix;
- ``sanity_check_data`` for every task and validation type: the same
  verdicts and the same log lines;
- ``NormalizationContext.build`` for every type: the same f32 factors and
  shifts, bit for bit, and the same back-transformed coefficients;
- ``parse_constraint_map``: the same maps and the same refusals;
- ``load_labeled_points_avro``: the native columnar path, the records
  loop and the JAX loader give the same matrices, labels, offsets,
  weights and index maps (a multi-part directory, selected features, a
  given index map, the response-prediction field names, no intercept),
  and ``INGEST_STATS`` counts each path's parts;
- ``load_libsvm``: the native parser, the Python loop and the JAX loader
  agree (1- and 0-based, intercept on and off, raw labels, a part
  directory with a ``_SUCCESS`` marker, an index out of range refused);
  custom delimiters take the Python loop;
- ``libsvm_to_avro``: the same records as the JAX converter;
- TSV models: each package reads the other's files;
- ``evaluate_model_grid`` for every task to rtol 1e-5 of the JAX grid
  (f32 batches), ``evaluate_model`` to rel 1e-6 of the grid, and
  ``select_best_model`` on the same maps.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.cli import libsvm_to_avro as jconvert
from photon_ml_tpu.data import validators as jval
from photon_ml_tpu.data.batch import dense_batch as jdense
from photon_ml_tpu.evaluation import model_evaluation as jeval
from photon_ml_tpu.io import data_format as jdf
from photon_ml_tpu.io import model_io as jmio
from photon_ml_tpu.io.index_map import IndexMap as JIndexMap
from photon_ml_tpu.models.glm import Coefficients as JCoef
from photon_ml_tpu.models.glm import GeneralizedLinearModel as JGLM
from photon_ml_tpu.ops import normalization as jnorm
from photon_ml_tpu.optimize import config as jcfg
from photon_ml_tpu.stat import summary as jsum
from photon_ml_tpu_torch.cli import libsvm_to_avro as tconvert
from photon_ml_tpu_torch.data import validators as tval
from photon_ml_tpu_torch.data.batch import dense_batch as tdense
from photon_ml_tpu_torch.evaluation import model_evaluation as teval
from photon_ml_tpu_torch.io import data_format as tdf
from photon_ml_tpu_torch.io import model_io as tmio
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro import read_records, write_container
from photon_ml_tpu_torch.io.index_map import IndexMap as TIndexMap
from photon_ml_tpu_torch.io.index_map import feature_key
from photon_ml_tpu_torch.models.glm import Coefficients as TCoef
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel as TGLM
from photon_ml_tpu_torch.ops import normalization as tnorm
from photon_ml_tpu_torch.optimize import config as tcfg
from photon_ml_tpu_torch.stat import summary as tsum

torch.set_num_threads(1)
TASKS = [t.name for t in tcfg.TaskType]


def _sparse(seed=0, n=200, d=9, density=0.3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * (rng.random((n, d)) < density)
    X[:, 3] = 0.0  # an all-zero column
    X[:, 4] = np.abs(X[:, 4]) + 1.0  # a strictly positive one
    return X


# --- summary -----------------------------------------------------------


def test_summarize_sparse_equals_jax():
    X = _sparse()
    csr = sp.csr_matrix(X)
    j, t = jsum.summarize(csr), tsum.summarize(csr)
    for f in ("mean", "variance", "num_nonzeros", "max", "min", "norm_l1",
              "norm_l2", "mean_abs", "max_magnitude"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    assert t.count == j.count == 200


def test_summarize_dense_on_device_matches():
    X = _sparse(seed=1)
    j = jsum.summarize(X)
    t = tsum.summarize(X, device="cpu")
    ts = tsum.summarize(sp.csr_matrix(X))
    for f in ("mean", "variance", "num_nonzeros", "max", "min", "norm_l1",
              "norm_l2", "mean_abs"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
        np.testing.assert_allclose(getattr(t, f), getattr(ts, f),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    # a tensor stays on its device and a one-row input has zero variance
    one = tsum.summarize(torch.ones(1, 3))
    assert one.count == 1 and not one.variance.any()


# --- validators --------------------------------------------------------


@pytest.mark.parametrize("vtype", ["VALIDATE_FULL", "VALIDATE_SAMPLE",
                                   "VALIDATE_DISABLED"])
@pytest.mark.parametrize("task", TASKS)
def test_sanity_check_data(task, vtype):
    rng = np.random.default_rng(2)
    n = 400
    labels = rng.integers(0, 2, size=n).astype(float)
    offsets = rng.normal(size=n)
    X = sp.csr_matrix(_sparse(seed=2, n=n))
    bad_labels, bad_offsets = labels.copy(), offsets.copy()
    bad_labels[[3, 50, 380]] = [2.0, -1.0, np.nan]
    bad_offsets[7] = np.inf
    Xb = X.copy()
    Xb.data[5] = np.nan
    for args in ((labels, offsets, X), (bad_labels, offsets, X),
                 (labels, bad_offsets, Xb), (labels, None, X.toarray())):
        jlog, tlog = [], []
        jv = jval.sanity_check_data(*args, jcfg.TaskType[task],
                                    jval.DataValidationType[vtype],
                                    logger=jlog.append)
        tv = tval.sanity_check_data(*args, tcfg.TaskType[task],
                                    tval.DataValidationType[vtype],
                                    logger=tlog.append)
        assert tv == jv and tlog == jlog


# --- normalization ------------------------------------------------------


@pytest.mark.parametrize("ntype", [t.name for t in tnorm.NormalizationType])
def test_normalization_build(ntype):
    X = _sparse(seed=3)
    X[:, -1] = 1.0  # the intercept
    summary = jsum.summarize(sp.csr_matrix(X))
    j = jnorm.NormalizationContext.build(jnorm.NormalizationType[ntype],
                                         summary, intercept_index=8)
    t = tnorm.NormalizationContext.build(tnorm.NormalizationType[ntype],
                                         summary, intercept_index=8,
                                         device="cpu")
    assert t.intercept_index == j.intercept_index == 8
    for f in ("factors", "shifts"):
        a, b = getattr(j, f), getattr(t, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    coef = np.random.default_rng(4).normal(size=9).astype(np.float32)
    np.testing.assert_allclose(
        t.transform_model_coefficients(torch.tensor(coef)).numpy(),
        np.asarray(j.transform_model_coefficients(jnp.asarray(coef))),
        rtol=1e-6, atol=1e-6)
    assert tnorm.NormalizationContext.identity().is_identity


# --- constraint map -----------------------------------------------------


def _maps(keys):
    d = {k: i for i, k in enumerate(keys)}
    return JIndexMap(d), TIndexMap(d)


KEYS = [feature_key("a", "x"), feature_key("a", "y"), feature_key("b"),
        "(INTERCEPT)\x01"]


@pytest.mark.parametrize("spec", [
    None, "",
    [{"name": "a", "term": "x", "lowerBound": -1, "upperBound": 1}],
    [{"name": "a", "term": "*", "upperBound": 0.5},
     {"name": "b", "term": "", "lowerBound": 0}],
    [{"name": "*", "term": "*", "lowerBound": -2, "upperBound": 2}],
    [{"name": "zzz", "term": "", "lowerBound": 0}],
    # refused: wildcard name with a term, (*, *) not alone, lo >= hi,
    # no finite bound, conflicting bounds
    [{"name": "*", "term": "x", "lowerBound": 0}],
    [{"name": "b", "term": "", "lowerBound": 0},
     {"name": "*", "term": "*", "lowerBound": 0}],
    [{"name": "b", "term": "", "lowerBound": 1, "upperBound": 1}],
    [{"name": "b", "term": ""}],
    [{"name": "a", "term": "*", "upperBound": 1},
     {"name": "a", "term": "x", "upperBound": 2}],
])
def test_parse_constraint_map(spec):
    jm, tm = _maps(KEYS)
    s = spec if spec is None or isinstance(spec, str) else json.dumps(spec)
    try:
        want = jdf.parse_constraint_map(s, jm)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tdf.parse_constraint_map(s, tm)
        assert str(got.value) == str(e)
        return
    assert tdf.parse_constraint_map(s, tm) == want


# --- legacy Avro loader -------------------------------------------------


def _write_parts(directory, response="label", parts=3, rows=40, seed=5):
    os.makedirs(directory, exist_ok=True)
    schema = (schemas.TRAINING_EXAMPLE if response == "label"
              else schemas.RESPONSE_PREDICTION)
    rng = np.random.default_rng(seed)
    for p in range(parts):
        recs = []
        for i in range(rows):
            feats = [{"name": f"n{j % 4}", "term": f"t{j}",
                      "value": float(rng.normal())}
                     for j in rng.choice(12, size=rng.integers(0, 6),
                                         replace=False)]
            recs.append({"uid": f"{p}-{i}",
                         response: float(rng.integers(0, 2)),
                         "features": feats, "metadataMap": None,
                         "weight": (None if i % 3 else
                                    float(rng.uniform(0.5, 2))),
                         "offset": None if i % 4 else float(rng.normal())})
        write_container(os.path.join(directory, f"part-{p:05d}.avro"),
                        schema, recs)
    return directory


def _same_labeled(j, t):
    assert (t.features != j.features).nnz == 0
    assert t.features.shape == j.features.shape
    for f in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    assert dict(t.index_map.items()) == dict(j.index_map.items())


@pytest.mark.parametrize("variant", ["default", "selected", "given_map",
                                     "response", "no_intercept"])
def test_load_labeled_points_avro_three_ways(tmp_path, monkeypatch,
                                             variant):
    response = "response" if variant == "response" else "label"
    d = _write_parts(str(tmp_path / "parts"), response=response)
    kw = {"add_intercept": variant != "no_intercept"}
    jfn = (jdf.RESPONSE_PREDICTION_FIELD_NAMES if variant == "response"
           else jdf.TRAINING_EXAMPLE_FIELD_NAMES)
    tfn = (tdf.RESPONSE_PREDICTION_FIELD_NAMES if variant == "response"
           else tdf.TRAINING_EXAMPLE_FIELD_NAMES)
    if variant == "selected":
        sel = str(tmp_path / "selected.avro")
        write_container(sel, schemas.FEATURE, [
            {"name": "n1", "term": f"t{j}", "value": 0.0}
            for j in (1, 5, 9)] + [{"name": "n2", "term": "t2",
                                    "value": 0.0}])
        kw["selected_features_file"] = sel
    jkw, tkw = dict(kw), dict(kw)
    if variant == "given_map":
        keys = [feature_key(f"n{j % 4}", f"t{j}") for j in range(0, 12, 2)]
        jkw["index_map"] = JIndexMap.from_keys(keys, add_intercept=True)
        tkw["index_map"] = TIndexMap.from_keys(keys, add_intercept=True)
    want = jdf.load_labeled_points_avro(d, jfn, **jkw)
    tdf.reset_ingest_stats()
    native = tdf.load_labeled_points_avro(d, tfn, **tkw)
    assert tdf.INGEST_STATS == {"native_parts": 3, "declined_parts": 0,
                                "records_parts": 0}
    _same_labeled(want, native)
    monkeypatch.setattr(tdf, "read_columnar", lambda path: None)
    tdf.reset_ingest_stats()
    records = tdf.load_labeled_points_avro(d, tfn, **tkw)
    assert tdf.INGEST_STATS == {"native_parts": 0, "declined_parts": 1,
                                "records_parts": 3}
    _same_labeled(want, records)


def test_duplicate_feature_refused_on_both_paths(tmp_path, monkeypatch):
    path = str(tmp_path / "dup.avro")
    write_container(path, schemas.TRAINING_EXAMPLE, [{
        "uid": "0", "label": 1.0, "metadataMap": None, "weight": None,
        "offset": None, "features": [{"name": "a", "term": "", "value": 1.0},
                                     {"name": "a", "term": "", "value": 2.0}]}])
    with pytest.raises(ValueError, match="Duplicate"):
        tdf.load_labeled_points_avro(path)
    monkeypatch.setattr(tdf, "read_columnar", lambda p: None)
    with pytest.raises(ValueError, match="Duplicate"):
        tdf.load_labeled_points_avro(path)


# --- LibSVM loader ------------------------------------------------------


def _write_libsvm(path, seed=6, n=60, d=10, zero_based=False, sep=" "):
    rng = np.random.default_rng(seed)
    lo = 0 if zero_based else 1
    with open(path, "w") as fh:
        for i in range(n):
            idx = sorted(rng.choice(d, size=rng.integers(0, 5),
                                    replace=False))
            feats = sep.join(f"{j + lo}:{rng.normal():.5f}" for j in idx)
            label = rng.choice([-1.0, 1.0, 0.0, 2.5])
            fh.write(f"{label:g}{sep}{feats}\n" if feats else f"{label:g}\n")


@pytest.mark.parametrize("zero_based", [False, True])
@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("binarize", [True, False])
def test_load_libsvm_three_ways(tmp_path, zero_based, intercept, binarize):
    d = str(tmp_path / "parts")
    os.makedirs(d)
    for p in range(2):
        _write_libsvm(os.path.join(d, f"part-{p}"), seed=p,
                      zero_based=zero_based)
    open(os.path.join(d, "_SUCCESS"), "w").close()
    kw = dict(use_intercept=intercept, zero_based=zero_based,
              binarize_labels=binarize)
    want = jdf.load_libsvm(d, 10, **kw)
    native = tdf.load_libsvm(d, 10, **kw)
    loop = tdf.libsvm_python(tdf._libsvm_paths(d), 10, **kw)
    for got in (native, loop):
        _same_labeled(want, got)
    assert native.num_samples == 120


def test_libsvm_out_of_range_and_custom_delimiter(tmp_path):
    path = str(tmp_path / "bad.libsvm")
    _write_libsvm(path, d=10)
    with pytest.raises(ValueError, match="out of range"):
        tdf.load_libsvm(path, 5)
    with pytest.raises(ValueError, match="out of range"):
        jdf.load_libsvm(path, 5)
    tab = str(tmp_path / "tab.libsvm")
    _write_libsvm(tab, seed=8, sep="\t")
    _same_labeled(jdf.load_libsvm(tab, 10, delim="\t"),
                  tdf.load_libsvm(tab, 10, delim="\t"))


def test_libsvm_to_avro_records_equal(tmp_path):
    src = str(tmp_path / "z.libsvm")
    _write_libsvm(src, seed=9, zero_based=True)
    outs = [str(tmp_path / f"{k}.avro") for k in ("j", "t")]
    flags = ["--input-path", src, "--feature-dimension", "10",
             "--zero-based", "true", "--binarize-labels", "false"]
    jconvert.main(flags + ["--output-path", outs[0]])
    tconvert.main(flags + ["--output-path", outs[1], "--device", "cpu"])
    assert read_records(outs[1]) == read_records(outs[0])


# --- TSV models ---------------------------------------------------------


def test_text_models_read_across_packages(tmp_path):
    keys = [feature_key("a", "x"), feature_key("b"), "(INTERCEPT)\x01"]
    jm, tm = _maps(keys)
    rng = np.random.default_rng(10)
    W = rng.normal(size=(2, 3)).astype(np.float32)
    task = "LOGISTIC_REGRESSION"
    jmio.write_models_text(str(tmp_path / "j"), [
        (lam, JGLM(JCoef(jnp.asarray(w)), jcfg.TaskType[task]))
        for lam, w in zip((10.0, 1.0), W)], jm)
    tmio.write_models_text(str(tmp_path / "t"), [
        (lam, TGLM(TCoef(torch.tensor(w)), tcfg.TaskType[task]))
        for lam, w in zip((10.0, 1.0), W)], tm)
    for name in ("part-00000.txt", "part-00001.txt"):
        assert open(tmp_path / "t" / name).read() == \
            open(tmp_path / "j" / name).read()
    for (lam_t, glm_t), (lam_j, glm_j) in zip(
            tmio.read_models_text(str(tmp_path / "j"), tm,
                                  tcfg.TaskType[task], device="cpu"),
            jmio.read_models_text(str(tmp_path / "t"), jm,
                                  jcfg.TaskType[task])):
        assert lam_t == lam_j
        np.testing.assert_array_equal(glm_t.coefficients.means.numpy(),
                                      np.asarray(glm_j.coefficients.means))
        assert glm_t.task.name == task


# --- evaluation ---------------------------------------------------------


def _eval_data(task, seed=11, n=500, d=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    z = X @ rng.normal(size=d) * 0.5
    if task == "LINEAR_REGRESSION":
        y = z + rng.normal(size=n)
    elif task == "POISSON_REGRESSION":
        y = rng.poisson(np.exp(np.clip(z, -3, 3))).astype(float)
    else:
        y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(float)
    off = rng.normal(size=n) * 0.1
    wt = rng.uniform(0.5, 1.5, size=n)
    W = (rng.normal(size=(4, d)) * 0.3).astype(np.float32)
    return X, y, off, wt, W


@pytest.mark.parametrize("task", TASKS)
def test_evaluate_model_grid_matches_jax(task):
    X, y, off, wt, W = _eval_data(task)
    jb = jdense(X, y, off, wt, dtype=jnp.float32)
    tb = tdense(X, y, off, wt, device="cpu")
    jmaps = jeval.evaluate_model_grid(
        [JGLM(JCoef(jnp.asarray(w)), jcfg.TaskType[task]) for w in W], jb)
    tmodels = [TGLM(TCoef(torch.tensor(w)), tcfg.TaskType[task]) for w in W]
    tmaps = teval.evaluate_model_grid(tmodels, tb)
    assert [list(m) for m in tmaps] == [list(m) for m in jmaps]
    assert list(tmaps[0]) == teval._metric_names(tcfg.TaskType[task])
    for jm, tm in zip(jmaps, tmaps):
        for k, v in jm.items():
            assert tm[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    for model, grid_map in zip(tmodels, tmaps):
        one = teval.evaluate_model(model, tb)
        for k, v in grid_map.items():
            assert one[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    per_lambda = {lam: m for lam, m in zip((8.0, 4.0, 2.0, 1.0), jmaps)}
    assert teval.select_best_model(per_lambda, tcfg.TaskType[task]) == \
        jeval.select_best_model(per_lambda, jcfg.TaskType[task])


def test_evaluate_model_grid_refusals():
    tb = tdense(np.ones((4, 2), np.float32), np.ones(4), device="cpu")
    assert teval.evaluate_model_grid([], tb) == []
    lr = tcfg.TaskType.LOGISTIC_REGRESSION
    with pytest.raises(ValueError, match="homogeneous task"):
        teval.evaluate_model_grid(
            [TGLM(TCoef(torch.zeros(2)), lr),
             TGLM(TCoef(torch.zeros(2)), tcfg.TaskType.LINEAR_REGRESSION)],
            tb)
    with pytest.raises(ValueError, match="dimensions"):
        teval.evaluate_model_grid([TGLM(TCoef(torch.zeros(2)), lr),
                                   TGLM(TCoef(torch.zeros(3)), lr)], tb)
    with pytest.raises(ValueError):
        teval.select_best_model({}, lr)


def test_glm_helpers_match_jax():
    X = np.random.default_rng(12).normal(size=(20, 3)).astype(np.float32)
    w = np.asarray([0.5, -1.0, 0.25], np.float32)
    for task in ("LOGISTIC_REGRESSION", "SMOOTHED_HINGE_LOSS_LINEAR_SVM"):
        j = JGLM(JCoef(jnp.asarray(w)), jcfg.TaskType[task])
        t = TGLM(TCoef(torch.tensor(w)), tcfg.TaskType[task])
        np.testing.assert_array_equal(
            t.predict_class(torch.tensor(X)).numpy(),
            np.asarray(j.predict_class(jnp.asarray(X))))
    t = TGLM.zeros(3, tcfg.TaskType.POISSON_REGRESSION, device="cpu")
    assert t.validate_coefficients() and not t.coefficients.means.any()
    with pytest.raises(ValueError, match="not a classifier"):
        t.predict_class(torch.tensor(X))
    bad = t.with_coefficients(TCoef(torch.tensor([1.0, float("nan"), 0.0])))
    assert not bad.validate_coefficients()
    jc = JCoef(jnp.asarray(w), jnp.asarray(w * w))
    tc = TCoef(torch.tensor(w), torch.tensor(w * w))
    assert tc.summary() == jc.summary()

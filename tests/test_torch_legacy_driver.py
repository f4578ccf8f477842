"""PyTorch port vs the JAX package: the legacy driver and libsvm_to_avro.

Both packages' drivers run one argv (the port's with ``--device cpu``)
on the fixtures of ``tests/test_drivers.py::TestLegacyDriver`` and
``TestLibsvmToAvro``, made from numpy seeds:

- every weight's final objective agrees to rel 1e-5 and its TSV model
  to atol 2e-3 (both solve in f32 and stop on a relative change of 1e-6
  in the objective, which leaves flat directions of the coefficients
  loose by some 1e-3), ``metrics.json`` to rel 1e-4, the best weight
  exactly, and the diagnostic report's sections by title;
- the box case (the JAX test's lambda 0.01): in both packages the
  projected L-BFGS raises its objective after the third iteration and
  runs to its cap, so two f32 runs part after a few iterations; there
  the first four objective values agree to rel 1e-5, every bound holds
  in both, and the metrics agree to rel 1e-2;
- each package reads the other's TSV models;
- a LibSVM file trained directly equals its Avro conversion trained
  (name-sorted coefficients to atol 1e-4, the JAX test's), the JAX
  driver's direct run to atol 2e-3, and the two packages' conversions
  hold the same records;
- TRON with L1 is refused with ``ValueError`` as in the JAX driver; the
  off-heap flags end with exit 3 and one ``PHOTON_ABORT`` line.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import legacy_driver as jdriver
from photon_ml_tpu.cli import libsvm_to_avro as jconvert
from photon_ml_tpu.io import model_io as jmodel_io
from photon_ml_tpu.io.avro import read_records as jread_records
from photon_ml_tpu_torch.cli import legacy_driver as tdriver
from photon_ml_tpu_torch.cli import libsvm_to_avro as tconvert
from photon_ml_tpu_torch.io import model_io as tmodel_io
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro import read_records, write_container
from photon_ml_tpu_torch.io.index_map import feature_key
from photon_ml_tpu_torch.utils.events import PhotonOptimizationLogEvent

torch.set_num_threads(1)
AUC = "AREA_UNDER_RECEIVER_OPERATOR_CHARACTERISTICS"


def make_binary_avro(path, n=300, d=5, seed=0, w=None):
    """``tests/test_drivers.py::_make_binary_avro``: TrainingExampleAvro
    rows with a learnable binary signal (pass one ``w`` for the splits of
    one task)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    if w is None:
        w = np.random.default_rng(999).normal(size=d)
    p = 1.0 / (1.0 + np.exp(-(X @ w)))
    y = (rng.uniform(size=n) < p).astype(float)
    write_container(path, schemas.TRAINING_EXAMPLE, [{
        "uid": f"r{i}", "label": float(y[i]),
        "features": [{"name": f"f{j}", "term": "", "value": float(X[i, j])}
                     for j in range(d)],
        "metadataMap": None, "weight": None, "offset": None,
    } for i in range(n)])


def _run_both(tmp_path, args):
    """Both drivers on ``args`` (``{out}`` is each one's output dir);
    returns (JAX driver, port driver, JAX out, port out)."""
    outs = {k: str(tmp_path / f"out-{k}") for k in ("jax", "torch")}
    jd = jdriver.LegacyDriver(jdriver.parse_args(
        [a.replace("{out}", outs["jax"]) for a in args]))
    jd.run()
    jd.logger.close()
    td = tdriver.run([a.replace("{out}", outs["torch"]) for a in args]
                     + ["--device", "cpu"])
    return jd, td, outs["jax"], outs["torch"]


def _models_by_lambda(out, reader):
    return {lam: glm for lam, glm in reader(os.path.join(out, "output"))}


def _coefs(glm):
    return np.asarray(glm.coefficients.means, np.float64)


def _sections(path):
    return re.findall(r"<h[1-3][^>]*>(.*?)</h[1-3]>", open(path).read())


def _assert_agree(jd, td, jout, tout, boxed=False):
    # models: same weights, same features, coefficients close
    jm = _models_by_lambda(jout, jmodel_io.read_models_text)
    tm = _models_by_lambda(
        tout, lambda d: tmodel_io.read_models_text(d, device="cpu"))
    assert sorted(jm) == sorted(tm)
    for name in sorted(os.listdir(os.path.join(jout, "output"))):
        rows = [open(os.path.join(o, "output", name)).read().split("\n")
                for o in (jout, tout)]
        assert [sorted(line.split("\t")[:2] for line in r) for r in rows] \
            == [sorted(line.split("\t")[:2] for line in rows[0])] * 2
    for jt, tt in zip(jd.models, td.models):
        jv, tv = np.asarray(jt.result.values), tt.result.values
        if boxed:
            np.testing.assert_allclose(tv[:4], jv[:4], rtol=1e-5)
        else:
            assert tt.result.value == pytest.approx(jt.result.value,
                                                    rel=1e-5)
    for lam in jm:
        if not boxed:
            np.testing.assert_allclose(_coefs(tm[lam]), _coefs(jm[lam]),
                                       atol=2e-3)
    # metrics.json and the best weight
    jmet = json.load(open(os.path.join(jout, "metrics.json")))
    tmet = json.load(open(os.path.join(tout, "metrics.json")))
    assert sorted(jmet) == sorted(tmet)
    for lam in jmet:
        assert sorted(jmet[lam]) == sorted(tmet[lam])
        for k, v in jmet[lam].items():
            assert tmet[lam][k] == pytest.approx(
                v, rel=1e-2 if boxed else 1e-4, abs=1e-6), k
    assert td.best_lambda == jd.best_lambda
    assert os.path.exists(os.path.join(tout, "best")) == \
        os.path.exists(os.path.join(jout, "best"))
    for name in ("diagnostic-report.html",):
        jp, tp = os.path.join(jout, name), os.path.join(tout, name)
        assert os.path.exists(tp) == os.path.exists(jp)
        if os.path.exists(jp):
            assert _sections(tp) == _sections(jp)


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    d = tmp_path_factory.mktemp("legacy")
    w = np.random.default_rng(999).normal(size=5)
    paths = {}
    for name, n, seed in (("train", 300, 0), ("validate", 150, 1),
                          ("small", 250, 6)):
        paths[name] = str(d / f"{name}.avro")
        make_binary_avro(paths[name], n=n, seed=seed, w=w)
    return paths


BASE = ["--output-directory", "{out}", "--task", "LOGISTIC_REGRESSION"]
CASES = {
    # test_logistic_lbfgs_l2_end_to_end
    "lbfgs_l2_grid": ["--regularization-weights", "10,1,0.1",
                      "--num-iterations", "40",
                      "--data-validation-type", "VALIDATE_FULL"],
    # test_owlqn_l1_and_tron
    "owlqn_l1": ["--optimizer", "LBFGS", "--regularization-type", "L1",
                 "--regularization-weights", "1", "--num-iterations", "30"],
    "tron_l2": ["--optimizer", "TRON", "--regularization-type", "L2",
                "--regularization-weights", "1", "--num-iterations", "30"],
    "elastic_net": ["--regularization-type", "ELASTIC_NET",
                    "--elastic-net-alpha", "0.3",
                    "--regularization-weights", "1,0.1",
                    "--num-iterations", "30"],
    # test_box_constraints_end_to_end
    "box": ["--regularization-weights", "0.01", "--num-iterations", "50",
            "--coefficient-box-constraints", json.dumps([
                {"name": "f0", "term": "", "lowerBound": -0.05,
                 "upperBound": 0.05},
                {"name": "f1", "term": "", "upperBound": 0.0}])],
    # test_validate_per_iteration
    "per_iteration": ["--regularization-weights", "1",
                      "--num-iterations", "25",
                      "--validate-per-iteration", "true"],
    # test_diagnostics_produced
    "diagnostics": ["--regularization-weights", "1", "--num-iterations",
                    "8", "--diagnostic-mode", "ALL"],
    # test_normalization_standardization, with variances
    "standardization": ["--regularization-weights", "1",
                        "--normalization-type", "STANDARDIZATION",
                        "--num-iterations", "30",
                        "--coefficient-variance", "true"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_drivers_agree(tmp_path, splits, case):
    train = splits["small" if case == "box" else "train"]
    args = ["--training-data-directory", train,
            "--validating-data-directory", splits["validate"],
            *BASE, *CASES[case]]
    if case == "standardization":
        args += ["--summarization-output-dir", "{out}-summary"]
    jd, td, jout, tout = _run_both(tmp_path, args)
    _assert_agree(jd, td, jout, tout, boxed=case == "box")
    assert [s[0] for s in td.stage_history + [td.stage]] == \
        [s[0] for s in jd.stage_history + [jd.stage]]
    if case == "box":
        imap = td.train_data.index_map
        i0, i1 = imap.index_of(feature_key("f0")), imap.index_of(
            feature_key("f1"))
        for w in (td.models[0].model.coefficients.means.numpy(),
                  np.asarray(jd.models[0].model.coefficients.means)):
            assert -0.05 - 1e-6 <= w[i0] <= 0.05 + 1e-6 and w[i1] <= 1e-6
    if case == "standardization":
        var = td.models[0].model.coefficients.variances
        np.testing.assert_allclose(
            var.numpy(), np.asarray(jd.models[0].model.coefficients
                                    .variances), rtol=1e-3)
        recs = read_records(os.path.join(tout + "-summary",
                                         "part-00000.avro"))
        jrecs = jread_records(os.path.join(jout + "-summary",
                                           "part-00000.avro"))
        assert len(recs) == len(jrecs) == 6
        for r, j in zip(recs, jrecs):
            assert (r["featureName"], r["featureTerm"]) == \
                (j["featureName"], j["featureTerm"])
            for k, v in j["metrics"].items():
                assert r["metrics"][k] == pytest.approx(v, rel=1e-6,
                                                        abs=1e-9)
    if case == "diagnostics":
        for name in ("diagnostic-report.html", "diagnostic-report.txt"):
            assert os.path.exists(os.path.join(tout, name))
        html = open(os.path.join(tout, "diagnostic-report.html")).read()
        assert "Hosmer-Lemeshow" in html and "Learning curves" in html


def test_per_iteration_metrics_and_events(tmp_path, splits):
    args = ["--training-data-directory", splits["train"],
            "--validating-data-directory", splits["validate"],
            "--output-directory", str(tmp_path / "out"),
            "--regularization-weights", "1", "--num-iterations", "25",
            "--validate-per-iteration", "true", "--device", "cpu"]
    driver = tdriver.LegacyDriver(tdriver.parse_args(args))
    events = []
    driver.register_listener(events.append)
    driver.run()
    driver.logger.close()
    opt = [e for e in events if isinstance(e, PhotonOptimizationLogEvent)]
    assert len(opt) == 1
    per_iter = opt[0].per_iteration_metrics
    assert len(per_iter) == driver.models[0].result.iterations + 1
    assert per_iter[-1][AUC] > per_iter[0][AUC]
    assert per_iter[-1][AUC] == pytest.approx(
        driver.per_lambda_metrics[1.0][AUC], abs=1e-6)
    names = [type(e).__name__ for e in events]
    assert names[:3] == ["PhotonSetupEvent", "TrainingStartEvent",
                         "TrainingFinishEvent"]


def test_each_package_reads_the_others_models(tmp_path, splits):
    args = ["--training-data-directory", splits["train"], *BASE,
            "--regularization-weights", "10,1", "--num-iterations", "20"]
    jd, td, jout, tout = _run_both(tmp_path, args)
    imap = td.train_data.index_map
    for jl_glm, tl_glm in zip(
            jmodel_io.read_models_text(os.path.join(tout, "output")),
            tmodel_io.read_models_text(os.path.join(jout, "output"),
                                       device="cpu")):
        assert jl_glm[0] == tl_glm[0]
    # the port's models, read back by the port with the training map,
    # equal its in-memory models exactly (the text keeps repr digits)
    back = tmodel_io.read_models_text(os.path.join(tout, "output"), imap,
                                      device="cpu")
    for (lam, glm), tm in zip(back, td.models):
        assert lam == tm.regularization_weight
        assert torch.equal(glm.coefficients.means,
                           tm.model.coefficients.means)


def _write_libsvm(path, seed=17, n=120, d=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    w = rng.normal(size=d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ w)))).astype(int)
    with open(path, "w") as fh:
        for i in range(n):
            feats = " ".join(f"{j+1}:{X[i, j]:.6f}" for j in range(d))
            fh.write(f"{'+1' if y[i] else '-1'} {feats}\n")


def test_libsvm_direct_equals_converted(tmp_path):
    """TestLibsvmToAvro.test_convert_then_train, in the port and against
    the JAX package's conversion."""
    d = 5
    libsvm = str(tmp_path / "data.libsvm")
    _write_libsvm(libsvm, d=d)
    avro, javro = str(tmp_path / "data.avro"), str(tmp_path / "j.avro")
    tconvert.main(["--input-path", libsvm, "--output-path", avro,
                   "--feature-dimension", str(d), "--device", "cpu"])
    jconvert.main(["--input-path", libsvm, "--output-path", javro,
                   "--feature-dimension", str(d)])
    assert read_records(avro) == jread_records(javro)
    common = ["--task", "LOGISTIC_REGRESSION", "--regularization-weights",
              "1", "--num-iterations", "30", "--device", "cpu"]
    out_a, out_l = str(tmp_path / "out-avro"), str(tmp_path / "out-libsvm")
    tdriver.main(["--training-data-directory", avro,
                  "--output-directory", out_a, *common])
    tdriver.main(["--training-data-directory", libsvm,
                  "--output-directory", out_l,
                  "--input-file-format", "LIBSVM",
                  "--feature-dimension", str(d), *common])
    (_, glm_a), = tmodel_io.read_models_text(os.path.join(out_a, "output"),
                                             device="cpu")
    (_, glm_l), = tmodel_io.read_models_text(os.path.join(out_l, "output"),
                                             device="cpu")
    np.testing.assert_allclose(sorted(_coefs(glm_a)), sorted(_coefs(glm_l)),
                               atol=1e-4)
    # and the JAX driver's direct LibSVM run
    out_j = str(tmp_path / "out-jax")
    jdriver.main(["--training-data-directory", libsvm,
                  "--output-directory", out_j,
                  "--input-file-format", "LIBSVM",
                  "--feature-dimension", str(d), *common[:-2]])
    (_, glm_j), = jmodel_io.read_models_text(os.path.join(out_j, "output"))
    np.testing.assert_allclose(sorted(_coefs(glm_l)), sorted(_coefs(glm_j)),
                               atol=2e-3)


def test_raw_labels_preserved(tmp_path):
    libsvm = str(tmp_path / "reg.libsvm")
    with open(libsvm, "w") as fh:
        fh.write("3.7 1:0.5\n-2.25 2:1.0\n")
    avro = str(tmp_path / "reg.avro")
    tconvert.main(["--input-path", libsvm, "--output-path", avro,
                   "--feature-dimension", "2", "--binarize-labels", "false",
                   "--device", "cpu"])
    recs = read_records(avro)
    assert [r["label"] for r in recs] == [3.7, -2.25]
    assert [r["features"][0]["name"] for r in recs] == ["1", "2"]


def test_boxed_tron_values_rise_alike_in_both_packages(tmp_path):
    """With a box, TRON projects an accepted step and evaluates there, so
    its accepted values can rise: on an a1a-shaped one-hot fixture both
    packages' values rise at the same iterations, to rel 1e-5 (which is
    why chip_smoke's phase 11 (d) holds only the unboxed TRON run to
    never rising)."""
    import chip_smoke

    train_txt, _ = chip_smoke.write_a1a_like(str(tmp_path / "txt"),
                                             (3000, 10))
    avro = str(tmp_path / "train.avro")
    tconvert.main(["--input-path", train_txt, "--output-path", avro,
                   "--feature-dimension", "123", "--device", "cpu"])
    box = [{"name": str(j), "term": "", "lowerBound": -0.05,
            "upperBound": 0.05} for j in (1, 6, 40)]
    args = ["--training-data-directory", avro, *BASE,
            "--optimizer", "TRON", "--regularization-weights", "1",
            "--num-iterations", "12", "--normalization-type",
            "STANDARDIZATION", "--coefficient-box-constraints",
            json.dumps(box)]
    jd, td, _, _ = _run_both(tmp_path, args)
    jv = np.asarray(jd.models[0].result.values)
    tv = td.models[0].result.values
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    assert np.any(np.diff(tv) > 0) and np.any(np.diff(jv) > 0)
    assert list(np.diff(tv) > 0) == list(np.diff(jv) > 0)


def test_tron_with_l1_is_refused():
    argv = ["--training-data-directory", "x", "--output-directory", "y",
            "--optimizer", "TRON", "--regularization-type", "L1"]
    with pytest.raises(ValueError, match="TRON"):
        jdriver.parse_args(argv)
    with pytest.raises(ValueError, match="TRON"):
        tdriver.parse_args(argv + ["--device", "cpu"])


@pytest.mark.parametrize("flag,value", [
    ("--offheap-indexmap-dir", "store"),
    ("--offheap-indexmap-num-partitions", "4")])
def test_offheap_flags_exit_3(tmp_path, capsys, flag, value):
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as e:
        tdriver.main(["--training-data-directory", "x",
                      "--output-directory", str(out), flag, value,
                      "--device", "cpu"])
    assert e.value.code == 3
    err = capsys.readouterr().err
    assert f"PHOTON_ABORT kind=NotImplementedError: {flag}" in err
    assert not out.exists()

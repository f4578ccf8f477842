"""PyTorch port vs the JAX package: the legacy driver's diagnostics.

The port's ``diagnostics`` modules are copies of the JAX package's
(numpy and scipy only), so on the same inputs, made from numpy seeds,
every report must be equal: Hosmer-Lemeshow, feature importance (with and
without an index map and a factor), Kendall tau, prediction-error
independence (sampled past its cap with the seeded
``np.random.default_rng``), the fitting diagnostic (10 partitions) and
the bootstrap diagnostic (4 samples at 0.75) over one ridge model
factory, and the HTML and text renderings of the assembled document, to
the character.
"""

import dataclasses

import numpy as np
import pytest

from photon_ml_tpu.diagnostics import diagnostics as jdiag
from photon_ml_tpu.diagnostics import reporting as jrep
from photon_ml_tpu.diagnostics import transformers as jtr
from photon_ml_tpu.io.index_map import IndexMap as JIndexMap
from photon_ml_tpu_torch.diagnostics import diagnostics as tdiag
from photon_ml_tpu_torch.diagnostics import reporting as trep
from photon_ml_tpu_torch.diagnostics import transformers as ttr
from photon_ml_tpu_torch.io.index_map import IndexMap as TIndexMap


def assert_same(a, b, path="report"):
    """Structural equality of two reports from the two packages: the same
    class name and fields, arrays equal (NaN equal to NaN)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a, key=repr) == sorted(b, key=repr), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, path


def _calibration(seed=7, n=500):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.05, 0.95, size=n)
    labels = (rng.uniform(size=n) < p).astype(float)
    return labels, p


@pytest.mark.parametrize("bins", [10, 4])
def test_hosmer_lemeshow(bins):
    labels, p = _calibration()
    assert_same(jdiag.hosmer_lemeshow(labels, p, bins),
                tdiag.hosmer_lemeshow(labels, p, bins))


@pytest.mark.parametrize("with_map,with_factor", [(False, False),
                                                  (True, False),
                                                  (True, True)])
def test_feature_importance(with_map, with_factor):
    rng = np.random.default_rng(8)
    w = rng.normal(size=12)
    factor = rng.uniform(0.1, 2.0, size=12) if with_factor else None
    keys = {f"f{i}\x01t": i for i in range(12)}
    j = jdiag.feature_importance(w, JIndexMap(keys) if with_map else None,
                                 factor, "variance")
    t = tdiag.feature_importance(w, TIndexMap(keys) if with_map else None,
                                 factor, "variance")
    assert_same(j, t)


def test_kendall_tau():
    rng = np.random.default_rng(9)
    a = rng.normal(size=300)
    b = 0.3 * a + rng.normal(size=300)
    b[::7] = b[0]  # ties
    assert_same(jdiag.kendall_tau(a, b), tdiag.kendall_tau(a, b))


@pytest.mark.parametrize("cap", [None, 200])
def test_prediction_error_independence(cap):
    labels, p = _calibration(seed=10, n=800)
    kw = {} if cap is None else {"max_samples": cap}
    assert_same(jdiag.prediction_error_independence(labels, p, **kw),
                tdiag.prediction_error_independence(labels, p, **kw))


def _ridge_data(seed=5, n=1200, d=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = X @ rng.normal(size=d) + 0.1 * rng.normal(size=n)
    return X, y


def _fit_factory(X, y):
    def factory(idx, eval_idx, warm):
        out = {}
        for lam in (1.0, 0.1):
            Xi, yi = X[idx], y[idx]
            w = np.linalg.solve(Xi.T @ Xi + lam * np.eye(X.shape[1]),
                                Xi.T @ yi)

            def rmse(rows):
                return {"RMSE": float(np.sqrt(np.mean(
                    (X[rows] @ w - y[rows]) ** 2)))}

            out[lam] = ((w, rmse(idx), rmse(eval_idx))
                        if eval_idx is not None else (w, rmse(idx)))
        return out
    return factory


def test_fitting_diagnostic():
    X, y = _ridge_data()
    j = jdiag.fitting_diagnostic(len(y), X.shape[1], _fit_factory(X, y))
    t = tdiag.fitting_diagnostic(len(y), X.shape[1], _fit_factory(X, y))
    assert sorted(t) == [0.1, 1.0]
    assert len(t[1.0].metrics["RMSE"].portions) == 9  # 10 partitions
    assert_same(j, t)


def test_bootstrap_diagnostic():
    X, y = _ridge_data(seed=6)
    j = jdiag.bootstrap_training(len(y), 4, 0.75, _fit_factory(X, y))
    t = tdiag.bootstrap_training(len(y), 4, 0.75, _fit_factory(X, y))
    assert_same(j, t)
    with pytest.raises(ValueError):
        tdiag.bootstrap_training(len(y), 1, 0.75, _fit_factory(X, y))


def test_rendered_reports_equal():
    labels, p = _calibration(seed=11)
    X, y = _ridge_data(seed=12)
    keys = {f"f{i}\x01": i for i in range(X.shape[1])}
    docs = []
    for diag, tr, imap in ((jdiag, jtr, JIndexMap(keys)),
                           (tdiag, ttr, TIndexMap(keys))):
        docs.append(tr.build_diagnostic_document(
            "Diagnostics: job", hl=diag.hosmer_lemeshow(labels, p),
            importance=[diag.feature_importance(
                np.linspace(-1, 1, X.shape[1]), imap)],
            independence=diag.prediction_error_independence(labels, p),
            fitting=diag.fitting_diagnostic(len(y), X.shape[1],
                                            _fit_factory(X, y)),
            bootstrap=diag.bootstrap_training(len(y), 4, 0.75,
                                              _fit_factory(X, y)),
            index_map=imap, preamble='{"task": "LINEAR_REGRESSION"}'))
    html = trep.render_html(docs[1])
    assert html == jrep.render_html(docs[0])
    assert trep.render_text(docs[1]) == jrep.render_text(docs[0])
    for title in ("Hosmer-Lemeshow", "Feature importance", "independence",
                  "Learning curves"):
        assert title in html

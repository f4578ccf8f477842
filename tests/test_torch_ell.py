"""PyTorch port vs the JAX package: the ELL layout for wide shards.

- ``EllBatch``: margins, both column sums, and the four losses' value,
  gradient, Hessian-vector product and Hessian diagonal (plain and
  normalized) against the JAX package's ``EllBatch`` in f64: rtol 1e-10.
- ``ell_from_csr`` (through the native packer at f32, the numpy scatter
  at f64), ``ell_from_rows`` and ``pad_batch`` hold the JAX package's
  planes exactly, with duplicate and empty rows; ``csr_to_batch`` is
  dense at 4,096 columns and ELL at 4,097, in both packages.
- L-BFGS, OWL-QN and TRON through ``GLMOptimizationProblem.run`` on an
  ELL batch agree with the JAX package (f64, rtol 1e-8, the same
  iteration counts), and the port's ELL solve equals its dense solve of
  the same matrix within rel 1e-6.
- The fixed-order column sum is ``torch.equal`` across calls, and a
  coordinate descent over a wide fixed effect resumed mid-sweep ends
  ``array_equal`` to its uninterrupted run.
- ``evaluate_model_grid`` on an ELL batch equals it on the dense batch
  (rel 1e-6, f32).
- Both legacy drivers on a wide LibSVM file (4,196 columns) train
  through the ELL layout and agree (rtol 1e-4 on the coefficients, f32).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data import batch as jb
from photon_ml_tpu.game import dataset as jds
from photon_ml_tpu.ops import aggregators as ja
from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.ops.normalization import NormalizationContext as JNorm
from photon_ml_tpu.optimize import config as jcfg
from photon_ml_tpu.optimize.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu_torch.data import batch as tb
from photon_ml_tpu_torch.evaluation.model_evaluation import evaluate_model_grid
from photon_ml_tpu_torch.game import coordinate as tco
from photon_ml_tpu_torch.game import coordinate_descent as tcd
from photon_ml_tpu_torch.game import dataset as tds
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops import aggregators as ta
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.ops.normalization import NormalizationContext as TNorm
from photon_ml_tpu_torch.optimize import config as tcfg
from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem as TProblem
from photon_ml_tpu_torch.utils import checkpoint as tck
from photon_ml_tpu_torch.utils import faults as tfaults

torch.set_num_threads(1)
RTOL = 1e-10


def _wide_csr(n=300, d=5000, seed=0, dup=True):
    """Ragged rows (0-9 entries, some empty), one dense column, and some
    duplicated cells when ``dup`` (summed by the canonical form)."""
    r = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        k = int(r.integers(0, 10)) if i % 7 else 0
        for j in r.choice(d - 1, size=k, replace=False):
            rows.append(i)
            cols.append(int(j) + 1)
            vals.append(float(r.normal()))
        if i % 7:
            rows.append(i)
            cols.append(0)
            vals.append(1.0)
        if dup and k and i % 5 == 0:
            rows.append(i)
            cols.append(cols[-2])
            vals.append(0.5)
    mat = sp.csr_matrix((vals, (rows, cols)), shape=(n, d))
    mat.sum_duplicates()
    return mat


def _meta(n, seed=1, loss="logistic"):
    r = np.random.default_rng(seed)
    if loss in ("squared", "poisson"):
        y = r.poisson(1.0, size=n).astype(np.float64)
    else:
        y = (r.uniform(size=n) < 0.5).astype(np.float64)
    return y, r.normal(size=n) * 0.1, r.uniform(0.5, 2.0, size=n)


def _both(mat, y, off, wt, dtype64=True):
    jd = jnp.float64 if dtype64 else jnp.float32
    td = torch.float64 if dtype64 else torch.float32
    return (jb.ell_from_csr(mat, y, off, wt, dtype=jd),
            tb.ell_from_csr(mat, y, off, wt, dtype=td, device="cpu"))


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=1e-12)


@pytest.mark.parametrize("name", sorted(jl.LOSSES))
@pytest.mark.parametrize("normalized", [False, True])
def test_ell_objective_matches_jax(name, normalized):
    mat = _wide_csr()
    n, d = mat.shape
    y, off, wt = _meta(n, loss=name)
    jbatch, tbatch = _both(mat, y, off, wt)
    r = np.random.default_rng(3)
    coef, vec, rows = r.normal(size=d) * 0.2, r.normal(size=d), r.normal(
        size=n)
    jn, tn = JNorm(), TNorm()
    if normalized:
        f, s = r.uniform(0.5, 2.0, d), r.normal(size=d)
        s[0] = 0.0
        jn = JNorm(jnp.asarray(f), jnp.asarray(s), intercept_index=0)
        tn = TNorm(torch.tensor(f), torch.tensor(s), intercept_index=0)
    jc, tc = jnp.asarray(coef), torch.tensor(coef)
    _close(tbatch.margins(tc, torch.tensor(0.3, dtype=torch.float64)),
           jbatch.margins(jc, 0.3))
    _close(tbatch.weighted_feature_sum(torch.tensor(rows)),
           jbatch.weighted_feature_sum(jnp.asarray(rows)))
    _close(tbatch.hadamard_square_sum(torch.tensor(rows)),
           jbatch.hadamard_square_sum(jnp.asarray(rows)))
    jloss, tloss = jl.get_loss(name), tl.get_loss(name)
    jval, jgrad = ja.value_and_gradient(jloss, jn, jc, jbatch)
    tval, tgrad = ta.value_and_gradient(tloss, tn, tc, tbatch)
    _close(tval, jval)
    _close(tgrad, jgrad)
    _close(ta.hessian_vector(tloss, tn, tc, torch.tensor(vec), tbatch),
           ja.hessian_vector(jloss, jn, jc, jnp.asarray(vec), jbatch))
    _close(ta.hessian_diagonal(tloss, tn, tc, tbatch),
           ja.hessian_diagonal(jloss, jn, jc, jbatch))


def _planes_equal(t, j):
    assert t.dim == j.dim
    for f in ("indices", "values", "labels", "offsets", "weights"):
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("dtype64", [False, True], ids=["f32", "f64"])
def test_ell_builders_match_jax(dtype64):
    mat = _wide_csr(n=200, d=300, seed=4)
    n, d = mat.shape
    y, off, wt = _meta(n)
    jbatch, tbatch = _both(mat, y, off, wt, dtype64)
    _planes_equal(tbatch, jbatch)
    rows = [(mat.indices[mat.indptr[i]:mat.indptr[i + 1]],
             mat.data[mat.indptr[i]:mat.indptr[i + 1]]) for i in range(n)]
    jd = jnp.float64 if dtype64 else jnp.float32
    td = torch.float64 if dtype64 else torch.float32
    jr = jb.ell_from_rows(rows, d, y, off, wt, dtype=jd)
    tr = tb.ell_from_rows(rows, d, y, off, wt, dtype=td, device="cpu")
    _planes_equal(tr, jr)
    _planes_equal(tr, jbatch)
    _planes_equal(tb.pad_batch(tbatch, n + 13), jb.pad_batch(jbatch, n + 13))
    assert tb.pad_batch(tbatch, n) is tbatch
    with pytest.raises(ValueError, match="target"):
        tb.pad_batch(tbatch, n - 1)
    # empty rows and an all-empty matrix
    assert not tbatch.values.numpy()[0].any()
    empty = sp.csr_matrix((3, 10))
    te = tb.ell_from_csr(empty, np.zeros(3), device="cpu")
    _planes_equal(te, jb.ell_from_csr(empty, np.zeros(3)))
    assert torch.equal(te.weighted_feature_sum(torch.ones(3)),
                       torch.zeros(10))


def test_duplicates_sum_before_the_pack():
    raw = sp.csr_matrix((np.array([1.0, 2.0, 3.0]),
                         (np.array([0, 0, 1]), np.array([5, 5, 4]))),
                        shape=(2, 4200))
    y = np.array([0.0, 1.0])
    t = tds.csr_to_batch(raw, y, np.zeros(2), np.ones(2), device="cpu")
    j = jds.csr_to_batch(raw, y, np.zeros(2), np.ones(2))
    _planes_equal(t, j)
    assert t.values.numpy()[0, 0] == 3.0
    r = torch.tensor([1.0, 1.0])
    assert float(t.hadamard_square_sum(r)[5]) == 9.0


@pytest.mark.parametrize("d", [4096, 4097])
def test_csr_to_batch_switches_layout_past_4096_columns(d):
    mat = _wide_csr(n=50, d=d, seed=5)
    y, off, wt = _meta(50)
    t = tds.csr_to_batch(mat, y, off, wt, device="cpu")
    j = jds.csr_to_batch(mat, y, off, wt)
    if d <= tds.DENSE_FEATURE_THRESHOLD:
        assert isinstance(t, tb.DenseBatch) and isinstance(j, jb.DenseBatch)
        assert np.array_equal(t.X.numpy(), np.asarray(j.X))
    else:
        assert isinstance(t, tb.EllBatch) and isinstance(j, jb.EllBatch)
        _planes_equal(t, j)
    assert t.device == torch.device("cpu")


def _config(mod, opt, reg, lam):
    return mod.GLMOptimizationConfiguration(
        max_iterations=60, tolerance=1e-9, regularization_weight=lam,
        optimizer_type=mod.OptimizerType[opt],
        regularization_context=mod.RegularizationContext(
            mod.RegularizationType[reg], alpha=0.5))


SOLVER_CASES = [("LOGISTIC_REGRESSION", "LBFGS", "L2", 2.0),
                ("LOGISTIC_REGRESSION", "LBFGS", "L1", 2.0),
                ("LINEAR_REGRESSION", "TRON", "L2", 2.0)]


@pytest.mark.parametrize("task,opt,reg,lam", SOLVER_CASES)
def test_solvers_on_ell_match_jax(task, opt, reg, lam):
    loss = "squared" if task == "LINEAR_REGRESSION" else "logistic"
    mat = _wide_csr(n=400, d=4300, seed=6, dup=False)
    y, off, wt = _meta(400, loss=loss)
    jbatch, tbatch = _both(mat, y, off, wt)
    jm, jr = JProblem(config=_config(jcfg, opt, reg, lam),
                      task=jcfg.TaskType[task]).run(jbatch)
    tm, tr = TProblem(config=_config(tcfg, opt, reg, lam),
                      task=tcfg.TaskType[task]).run(tbatch)
    assert tr.iterations == jr.iterations
    jw = np.asarray(jm.coefficients.means)
    tw = tm.coefficients.means.numpy()
    np.testing.assert_allclose(tw, jw, rtol=1e-8, atol=1e-11)
    if reg == "L1":
        np.testing.assert_array_equal(tw == 0.0, jw == 0.0)
        assert (tw == 0.0).any()


@pytest.mark.parametrize("task,opt,reg,lam", SOLVER_CASES)
def test_ell_solve_equals_the_dense_solve(task, opt, reg, lam):
    loss = "squared" if task == "LINEAR_REGRESSION" else "logistic"
    mat = _wide_csr(n=400, d=4300, seed=7, dup=False)
    y, off, wt = _meta(400, loss=loss)
    ell = tb.ell_from_csr(mat, y, off, wt, dtype=torch.float64,
                          device="cpu")
    dense = tb.dense_batch(mat.toarray(), y, off, wt, dtype=torch.float64,
                           device="cpu")
    problem = TProblem(config=_config(tcfg, opt, reg, lam),
                       task=tcfg.TaskType[task])
    we = problem.run(ell)[0].coefficients.means.numpy()
    wd = problem.run(dense)[0].coefficients.means.numpy()
    np.testing.assert_allclose(we, wd, rtol=1e-6,
                               atol=1e-6 * np.abs(wd).max())


def test_column_sums_repeat_bit_for_bit():
    mat = _wide_csr(n=2000, d=6000, seed=8)
    y, off, wt = _meta(2000)
    batch = tds.csr_to_batch(mat, y, off, wt, device="cpu")
    r = torch.tensor(np.random.default_rng(9).normal(size=2000),
                     dtype=torch.float32)
    a, b = batch.weighted_feature_sum(r), batch.weighted_feature_sum(r)
    assert torch.equal(a, b)
    assert torch.equal(batch.hadamard_square_sum(r),
                       batch.hadamard_square_sum(r))
    # the plan sums non-zeros only, in column order: every column once
    plan = batch.plan
    assert plan.values.shape[1] == plan.width
    assert int((plan.values != 0).sum()) == int((batch.values != 0).sum())
    dense = mat.toarray().T @ r.double().numpy()
    np.testing.assert_allclose(a.double().numpy(), dense, rtol=1e-5,
                               atol=1e-4)
    # a replaced offset keeps the plan; replaced values rebuild it
    assert batch._replace(offsets=batch.offsets * 0).plan is plan
    assert batch._replace(values=batch.values * 2).plan is not plan


def test_column_sum_plan_is_lazy_and_linear_in_the_non_zeros():
    """A mostly empty 2**20-wide shard: the plan is built on the first
    column sum only, its slots stay within 4 per non-zero whatever the
    width (an empty column takes none), and a column long enough for
    several levels sums next to columns done at level 0 (f64, rtol
    1e-12 against scipy)."""
    r = np.random.default_rng(14)
    n, d = 400, 2 ** 20
    rows = np.concatenate([np.repeat(np.arange(n), 3), np.arange(n)])
    cols = np.concatenate([r.integers(0, d, 3 * n), np.full(n, 77)])
    mat = sp.csr_matrix((r.normal(size=4 * n), (rows, cols)), shape=(n, d))
    mat.sum_duplicates()
    y, off, wt = _meta(n, seed=15)
    batch = tb.ell_from_csr(mat, y, off, wt, dtype=torch.float64,
                            device="cpu")
    plan = batch.plan
    assert not hasattr(plan, "values")
    s = torch.tensor(r.normal(size=n))
    got = batch._replace(weights=batch.weights * 2).weighted_feature_sum(s)
    assert batch.plan is plan and hasattr(plan, "values")
    np.testing.assert_allclose(got.numpy(), mat.T @ s.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(batch.hadamard_square_sum(s).numpy(),
                               mat.multiply(mat).T @ s.numpy(), rtol=1e-12,
                               atol=1e-12)
    assert plan.levels
    slots = plan.values.numel() + sum(lv.numel() for lv in plan.levels)
    assert slots <= 4 * mat.nnz
    assert plan.rows.shape == plan.values.shape
    assert plan.out.shape == (d,)


def _wide_game_data(n=800, users=12, d=4300, seed=10):
    r = np.random.default_rng(seed)
    mat = _wide_csr(n=n, d=d, seed=seed, dup=False)
    y = (r.uniform(size=n) < 0.5).astype(np.float64)
    data = tds.GameDataset(
        responses=y,
        feature_shards={"wide": mat,
                        "user": sp.csr_matrix(r.normal(size=(n, 4)))})
    data.encode_ids("userId", r.integers(0, users, n))
    return data


def _wide_coords(data):
    cfg = tcfg.GLMOptimizationConfiguration.parse("15,1e-7,1.0,1,LBFGS,L2")
    task = tcfg.TaskType.LOGISTIC_REGRESSION
    fe = tds.build_fixed_effect_dataset(data, "wide", device="cpu")
    assert isinstance(fe.batch, tb.EllBatch)
    re_ds = tds.build_random_effect_dataset(
        data, tds.RandomEffectDataConfiguration("userId", "user", 1),
        device="cpu")
    return {"fixed": tco.FixedEffectCoordinate(
                fe, TProblem(config=cfg, task=task)),
            "per-user": tco.RandomEffectCoordinate(
                re_ds, tre.RandomEffectOptimizationProblem(config=cfg,
                                                           task=task))}


def _cd(data, **kw):
    return tcd.run_coordinate_descent(
        _wide_coords(data), 2, tcfg.TaskType.LOGISTIC_REGRESSION,
        data.responses, data.weights, data.offsets, device="cpu", **kw)


def _states(res):
    m = res.model.models
    return {"fixed": m["fixed"].model.coefficients.means.numpy(),
            "per-user": m["per-user"].coefficients_projected.numpy()}


def test_resume_on_an_ell_shard_is_bit_exact(tmp_path):
    data = _wide_game_data()
    want = _cd(data)
    mgr = tck.CheckpointManager(str(tmp_path))
    tfaults.arm("cd.update", "raise", tag="1.0")
    try:
        with pytest.raises(tfaults.InjectedFault):
            _cd(data, checkpoint_manager=mgr,
                checkpoint_every_coordinates=1)
    finally:
        tfaults.disarm_all()
    snap = mgr.restore()
    assert (snap["sweep"], snap["coordinate_index"]) == (1, 0)
    got = _cd(data, checkpoint_manager=mgr, checkpoint_every_coordinates=1,
              resume_snapshot=snap)
    assert [s.objective for s in got.states] == \
        [s.objective for s in want.states[2:]]
    for cid, w in _states(want).items():
        assert np.array_equal(_states(got)[cid], w), cid


def test_evaluate_model_grid_on_ell_equals_dense():
    mat = _wide_csr(n=600, d=4200, seed=11, dup=False)
    y, off, wt = _meta(600, seed=12)
    ell = tb.ell_from_csr(mat, y, off, wt, device="cpu")
    dense = tb.dense_batch(mat.toarray(), y, off, wt, device="cpu")
    r = np.random.default_rng(13)
    models = [GeneralizedLinearModel(
        Coefficients(means=torch.tensor(r.normal(size=4200) * s,
                                        dtype=torch.float32)),
        tcfg.TaskType.LOGISTIC_REGRESSION) for s in (0.1, 0.5, 1.0)]
    for me, md in zip(evaluate_model_grid(models, ell),
                      evaluate_model_grid(models, dense)):
        assert me.keys() == md.keys()
        for k in me:
            assert me[k] == pytest.approx(md[k], rel=1e-6, abs=1e-9), k


def _write_wide_libsvm(path, d, n, seed):
    r = np.random.default_rng(seed)
    hot = r.choice(d, size=12, replace=False) + 1
    w_true = r.normal(size=12)
    with open(path, "w") as fh:
        for _ in range(n):
            x = r.normal(size=12)
            keep = r.uniform(size=12) < 0.7
            y = "+1" if x[keep] @ w_true[keep] > 0 else "-1"
            feats = " ".join(f"{int(j)}:{v:.5f}" for j, v, k in
                             sorted(zip(hot, x, keep)) if k)
            fh.write(f"{y} {feats}\n")


def test_both_legacy_drivers_train_a_wide_libsvm_file(tmp_path):
    from photon_ml_tpu.cli import legacy_driver as jdriver
    from photon_ml_tpu_torch.cli import legacy_driver as tdriver

    d = tds.DENSE_FEATURE_THRESHOLD + 100
    train, val = str(tmp_path / "train.libsvm"), str(tmp_path / "val.libsvm")
    _write_wide_libsvm(train, d, 300, seed=23)
    _write_wide_libsvm(val, d, 120, seed=24)
    args = ["--training-data-directory", train,
            "--validating-data-directory", val,
            "--task", "LOGISTIC_REGRESSION", "--input-file-format",
            "LIBSVM", "--feature-dimension", str(d),
            "--regularization-weights", "10,1", "--num-iterations", "40"]
    jd = jdriver.LegacyDriver(jdriver.parse_args(
        args + ["--output-directory", str(tmp_path / "j")]))
    jd.run()
    td = tdriver.run(args + ["--output-directory", str(tmp_path / "t"),
                             "--device", "cpu"])
    assert isinstance(td._batch(td.train_data), tb.EllBatch)
    assert isinstance(td._validation_batch(), tb.EllBatch)
    for jm, tm in zip(jd.models, td.models):
        assert tm.regularization_weight == jm.regularization_weight
        np.testing.assert_allclose(
            tm.model.coefficients.means.numpy(),
            np.asarray(jm.model.coefficients.means), rtol=1e-4, atol=1e-5)
    assert td.best_lambda == jd.best_lambda
    for lam, metrics in td.per_lambda_metrics.items():
        for k, v in metrics.items():
            assert v == pytest.approx(jd.per_lambda_metrics[lam][k],
                                      rel=1e-4), k
    assert os.path.exists(tmp_path / "t" / "best")

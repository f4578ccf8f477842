"""PyTorch port vs the JAX package: OWL-QN, TRON and their dispatch.

Mirrors ``tests/test_owlqn_tron.py``. Small, well-conditioned problems
made from a numpy seed go through the JAX solver and the port's in f64
(the suite turns JAX x64 on):

- ``pseudo_gradient`` in every region: exactly equal;
- OWL-QN with zero L1 reaches the port's L-BFGS solution (atol 1e-5, as
  in the JAX test);
- OWL-QN against ``minimize_owlqn`` with scalar and per-coordinate L1,
  TRON against ``minimize_tron`` for the squared, logistic and Poisson
  losses: equal iteration counts and made-progress flags, iterates and
  per-iteration values to rtol 1e-9, OWL-QN's exact-zero pattern equal,
  TRON's accepted values never rising;
- five lanes of different data in one call equal five one-lane runs to
  rtol 1e-12 with equal iteration counts;
- ``GLMOptimizationProblem``: the optimizer dispatch, smoothed hinge +
  TRON refused with ``ValueError`` on both sides, variances against the
  JAX ``publish`` to rtol 1e-9, and the L1 / elastic-net penalty.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.batch import DenseBatch as JBatch
from photon_ml_tpu.ops import aggregators as ja
from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.optimize import config as jcfg
from photon_ml_tpu.optimize import owlqn as jowlqn
from photon_ml_tpu.optimize import tron as jtron
from photon_ml_tpu.optimize.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu_torch.data.batch import DenseBatch as TBatch
from photon_ml_tpu_torch.ops import aggregators as ta
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.optimize import config as tcfg
from photon_ml_tpu_torch.optimize import lbfgs as tlbfgs
from photon_ml_tpu_torch.optimize import owlqn as towlqn
from photon_ml_tpu_torch.optimize import tron as ttron
from photon_ml_tpu_torch.optimize.problem import GLMOptimizationProblem as TProblem

torch.set_num_threads(1)
RTOL = 1e-9


def _data(seed, loss="logistic", n=300, d=8, sparse_truth=False):
    """``tests/test_owlqn_tron.py::_problem``'s recipe: Gaussian columns,
    the last one an intercept."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    X[:, -1] = 1.0
    w_true = rng.normal(size=d)
    if sparse_truth:
        w_true[1:5] = 0.0
    if loss == "squared":
        y = X @ w_true + 0.1 * rng.normal(size=n)
    elif loss == "poisson":
        y = rng.poisson(np.exp(np.clip(X @ w_true * 0.3, -3, 3))).astype(
            float)
    else:
        y = (rng.random(n) < 1 / (1 + np.exp(-(X @ w_true)))).astype(float)
    off = rng.normal(size=n) * 0.05
    wt = rng.uniform(0.5, 1.5, size=n)
    return X, y, off, wt


def _sides(arrays, loss, l2):
    jobj = ja.GLMObjective(loss=jl.get_loss(loss), l2_lambda=l2)
    tobj = ta.GLMObjective(loss=tl.get_loss(loss), l2_lambda=l2)
    return ((jobj, JBatch(*map(jnp.asarray, arrays))),
            (tobj, TBatch(*map(torch.tensor, arrays))))


def _jvg(w, payload):
    obj, batch = payload
    return obj.calculate(w, batch)


def _jhvp(w, v, payload):
    obj, batch = payload
    return obj.hessian_vector(w, v, batch)


def _one_lane_vg(x, payload):
    obj, batch = payload
    f, g = obj.calculate(x[0], batch)
    return f[None], g[None]


def _one_lane_hvp(x, v, payload):
    obj, batch = payload
    return obj.hessian_vector(x[0], v[0], batch)[None]


def _lanes_vg(x, payload):
    obj, batch = payload
    return obj.calculate(x, batch)


def _lanes_hvp(x, v, payload):
    obj, batch = payload
    return obj.hessian_vector(x, v, batch)


def _assert_run_equal(j, t, rtol=RTOL):
    """(x, history, progressed) of a JAX run and a one-lane port run."""
    jx, jh, jprog = j
    tx, th, tprog = t
    k = int(jh.num_iterations)
    assert int(th.num_iterations[0]) == k
    assert bool(tprog[0]) == bool(jprog)
    np.testing.assert_allclose(tx[0].numpy(), np.asarray(jx), rtol=rtol,
                               atol=1e-13)
    np.testing.assert_allclose(th.values[0, :k + 1].numpy(),
                               np.asarray(jh.values)[:k + 1], rtol=rtol)
    np.testing.assert_allclose(th.grad_norms[0, :k + 1].numpy(),
                               np.asarray(jh.grad_norms)[:k + 1], rtol=rtol)
    return k


def test_pseudo_gradient_regions_exact():
    rng = np.random.default_rng(0)
    x = np.array([1.0, -1.0, 0.0, 0.0, 0.0, 0.0, 2.0, -3.0])
    g = np.array([0.5, 0.5, -2.0, 2.0, 0.3, -0.3, -4.0, 4.0])
    l1 = rng.uniform(0.5, 1.5, size=8)
    want = np.asarray(jowlqn.pseudo_gradient(jnp.asarray(x), jnp.asarray(g),
                                             jnp.asarray(l1)))
    got = towlqn.pseudo_gradient(*map(torch.tensor, (x, g, l1))).numpy()
    np.testing.assert_array_equal(got, want)
    # every region reached: x>0, x<0, and at zero below, above and inside
    assert got[0] == 0.5 + l1[0] and got[1] == 0.5 - l1[1]
    assert got[2] == -2.0 + l1[2] and got[3] == 2.0 - l1[3]
    assert got[4] == 0.0 and got[5] == 0.0


def test_owlqn_zero_l1_reaches_the_ports_lbfgs_solution():
    """Zero L1: the same minimum as L-BFGS (``test_owlqn_tron.py:62``; the
    line searches differ, so the paths do), and each solver equals its JAX
    counterpart run for run."""
    arrays = _data(1)
    (jobj, jb), (tobj, tb) = _sides(arrays, "logistic", 0.5)
    x0 = torch.zeros(1, 8, dtype=torch.float64)
    o = towlqn.minimize_owlqn(_one_lane_vg, x0, (tobj, tb), l1=0.0,
                              tolerance=1e-10)
    lb = tlbfgs.minimize_lbfgs(_one_lane_vg, x0, (tobj, tb),
                               tolerance=1e-10)
    np.testing.assert_allclose(o[0].numpy(), lb[0].numpy(), atol=1e-5)
    _assert_run_equal(jowlqn.minimize_owlqn(_jvg, jnp.zeros(8), (jobj, jb),
                                            l1=0.0, tolerance=1e-10), o)


@pytest.mark.parametrize("per_coordinate", [False, True],
                         ids=["scalar_l1", "per_coordinate_l1"])
@pytest.mark.parametrize("loss,l2", [("logistic", 0.0), ("poisson", 0.5),
                                     ("squared", 0.25)])
def test_owlqn_matches_jax(loss, l2, per_coordinate):
    arrays = _data(2, loss, sparse_truth=True)
    (jobj, jb), (tobj, tb) = _sides(arrays, loss, l2)
    if per_coordinate:
        l1 = np.full(8, 6.0)
        l1[-1] = 0.0  # intercept spared
        l1[:3] = 12.0
    else:
        l1 = 8.0
    j = jowlqn.minimize_owlqn(_jvg, jnp.zeros(8), (jobj, jb),
                              l1=jnp.asarray(l1), max_iter=60,
                              tolerance=1e-8)
    t = towlqn.minimize_owlqn(_one_lane_vg,
                              torch.zeros(1, 8, dtype=torch.float64),
                              (tobj, tb), l1=torch.tensor(l1),
                              max_iter=60, tolerance=1e-8)
    k = _assert_run_equal(j, t)
    assert k >= 3
    jzero = np.asarray(j[0]) == 0.0
    np.testing.assert_array_equal(t[0][0].numpy() == 0.0, jzero)
    assert jzero.any()


@pytest.mark.parametrize("loss,l2", [("squared", 1.0), ("logistic", 0.1),
                                     ("poisson", 0.5)])
def test_tron_matches_jax(loss, l2):
    arrays = _data(3, loss)
    (jobj, jb), (tobj, tb) = _sides(arrays, loss, l2)
    j = jtron.minimize_tron(_jvg, _jhvp, jnp.zeros(8), (jobj, jb),
                            max_iter=15, tolerance=1e-8)
    t = ttron.minimize_tron(_one_lane_vg, _one_lane_hvp,
                            torch.zeros(1, 8, dtype=torch.float64),
                            (tobj, tb), max_iter=15, tolerance=1e-8)
    k = _assert_run_equal(j, t)
    assert k >= 2
    vals = t[1].values[0, :k + 1].numpy()
    assert np.all(np.diff(vals) <= 0.0)


def _lane_data(loss, lanes=5, n=120, d=6):
    """Five lanes of different data and sizes (padded rows weigh 0)."""
    X = np.zeros((lanes, n, d))
    y, off, wt = (np.zeros((lanes, n)) for _ in range(3))
    for e in range(lanes):
        m = n - 17 * e
        Xe, ye, oe, we = _data(10 + e, loss, n=m, d=d)
        X[e, :m], y[e, :m], off[e, :m], wt[e, :m] = Xe, ye, oe, we
    return X, y, off, wt


@pytest.mark.parametrize("solver", ["owlqn", "tron"])
def test_lanes_equal_single_lane_runs(solver):
    loss = "poisson" if solver == "owlqn" else "logistic"
    X, y, off, wt = _lane_data(loss)
    obj = ta.GLMObjective(loss=tl.get_loss(loss), l2_lambda=0.3)
    L, _, d = X.shape

    def run(Xs, ys, os_, ws):
        batch = TBatch(*map(torch.tensor, (Xs, ys, os_, ws)))
        x0 = torch.zeros(Xs.shape[0], d, dtype=torch.float64)
        if solver == "owlqn":
            return towlqn.minimize_owlqn(_lanes_vg, x0, (obj, batch),
                                         l1=2.0, max_iter=40,
                                         tolerance=1e-8)
        return ttron.minimize_tron(_lanes_vg, _lanes_hvp, x0, (obj, batch),
                                   tolerance=1e-8)

    bx, bh, bp = run(X, y, off, wt)
    iters = bh.num_iterations.numpy()
    assert len(set(iters.tolist())) > 1  # the lanes finish apart
    for e in range(L):
        sx, sh, sp_ = run(X[e:e + 1], y[e:e + 1], off[e:e + 1],
                          wt[e:e + 1])
        k = int(sh.num_iterations[0])
        assert iters[e] == k and bool(bp[e]) == bool(sp_[0])
        np.testing.assert_allclose(bx[e].numpy(), sx[0].numpy(),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(bh.values[e, :k + 1].numpy(),
                                   sh.values[0, :k + 1].numpy(), rtol=1e-12)


def _config(mod, opt, reg, lam=1.0, alpha=0.5, iters=40, tol=1e-8):
    return mod.GLMOptimizationConfiguration(
        max_iterations=iters, tolerance=tol, regularization_weight=lam,
        optimizer_type=mod.OptimizerType[opt],
        regularization_context=mod.RegularizationContext(
            mod.RegularizationType[reg], alpha=alpha))


@pytest.mark.parametrize("task,opt,reg,lam", [
    ("LOGISTIC_REGRESSION", "LBFGS", "L2", 6.0),
    ("POISSON_REGRESSION", "LBFGS", "ELASTIC_NET", 40.0),
    ("LOGISTIC_REGRESSION", "LBFGS", "L1", 6.0),
    ("LINEAR_REGRESSION", "TRON", "L2", 6.0),
])
def test_problem_dispatch_matches_jax(task, opt, reg, lam):
    loss = {"LOGISTIC_REGRESSION": "logistic",
            "POISSON_REGRESSION": "poisson",
            "LINEAR_REGRESSION": "squared"}[task]
    X, y, off, wt = _data(5, loss, sparse_truth=True)
    jp = JProblem(config=_config(jcfg, opt, reg, lam=lam),
                  task=jcfg.TaskType[task])
    tp = TProblem(config=_config(tcfg, opt, reg, lam=lam),
                  task=tcfg.TaskType[task])
    jm, jr = jp.run(JBatch(*map(jnp.asarray, (X, y, off, wt))))
    tm, tr = tp.run(TBatch(*map(torch.tensor, (X, y, off, wt))))
    assert tr.iterations == jr.iterations
    assert tr.convergence_reason.value == jr.convergence_reason.value
    jw = np.asarray(jm.coefficients.means)
    tw = tm.coefficients.means.numpy()
    np.testing.assert_allclose(tw, jw, rtol=RTOL, atol=1e-13)
    np.testing.assert_array_equal(tw == 0.0, jw == 0.0)
    if reg in ("L1", "ELASTIC_NET"):
        assert (jw == 0.0).any()
    assert tr.value == pytest.approx(jr.value, rel=RTOL)


def test_smoothed_hinge_with_tron_is_refused():
    with pytest.raises(ValueError):
        JProblem(config=_config(jcfg, "TRON", "L2"),
                 task=jcfg.TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)
    with pytest.raises(ValueError):
        TProblem(config=_config(tcfg, "TRON", "L2"),
                 task=tcfg.TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)
    # TRON with an L1 penalty is refused by the configuration itself
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError):
            _config(mod, "TRON", "L1")


@pytest.mark.parametrize("opt,reg", [("TRON", "L2"), ("LBFGS", "L2"),
                                     ("LBFGS", "ELASTIC_NET")])
def test_variances_match_jax_publish(opt, reg):
    X, y, off, wt = _data(6, "logistic")
    jp = JProblem(config=_config(jcfg, opt, reg), compute_variances=True,
                  task=jcfg.TaskType.LOGISTIC_REGRESSION)
    tp = TProblem(config=_config(tcfg, opt, reg), compute_variances=True,
                  task=tcfg.TaskType.LOGISTIC_REGRESSION)
    jm, _ = jp.run(JBatch(*map(jnp.asarray, (X, y, off, wt))))
    tm, _ = tp.run(TBatch(*map(torch.tensor, (X, y, off, wt))))
    want = np.asarray(jm.coefficients.variances)
    got = tm.coefficients.variances.numpy()
    assert np.all(got > 0) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # run_lazy computes none, on either side
    lazy = tp.run_lazy(TBatch(*map(torch.tensor, (X, y, off, wt))))
    assert not hasattr(lazy, "variances")
    no_var = TProblem(config=_config(tcfg, opt, reg),
                      task=tcfg.TaskType.LOGISTIC_REGRESSION)
    assert no_var.run(TBatch(*map(torch.tensor, (X, y, off, wt))))[0] \
        .coefficients.variances is None


@pytest.mark.parametrize("reg,alpha", [("L1", 0.5), ("ELASTIC_NET", 0.5),
                                       ("ELASTIC_NET", 0.2), ("L2", 0.5),
                                       ("NONE", 0.5)])
def test_regularization_value_matches_jax(reg, alpha):
    w = np.random.default_rng(7).normal(size=9)
    jp = JProblem(config=_config(jcfg, "LBFGS", reg, lam=3.0, alpha=alpha),
                  task=jcfg.TaskType.LINEAR_REGRESSION)
    tp = TProblem(config=_config(tcfg, "LBFGS", reg, lam=3.0, alpha=alpha),
                  task=tcfg.TaskType.LINEAR_REGRESSION)
    want = jp.regularization_value(jnp.asarray(w))
    got = tp.regularization_value(torch.tensor(w))
    assert got == pytest.approx(want, rel=1e-13, abs=0.0)
    if reg == "NONE":
        assert got == 0.0 and tp.regularization_value_device(
            torch.tensor(w)) == 0.0

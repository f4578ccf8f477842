"""PyTorch port vs the JAX package: lane-batched L-BFGS and line search.

The port's solver is lane-batched by construction; the JAX solver is one
lane, ``vmap``ped over entities. Small logistic problems in f64 on both
sides: the iterates agree to rtol 1e-8, the per-iteration values and
gradient norms to rtol 1e-8 up to each lane's ``num_iterations``, and the
iteration counts and convergence reasons / ``CONV_*`` codes are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.batch import DenseBatch as JBatch
from photon_ml_tpu.game import random_effect as jre
from photon_ml_tpu.ops import aggregators as ja
from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.optimize import common as jcommon
from photon_ml_tpu.optimize import lbfgs as jlbfgs
from photon_ml_tpu_torch.data.batch import DenseBatch as TBatch
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.ops import aggregators as ta
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.optimize import common as tcommon
from photon_ml_tpu_torch.optimize import linesearch as tls
from photon_ml_tpu_torch.optimize import lbfgs as tlbfgs

torch.set_num_threads(1)
TOL = 1e-7


def _problem(n, d, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * scale
    w_true = rng.normal(size=d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-X @ w_true))).astype(float)
    off = rng.normal(size=n) * 0.1
    wt = rng.uniform(0.5, 1.5, size=n)
    return X, y, off, wt


def _jvg(w, payload):
    obj, batch = payload
    return obj.calculate(w, batch)


def _tvg(x, payload):
    obj, batch = payload
    return obj.calculate(x, batch)


def _one_lane_tvg(x, payload):
    obj, batch = payload
    f, g = obj.calculate(x[0], batch)
    return f[None], g[None]


@pytest.mark.parametrize("l2,max_iter", [(1.0, 100), (0.01, 5)])
def test_one_lane_matches_jax(l2, max_iter):
    X, y, off, wt = _problem(300, 10, seed=0)
    jobj = ja.GLMObjective(loss=jl.get_loss("logistic"), l2_lambda=l2)
    tobj = ta.GLMObjective(loss=tl.get_loss("logistic"), l2_lambda=l2)
    jx, jh, jprog = jlbfgs.minimize_lbfgs(
        _jvg, jnp.zeros(10), (jobj, JBatch(*map(jnp.asarray,
                                                (X, y, off, wt)))),
        max_iter=max_iter, tolerance=TOL)
    tx, th, tprog = tlbfgs.minimize_lbfgs(
        _one_lane_tvg, torch.zeros(1, 10, dtype=torch.float64),
        (tobj, TBatch(*map(torch.tensor, (X, y, off, wt)))),
        max_iter=max_iter, tolerance=TOL)
    k = int(jh.num_iterations)
    assert int(th.num_iterations[0]) == k
    np.testing.assert_allclose(tx[0].numpy(), np.asarray(jx), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(th.values[0, :k + 1].numpy(),
                               np.asarray(jh.values)[:k + 1], rtol=1e-8)
    np.testing.assert_allclose(th.grad_norms[0, :k + 1].numpy(),
                               np.asarray(jh.grad_norms)[:k + 1], rtol=1e-8)
    assert np.isnan(th.values[0, k + 1:].numpy()).all()
    jr = jcommon.OptimizationResult.from_history(
        jx, jh, max_iter, TOL, bool(jprog))
    tr = tcommon.OptimizationResult.from_history(
        tx[0], th, max_iter, TOL, bool(tprog[0]))
    assert tr.convergence_reason.value == jr.convergence_reason.value
    if max_iter == 5:
        assert tr.convergence_reason == \
            tcommon.ConvergenceReason.MAX_ITERATIONS


@pytest.fixture(scope="module")
def lanes():
    """Six entity lanes: easy ones, an ill-conditioned one that runs out of
    iterations, and one with zero weights (a stationary start: it stops at
    iteration 0 with GradientConverged)."""
    E, N, D = 6, 40, 5
    Xs, ys, offs, wts = [], [], [], []
    for e in range(E):
        X, y, off, wt = _problem(N, D, seed=10 + e,
                                 scale=30.0 if e == 2 else 1.0)
        if e == 4:
            wt = np.zeros(N)
        Xs.append(X), ys.append(y), offs.append(off), wts.append(wt)
    return tuple(np.stack(a) for a in (Xs, ys, offs, wts))


def test_lane_batched_matches_vmapped_jax(lanes):
    X, y, off, wt = lanes
    E, _, D = X.shape
    max_iter = 15
    jobj = ja.GLMObjective(loss=jl.get_loss("logistic"), l2_lambda=1e-3)
    tobj = ta.GLMObjective(loss=tl.get_loss("logistic"), l2_lambda=1e-3)

    def one(Xe, ye, oe, we):
        return jlbfgs.minimize_lbfgs(
            _jvg, jnp.zeros(D), (jobj, JBatch(Xe, ye, oe, we)),
            max_iter=max_iter, tolerance=TOL)

    jx, jh, jprog = jax.vmap(one)(*map(jnp.asarray, lanes))
    tx, th, tprog = tlbfgs.minimize_lbfgs(
        _tvg, torch.zeros(E, D, dtype=torch.float64),
        (tobj, TBatch(*map(torch.tensor, lanes))), max_iter=max_iter,
        tolerance=TOL)
    ks = np.asarray(jh.num_iterations)
    np.testing.assert_array_equal(th.num_iterations.numpy(), ks)
    assert ks[4] == 0 and ks[2] == max_iter and (ks < max_iter).sum() >= 3
    np.testing.assert_array_equal(tprog.numpy(), np.asarray(jprog))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-8,
                               atol=1e-10)
    for e, k in enumerate(ks):
        np.testing.assert_allclose(th.values[e, :k + 1].numpy(),
                                   np.asarray(jh.values)[e, :k + 1],
                                   rtol=1e-8)
        np.testing.assert_allclose(th.grad_norms[e, :k + 1].numpy(),
                                   np.asarray(jh.grad_norms)[e, :k + 1],
                                   rtol=1e-8, atol=1e-300)


def test_fit_blocks_codes_match_jax(lanes):
    X, y, off, wt = lanes
    E, _, D = X.shape
    jobj = ja.GLMObjective(loss=jl.get_loss("logistic"), l2_lambda=1e-3)
    tobj = ta.GLMObjective(loss=tl.get_loss("logistic"), l2_lambda=1e-3)
    jc, jit, jv, jk = jre._fit_blocks_impl(
        *map(jnp.asarray, lanes), jnp.zeros((E, D)), jobj, jnp.zeros(D),
        "lbfgs", 15, TOL)
    tc, tit, tv, tk = tre._fit_blocks_impl(
        *map(torch.tensor, lanes), torch.zeros(E, D, dtype=torch.float64),
        tobj, torch.zeros(D, dtype=torch.float64), "lbfgs", 15, TOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tit.numpy(), np.asarray(jit))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-8)
    assert tk[2] == tre.CONV_MAX_ITERATIONS
    assert tk[4] == tre.CONV_GRADIENT


def test_cubic_min_matches_jax():
    from photon_ml_tpu.optimize.linesearch import _cubic_min as jcubic

    rng = np.random.default_rng(3)
    args = [rng.normal(size=64) for _ in range(6)]
    args[3] = args[0] + rng.uniform(0.1, 2.0, 64)  # b > a
    np.testing.assert_allclose(
        tls._cubic_min(*map(torch.tensor, args)).numpy(),
        np.asarray(jcubic(*map(jnp.asarray, args))), rtol=1e-12)


def test_glm_problem_run_matches_jax():
    from photon_ml_tpu.optimize import config as jcfg
    from photon_ml_tpu.optimize.problem import GLMOptimizationProblem as JP
    from photon_ml_tpu_torch.optimize import config as tcfg
    from photon_ml_tpu_torch.optimize.problem import \
        GLMOptimizationProblem as TP

    X, y, off, wt = _problem(300, 10, seed=4)

    def cfg(m):
        return m.GLMOptimizationConfiguration(
            max_iterations=50, tolerance=TOL, regularization_weight=2.0,
            regularization_context=m.RegularizationContext(
                m.RegularizationType.L2))

    jmodel, jres = JP(config=cfg(jcfg),
                      task=jcfg.TaskType.LOGISTIC_REGRESSION).run(
        JBatch(*map(jnp.asarray, (X, y, off, wt))))
    tprob = TP(config=cfg(tcfg), task=tcfg.TaskType.LOGISTIC_REGRESSION)
    tmodel, tres = tprob.run(TBatch(*map(torch.tensor, (X, y, off, wt))))
    assert tres.iterations == jres.iterations
    assert tres.convergence_reason.value == jres.convergence_reason.value
    np.testing.assert_allclose(tmodel.coefficients.means.numpy(),
                               np.asarray(jmodel.coefficients.means),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(tres.values, jres.values, rtol=1e-8)
    w = tmodel.coefficients.means
    assert tprob.regularization_value(w) == pytest.approx(
        float((w * w).sum()), rel=1e-12)

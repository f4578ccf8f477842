"""PyTorch port vs the JAX package: ``train_glm_grid`` and the solvers'
box constraints and iterate tracking.

The same numpy inputs (made from a seed, f64, the suite's x64 on) go
through ``photon_ml_tpu.training.train_glm_grid`` and the port's, for
L-BFGS + L2, OWL-QN with L1, OWL-QN with an elastic net whose ``l1_mask``
spares the intercept, and TRON + L2; each with and without a box on three
coordinates, with and without STANDARDIZATION (both sides built from the
one JAX summary, so the factors are the same bits), with iterates
tracked and variances computed, over a three-weight warm-started grid.
Per weight: equal iteration counts and convergence reasons; normalized
and raw coefficients, per-iteration values, iterates and variances to
rtol 1e-9 (``tests/test_torch_owlqn_tron.py``'s), with an atol of 1e-10
for the components near zero, whose rounding is that of the O(1) terms
they are sums of. ``initial_by_weight``
takes precedence over the warm start on both sides; the box holds and
binds; the slice's f32 form (x64 off) agrees to rel 1e-4 in the
objective (the legacy driver's tolerance 1e-6 throughout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu import training as jtraining
from photon_ml_tpu.data.batch import dense_batch as jdense
from photon_ml_tpu.ops.normalization import NormalizationContext as JNorm
from photon_ml_tpu.ops.normalization import NormalizationType as JNT
from photon_ml_tpu.optimize import common as jcommon
from photon_ml_tpu.optimize import config as jcfg
from photon_ml_tpu.stat.summary import summarize as jsummarize
from photon_ml_tpu_torch import training as ttraining
from photon_ml_tpu_torch.data.batch import dense_batch as tdense
from photon_ml_tpu_torch.ops.normalization import NormalizationContext as TNorm
from photon_ml_tpu_torch.ops.normalization import NormalizationType as TNT
from photon_ml_tpu_torch.optimize import common as tcommon
from photon_ml_tpu_torch.optimize import config as tcfg

torch.set_num_threads(1)
RTOL = 1e-9
LAMBDAS = (10.0, 1.0, 0.1)
BOX = {0: (-0.1, 0.1), 1: (-0.05, 0.2), 2: (0.0, 0.3)}
SOLVERS = {
    # name: (task, optimizer, regularization type, elastic-net mask?)
    "lbfgs": ("LOGISTIC_REGRESSION", "LBFGS", "L2", False),
    "owlqn_l1": ("LOGISTIC_REGRESSION", "LBFGS", "L1", False),
    "owlqn_elastic_net": ("LINEAR_REGRESSION", "LBFGS", "ELASTIC_NET", True),
    "tron": ("POISSON_REGRESSION", "TRON", "L2", False),
}


def _data(seed, task, n=300, d=8):
    """Badly scaled Gaussian columns, the last one the intercept."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 4.0, size=d) \
        + rng.normal(size=d)
    X[:, -1] = 1.0
    w = rng.normal(size=d) / np.sqrt(d)
    z = (X - X.mean(0)) @ w
    if task == "LINEAR_REGRESSION":
        y = z + 0.1 * rng.normal(size=n)
    elif task == "POISSON_REGRESSION":
        y = rng.poisson(np.exp(np.clip(0.3 * z, -3, 3))).astype(float)
    else:
        y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(float)
    off = rng.normal(size=n) * 0.05
    wt = rng.uniform(0.5, 1.5, size=n)
    return X, y, off, wt


def _grid(mod, batch, name, norm, box, mask, max_iterations=30, **kw):
    task, opt, reg, masked = SOLVERS[name]
    return mod.train_glm_grid(
        batch, mod_cfg(mod).TaskType[task], LAMBDAS,
        optimizer_type=mod_cfg(mod).OptimizerType[opt],
        regularization_context=mod_cfg(mod).RegularizationContext(
            mod_cfg(mod).RegularizationType[reg], 0.5),
        max_iterations=max_iterations, tolerance=1e-6, normalization=norm, box=box,
        compute_variances=True, l1_mask=mask if masked else None,
        track_iterates=True, **kw)


def mod_cfg(mod):
    return jcfg if mod is jtraining else tcfg


def _both(name, standardize, boxed, seed=0, dtype=np.float64):
    d = 8
    X, y, off, wt = _data(seed, SOLVERS[name][0], d=d)
    jb = jdense(X, y, off, wt, dtype=jnp.dtype(dtype))
    tb = tdense(X, y, off, wt, dtype=torch.float64 if dtype == np.float64
                else torch.float32, device="cpu")
    jn, tn = JNorm(), TNorm()
    if standardize:
        summary = jsummarize(X)
        jn = JNorm.build(JNT.STANDARDIZATION, summary, intercept_index=d - 1)
        tn = TNorm.build(TNT.STANDARDIZATION, summary, intercept_index=d - 1,
                         device="cpu")
    jbox = jcommon.BoxConstraints.from_map(d, BOX if boxed else None)
    tbox = tcommon.BoxConstraints.from_map(d, BOX if boxed else None)
    mask = np.ones(d)
    mask[-1] = 0.0
    return (jb, jn, jbox, jnp.asarray(mask)), (tb, tn, tbox,
                                               torch.tensor(mask))


def _close(a, b, rtol=RTOL, atol=1e-10):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("boxed", [False, True], ids=["free", "box"])
@pytest.mark.parametrize("standardize", [False, True],
                         ids=["raw", "standardized"])
@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_train_glm_grid_matches_jax(name, standardize, boxed):
    (jb, jn, jbox, jmask), (tb, tn, tbox, tmask) = _both(
        name, standardize, boxed)
    jout = _grid(jtraining, jb, name, jn, jbox, jmask)
    tout = _grid(ttraining, tb, name, tn, tbox, tmask)
    assert [m.regularization_weight for m in tout] == list(LAMBDAS)
    for jm, tm in zip(jout, tout):
        jr, tr = jm.result, tm.result
        assert tr.iterations == jr.iterations
        assert tr.convergence_reason.value == jr.convergence_reason.value
        # a boxed L-BFGS keeps stepping into the bound and runs to its
        # cap; over the grid's 90 iterations the rounding differences
        # grow from 1e-16 to 1e-8 (measured), so that case compares to
        # rtol 1e-6
        rtol, atol = ((1e-6, 1e-8) if boxed and name == "lbfgs"
                      else (RTOL, 1e-10))
        _close(jr.coefficients, tr.coefficients, rtol, atol)
        _close(jm.model.coefficients.means, tm.model.coefficients.means,
               rtol, atol)
        _close(jr.values, tr.values, rtol, atol)
        _close(jr.iterates, tr.iterates, rtol, atol)
        assert tr.iterates.shape == (tr.iterations + 1, 8)
        # the last tracked row is the solution
        np.testing.assert_array_equal(tr.iterates[-1],
                                      tr.coefficients.numpy())
        _close(jm.model.coefficients.variances,
               tm.model.coefficients.variances, rtol, atol)
        if boxed:
            x = tr.coefficients.numpy()
            for i, (lo, hi) in BOX.items():
                assert lo <= x[i] <= hi


def test_the_box_binds_and_holds_every_iterate():
    (jb, jn, jbox, _), (tb, tn, tbox, _) = _both("lbfgs", False, True)
    tout = _grid(ttraining, tb, "lbfgs", tn, tbox, None)
    x = tout[-1].result.coefficients.numpy()
    on_bound = [i for i, (lo, hi) in BOX.items() if x[i] in (lo, hi)]
    assert on_bound, x
    for tm in tout:
        its = tm.result.iterates
        for i, (lo, hi) in BOX.items():
            assert np.all(its[:, i] >= lo) and np.all(its[:, i] <= hi)


@pytest.mark.parametrize("name", ["lbfgs", "tron"])
def test_initial_by_weight_takes_precedence(name):
    (jb, jn, jbox, jmask), (tb, tn, tbox, tmask) = _both(name, True, False,
                                                        seed=3)
    starts = {1.0: np.linspace(-0.2, 0.2, 8)}
    jout = _grid(jtraining, jb, name, jn, None, jmask,
                 initial_by_weight={1.0: jnp.asarray(starts[1.0])})
    tout = _grid(ttraining, tb, name, tn, None, tmask,
                 initial_by_weight=starts)
    for jm, tm in zip(jout, tout):
        assert tm.result.iterations == jm.result.iterations
        _close(jm.result.coefficients, tm.result.coefficients)
        _close(jm.result.iterates, tm.result.iterates)
    # the 1.0 solve started from the given point, not the 10.0 optimum
    np.testing.assert_array_equal(tout[1].result.iterates[0], starts[1.0])


def test_warm_start_off_starts_every_weight_at_zero():
    (jb, jn, _, _), (tb, tn, _, _) = _both("lbfgs", False, False, seed=4)
    jout = _grid(jtraining, jb, "lbfgs", jn, None, None, warm_start=False)
    tout = _grid(ttraining, tb, "lbfgs", tn, None, None, warm_start=False)
    for jm, tm in zip(jout, tout):
        assert not tm.result.iterates[0].any()
        _close(jm.result.coefficients, tm.result.coefficients)


def test_empty_grid_refused_on_both_sides():
    (jb, *_), (tb, *_) = _both("lbfgs", False, False)
    with pytest.raises(ValueError):
        jtraining.train_glm_grid(jb, jcfg.TaskType.LOGISTIC_REGRESSION, [])
    with pytest.raises(ValueError):
        ttraining.train_glm_grid(tb, tcfg.TaskType.LOGISTIC_REGRESSION, [])


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_f32_slice_matches_jax_without_x64(name):
    """The driver's precision: f32 data and iterates, x64 off on the JAX
    side; objectives to rel 1e-4 (f32 stopping noise). Unboxed: a boxed
    L-BFGS in f32 stalls against the bound short of any tolerance, and
    its two runs part in the fourth digit (180.22 against 180.28 at
    80 iterations)."""
    with jax.enable_x64(False):
        (jb, jn, jbox, jmask), (tb, tn, tbox, tmask) = _both(
            name, True, False, seed=5, dtype=np.float32)
        jout = _grid(jtraining, jb, name, jn, jbox, jmask,
                     max_iterations=80)
        jvals = [(float(m.result.value),
                  np.asarray(m.model.coefficients.means)) for m in jout]
    tout = _grid(ttraining, tb, name, tn, tbox, tmask, max_iterations=80)
    for (jv, jw), tm in zip(jvals, tout):
        assert tm.result.value == pytest.approx(jv, rel=1e-4)
        w = tm.model.coefficients.means.numpy()
        # coefficients along flat directions are set by f32 stopping noise
        assert np.linalg.norm(w - jw) <= 1e-2 * max(np.linalg.norm(jw), 1.0)

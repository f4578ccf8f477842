"""PyTorch port vs the JAX package: GLM objective aggregators.

f64 on both sides (the suite runs JAX with x64 on) and small batches, so
every sum stays on the plain two-pass path and agrees to rounding: rtol
1e-10. The 3-D ``[E, N, D]`` batch is compared with ``jax.vmap`` of the
JAX function over entity lanes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.batch import DenseBatch as JBatch
from photon_ml_tpu.ops import aggregators as ja
from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.ops.normalization import NormalizationContext as JNorm
from photon_ml_tpu_torch.data.batch import DenseBatch as TBatch
from photon_ml_tpu_torch.ops import aggregators as ta
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.ops.normalization import NormalizationContext as TNorm

torch.set_num_threads(1)
RTOL = 1e-10


def _arrays(shape_nd, seed=0, name="logistic"):
    rng = np.random.default_rng(seed)
    *lead, n, d = shape_nd
    X = rng.normal(size=(*lead, n, d))
    if name in ("squared", "poisson"):
        y = rng.poisson(1.0, size=(*lead, n)).astype(np.float64)
    else:
        y = (rng.uniform(size=(*lead, n)) < 0.5).astype(np.float64)
    off = rng.normal(size=(*lead, n)) * 0.1
    wt = rng.uniform(0.5, 2.0, size=(*lead, n))
    coef = rng.normal(size=(*lead, d)) * 0.2
    vec = rng.normal(size=(*lead, d))
    return X, y, off, wt, coef, vec


def _norms(d, normalized):
    if not normalized:
        return JNorm(), TNorm()
    rng = np.random.default_rng(5)
    f, s = rng.uniform(0.5, 2.0, d), rng.normal(size=d)
    s[0] = 0.0
    return (JNorm(jnp.asarray(f), jnp.asarray(s), intercept_index=0),
            TNorm(torch.tensor(f), torch.tensor(s), intercept_index=0))


def _batches(X, y, off, wt):
    return (JBatch(*(jnp.asarray(a) for a in (X, y, off, wt))),
            TBatch(*(torch.tensor(a) for a in (X, y, off, wt))))


def _check(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=1e-12)


@pytest.mark.parametrize("name", sorted(jl.LOSSES))
@pytest.mark.parametrize("normalized", [False, True])
def test_2d_aggregators_match_jax(name, normalized):
    X, y, off, wt, coef, vec = _arrays((200, 12), name=name)
    jb, tb = _batches(X, y, off, wt)
    jn, tn = _norms(12, normalized)
    jloss, tloss = jl.get_loss(name), tl.get_loss(name)
    jc, tc = jnp.asarray(coef), torch.tensor(coef)
    jv, tv = jnp.asarray(vec), torch.tensor(vec)

    jval, jgrad = ja.value_and_gradient(jloss, jn, jc, jb)
    tval, tgrad = ta.value_and_gradient(tloss, tn, tc, tb)
    _check(tval, jval)
    _check(tgrad, jgrad)
    _check(ta.hessian_vector(tloss, tn, tc, tv, tb),
           ja.hessian_vector(jloss, jn, jc, jv, jb))
    _check(ta.hessian_diagonal(tloss, tn, tc, tb),
           ja.hessian_diagonal(jloss, jn, jc, jb))

    jobj = ja.GLMObjective(loss=jloss, norm=jn, l2_lambda=0.7)
    tobj = ta.GLMObjective(loss=tloss, norm=tn, l2_lambda=0.7)
    for got, want in zip(tobj.calculate(tc, tb), jobj.calculate(jc, jb)):
        _check(got, want)
    _check(tobj.hessian_vector(tc, tv, tb), jobj.hessian_vector(jc, jv, jb))
    _check(tobj.hessian_diagonal(tc, tb), jobj.hessian_diagonal(jc, jb))


@pytest.mark.parametrize("name", ["logistic", "poisson"])
def test_3d_entity_batch_matches_vmapped_jax(name):
    X, y, off, wt, coef, vec = _arrays((5, 24, 7), seed=1, name=name)
    wt[1, 10:] = 0.0  # padded rows of a short entity
    jloss, tloss = jl.get_loss(name), tl.get_loss(name)
    jobj = ja.GLMObjective(loss=jloss, l2_lambda=1.3)
    tobj = ta.GLMObjective(loss=tloss, l2_lambda=1.3)

    def one(c, v, Xe, ye, oe, we):
        b = JBatch(Xe, ye, oe, we)
        f, g = jobj.calculate(c, b)
        return f, g, jobj.hessian_vector(c, v, b), jobj.hessian_diagonal(c, b)

    want = jax.vmap(one)(*(jnp.asarray(a) for a in (coef, vec, X, y, off,
                                                    wt)))
    _, tb = _batches(X, y, off, wt)
    tc, tv = torch.tensor(coef), torch.tensor(vec)
    f, g = tobj.calculate(tc, tb)
    assert f.shape == (5,) and g.shape == (5, 7)
    got = (f, g, tobj.hessian_vector(tc, tv, tb),
           tobj.hessian_diagonal(tc, tb))
    for a, b in zip(got, want):
        _check(a, b)


def test_2d_batch_on_cpu_never_takes_the_kernel_gate():
    X, y, off, wt, coef, _ = _arrays((4096, 1024), seed=2)
    _, tb = _batches(X.astype(np.float32), y.astype(np.float32),
                     off.astype(np.float32), wt.astype(np.float32))
    w = torch.tensor(coef, dtype=torch.float32)
    assert ta._pallas_sums(tl.get_loss("logistic"), w,
                           torch.zeros(()), tb) is None


def test_dense_batch_and_score_batch_match_jax():
    from photon_ml_tpu.data.batch import dense_batch as jdense
    from photon_ml_tpu.models import glm as jglm
    from photon_ml_tpu.optimize.config import TaskType as JTask
    from photon_ml_tpu_torch.data.batch import dense_batch as tdense
    from photon_ml_tpu_torch.models import glm as tglm
    from photon_ml_tpu_torch.optimize.config import TaskType as TTask

    X, y, off, wt, coef, _ = _arrays((50, 6), seed=3)
    jb = jdense(X, y, off, wt, dtype=jnp.float32)
    tb = tdense(X, y, off, wt, dtype=torch.float32, device="cpu")
    for f in ("X", "labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)))
    tb1 = tdense(X, y, device="cpu")
    assert float(tb1.weights.sum()) == 50
    assert float(tb1.offsets.abs().sum()) == 0
    jm = jglm.GeneralizedLinearModel(jglm.Coefficients(jnp.asarray(coef)),
                                     JTask.LOGISTIC_REGRESSION)
    tm = tglm.GeneralizedLinearModel(tglm.Coefficients(torch.tensor(coef)),
                                     TTask.LOGISTIC_REGRESSION)
    jb64, tb64 = _batches(X, y, off, wt)
    _check(tglm.score_batch(tm, tb64), jglm.score_batch(jm, jb64))
    _check(tm.predict(tb64.X, tb64.offsets), jm.predict(jb64.X, jb64.offsets))

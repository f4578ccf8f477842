"""PyTorch port vs the JAX package: pointwise losses and normalization.

Both sides compute in f64 on the CPU (the suite runs JAX with x64 on), on
the same numpy inputs, so the tolerance is rounding-level: rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.ops import normalization as jn
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.ops import normalization as tn

torch.set_num_threads(1)


def _margins_and_labels(name):
    rng = np.random.default_rng(0)
    z = np.concatenate([np.linspace(-50.0, 50.0, 2001),
                        rng.uniform(-50.0, 50.0, 500)])
    if name in ("squared", "poisson"):
        y = rng.uniform(0.0, 5.0, size=z.shape)
    else:
        y = (rng.uniform(size=z.shape) < 0.5).astype(np.float64)
    return z, y


@pytest.mark.parametrize("name", sorted(jl.LOSSES))
@pytest.mark.parametrize("part", ["loss", "d1", "d2"])
def test_loss_parts_match_jax(name, part):
    z, y = _margins_and_labels(name)
    want = np.asarray(getattr(jl.get_loss(name), part)(
        jnp.asarray(z, jnp.float64), jnp.asarray(y, jnp.float64)))
    got = getattr(tl.get_loss(name), part)(
        torch.tensor(z, dtype=torch.float64),
        torch.tensor(y, dtype=torch.float64)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape),
                               rtol=1e-12, atol=0)


def test_log1p_exp_and_sigmoid_match_jax():
    x = np.linspace(-700.0, 700.0, 4001)
    np.testing.assert_allclose(
        tl.log1p_exp(torch.tensor(x)).numpy(),
        np.asarray(jl.log1p_exp(jnp.asarray(x))), rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        tl.sigmoid(torch.tensor(x)).numpy(),
        np.asarray(jl.sigmoid(jnp.asarray(x))), rtol=1e-12, atol=0)


def test_loss_codes_cover_every_loss():
    assert sorted(tl.LOSS_CODES) == sorted(jl.LOSSES)
    assert sorted(tl.LOSS_CODES.values()) == [0, 1, 2, 3]


@pytest.mark.parametrize("kind", ["factors", "factors_and_shifts"])
def test_normalization_algebra_matches_jax(kind):
    d = 9
    rng = np.random.default_rng(1)
    factors = rng.uniform(0.2, 3.0, d)
    factors[0] = 1.0  # the intercept keeps factor 1 and shift 0
    shifts = None
    if kind == "factors_and_shifts":
        shifts = rng.normal(size=d)
        shifts[0] = 0.0
    jctx = jn.NormalizationContext(
        factors=jnp.asarray(factors),
        shifts=None if shifts is None else jnp.asarray(shifts),
        intercept_index=0)
    tctx = tn.NormalizationContext(
        factors=torch.tensor(factors),
        shifts=None if shifts is None else torch.tensor(shifts),
        intercept_index=0)
    coef = rng.normal(size=d)
    vs = rng.normal(size=d)
    ps = torch.tensor(1.7, dtype=torch.float64)
    jw, jshift = jctx.effective_coefficients(jnp.asarray(coef))
    tw, tshift = tctx.effective_coefficients(torch.tensor(coef))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-12)
    np.testing.assert_allclose(float(tshift), float(jshift), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(
        tctx.reconstruct_gradient(torch.tensor(vs), ps).numpy(),
        np.asarray(jctx.reconstruct_gradient(jnp.asarray(vs),
                                             jnp.asarray(1.7))),
        rtol=1e-12)
    np.testing.assert_allclose(
        tctx.transform_model_coefficients(torch.tensor(coef)).numpy(),
        np.asarray(jctx.transform_model_coefficients(jnp.asarray(coef))),
        rtol=1e-12)
    # a lane axis [L, D] acts row by row
    lanes = rng.normal(size=(3, d))
    tw3, tshift3 = tctx.effective_coefficients(torch.tensor(lanes))
    for e in range(3):
        jw_e, js_e = jctx.effective_coefficients(jnp.asarray(lanes[e]))
        np.testing.assert_allclose(tw3[e].numpy(), np.asarray(jw_e),
                                   rtol=1e-12)
        np.testing.assert_allclose(float(tshift3[e]), float(js_e),
                                   rtol=1e-12, atol=1e-15)


def test_identity_normalization_is_a_no_op():
    ctx = tn.NormalizationContext()
    c = torch.arange(4.0, dtype=torch.float64)
    w, shift = ctx.effective_coefficients(c)
    assert w is c and float(shift) == 0.0
    assert ctx.transform_model_coefficients(c) is c

"""PyTorch port vs the JAX package: the fused value+gradient module.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against its plain version there). Here the plain version — the only path a
CPU tensor takes — is held against the JAX Pallas kernel, run in interpret
mode exactly as ``tests/test_pallas.py`` runs it, and against the JAX
two-pass form ``_xla_sums``. f32 inputs on both sides; the tolerances are
``test_pallas.py``'s: value rel 2e-5, prefactor rel 2e-5 / abs 1e-4,
vector rtol = atol = 2e-4 (f32 sums taken in another order). A bf16 X is
checked with that file's bf16 bounds (rel 2e-2 on the value, rel/atol
5e-2 and abs 0.5 elsewhere): the TPU kernel rounds w and l' to bf16 for its
MXU, the port keeps them f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.ops import pallas_kernels as jpk
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.ops import pallas_kernels as tpk

torch.set_num_threads(1)


def _case(n, d, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    w = (rng.normal(size=d) * 0.05).astype(np.float32)
    return X, y, off, wt, w


def _port(name, X, y, off, wt, w, shift, dtype=torch.float32):
    t = torch.from_numpy
    return tpk.fused_value_gradient_sums(
        tl.get_loss(name), t(X).to(dtype), t(y), t(off), t(wt), t(w),
        torch.tensor(shift, dtype=torch.float32), device="cpu")


def _jax_kernel(name, X, y, off, wt, w, shift, dtype=jnp.float32):
    return jpk.fused_value_gradient_sums(
        jl.get_loss(name), True, jnp.asarray(X, dtype), jnp.asarray(y),
        jnp.asarray(off), jnp.asarray(wt), jnp.asarray(w),
        jnp.float32(shift))


def _close(got, want, rel=2e-5, vrtol=2e-4, vatol=2e-4, pre_abs=1e-4):
    v, vec, pre = (np.asarray(a, dtype=np.float64) for a in got)
    rv, rvec, rpre = (np.asarray(a, dtype=np.float64) for a in want)
    assert float(v) == pytest.approx(float(rv), rel=rel)
    assert float(pre) == pytest.approx(float(rpre), rel=rel, abs=pre_abs)
    np.testing.assert_allclose(vec, rvec, rtol=vrtol, atol=vatol)


@pytest.mark.parametrize("name", sorted(jl.LOSSES))
@pytest.mark.parametrize("n,d,seed", [(700, 128, 0), (1024, 256, 1)])
def test_plain_version_matches_pallas_interpret(name, n, d, seed):
    """700: a ragged edge tile for the TPU kernel; 1024: an exact one."""
    args = _case(n, d, seed) + (0.31,)
    got = _port(name, *args)
    assert all(t.dtype == torch.float32 for t in got)
    _close(got, _jax_kernel(name, *args))
    _close(got, jpk._xla_sums(jl.get_loss(name), *(jnp.asarray(a) for a in
                                                   args[:5]),
                              jnp.float32(0.31)))


@pytest.mark.parametrize("name", ["logistic", "squared"])
def test_bf16_design_matrix(name):
    args = _case(700, 128, seed=3) + (0.1,)
    got = _port(name, *args, dtype=torch.bfloat16)
    assert got[1].dtype == torch.float32
    _close(got, _jax_kernel(name, *args, dtype=jnp.bfloat16), rel=2e-2,
           vrtol=5e-2, vatol=0.5, pre_abs=0.5)
    # and against the f32 two-pass reference, like test_pallas.py
    _close(got, _port(name, *args), rel=2e-2, vrtol=5e-2, vatol=0.5,
           pre_abs=0.5)


@pytest.mark.parametrize("n,d", [(1 << 11, 1024), (1 << 10, 1024),
                                 (1 << 21, 1), (1 << 20, 4096),
                                 (1 << 20, 4097), (100, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_gate_thresholds_match_jax(n, d, dtype):
    """Same decision as ``pallas_supported`` apart from its backend test:
    the JAX gate wants a TPU, the port's a CUDA device."""
    want = (dtype in ("float32", "bfloat16")
            and d <= jpk.MAX_PALLAS_DIM and n * d >= jpk.MIN_PALLAS_ELEMENTS)
    tdt = getattr(torch, dtype)
    assert tpk.pallas_supported(n, d, tdt, torch.device("cuda")) == want
    # on the CPU both gates refuse
    assert not tpk.pallas_supported(n, d, tdt, "cpu")
    assert not jpk.pallas_supported(n, d, getattr(jnp, dtype))


def test_autograd_through_plain_version_equals_vector_sum():
    X, y, off, wt, w = (torch.from_numpy(a).double()
                        for a in _case(300, 64, seed=2))
    wv = w.clone().requires_grad_(True)
    val, vec, _ = tpk.fused_value_gradient_sums(
        tl.get_loss("logistic"), X, y, off, wt, wv,
        torch.tensor(0.2, dtype=torch.float64), device="cpu")
    (grad,) = torch.autograd.grad(val, wv)
    # f64 throughout: the analytic gradient and the sum agree to rounding
    np.testing.assert_allclose(grad.numpy(), vec.detach().numpy(),
                               rtol=1e-10, atol=1e-12)


def test_cpu_tensors_take_the_plain_version_without_launching():
    tpk.reset_launch_count()
    args = _case(200, 16)
    got = _port("logistic", *args, 0.0)
    t = torch.from_numpy
    want = tpk.fused_value_gradient_sums_reference(
        tl.get_loss("logistic"), *(t(a) for a in args),
        torch.tensor(0.0))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tpk.launch_count() == 0


def test_tensor_on_another_device_is_refused():
    X, y, off, wt, w = (torch.from_numpy(a) for a in _case(10, 4))
    with pytest.raises(ValueError):
        tpk.fused_value_gradient_sums(tl.get_loss("logistic"), X, y, off, wt,
                                      w.to("meta"), torch.tensor(0.0),
                                      device="cpu")

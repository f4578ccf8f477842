"""Counter-based random numbers with the JAX package's default bits.

The fixed-effect down-sampler draws its keep mask with
``jax.random.uniform(jax.random.PRNGKey(seed + update_count), shape)``
(``photon_ml_tpu/sampler/samplers.py``, ``game/coordinate.py:195-201``).
This module reproduces those bits without JAX, for JAX's defaults: the
``threefry2x32`` implementation with ``jax_threefry_partitionable`` on and
f32 draws (x64 off).

- :func:`PRNGKey` is ``jax._src.prng.threefry_seed`` for a 32-bit seed:
  the key words are ``(0, seed & 0xFFFFFFFF)``.
- :func:`random_bits` is ``_threefry_random_bits_partitionable`` at 32
  bits: element ``i`` of the flattened shape hashes the counter pair
  ``(i >> 32, i & 0xFFFFFFFF)`` with Threefry-2x32 (20 rounds, the key
  schedule of ``_threefry2x32_lowering``) and XORs the two output words.
- :func:`uniform` is ``jax.random._uniform`` for f32 on [0, 1): the top 23
  bits become the mantissa of a float in [1, 2), minus one.
- :func:`normal` is ``jax.random.normal(key, shape, float32)``
  (``_normal_real``): ``sqrt(2) * erf_inv(u)`` with ``u`` uniform on
  ``(nextafter(-1, 0), 1)``, and ``erf_inv`` as XLA's CPU backend
  computes it in f32 — Giles' two polynomials on ``w = -log1p(-u*u)``,
  ``log1p`` and ``log`` in XLA's own f32 forms, every multiply feeding a
  single add fused into one rounding (:func:`_fma`) as the backend
  contracts them. The draws equal JAX's bit for bit (``scipy``'s
  ``erfinv`` misses by up to 83 ulp).

The bits are computed with numpy on the host (uint32 arithmetic wraps as
the hash needs), so they are the same whatever device the caller then
copies them to.
"""

from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def PRNGKey(seed: int) -> np.ndarray:
    """A raw key ``uint32[2]`` from a 32-bit integer seed."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit a 32-bit integer")
    return np.array([0, seed & 0xFFFFFFFF], dtype=np.uint32)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the counter words ``(x0, x1)`` under
    ``key`` (20 rounds, key injection every 4)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        v0 = x0.astype(np.uint32) + ks[0]
        v1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                v0 = v0 + v1
                v1 = _rotl(v1, r) ^ v0
            v0 = v0 + ks[(i + 1) % 3]
            v1 = v1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return v0, v1


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """``uint32`` bits of ``shape`` (the partitionable 32-bit draw)."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    counts = np.arange(n, dtype=np.uint64)
    hi = (counts >> np.uint64(32)).astype(np.uint32)
    lo = (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform_numpy(key: np.ndarray, shape) -> np.ndarray:
    """f32 draws on [0, 1), bit for bit ``jax.random.uniform(key, shape)``
    with x64 off."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) \
        - np.float32(1.0)
    return np.maximum(np.float32(0.0), floats)


def uniform(key: np.ndarray, shape, device="cpu") -> torch.Tensor:
    """:func:`uniform_numpy` as an f32 tensor on ``device``."""
    return torch.from_numpy(uniform_numpy(key, shape)).to(device)


def _f32(bits: int) -> np.float32:
    """The f32 constant whose f64 bit pattern is ``bits`` (how LLVM writes
    an f32 literal)."""
    return np.float32(np.array([bits], dtype=np.uint64).view(np.float64)[0])


def _fma(a, b, c) -> np.ndarray:
    """f32 ``a * b + c`` with one rounding. The product of two f32 values
    is exact in f64; the f64 sum is rounded to odd (an inexact sum whose
    last bit is even moves one ulp toward the exact value), after which
    rounding to f32 is the correctly rounded result."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64)
               for v in (a, b, c))
    p = a * b
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    fix = (err != 0) & ((s.view(np.uint64) & np.uint64(1)) == 0)
    s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)),
                 s)
    return s.astype(np.float32)


_ONE = np.float32(1.0)
_FLT_MIN = _f32(0x3810000000000000)


def _log(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``log`` for positive finite ``x``: a split into exponent
    and mantissa in [sqrt(1/2), sqrt(2)) and a degree-9 polynomial."""
    x = np.where(x > _FLT_MIN, x, _FLT_MIN).astype(np.float32)
    bits = x.view(np.uint32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 127).astype(
        np.float32) + _ONE
    m = ((bits & np.uint32(0x7FFFFF)) | np.uint32(0x3F000000)).view(
        np.float32)
    low = m < _f32(0x3FE6A09E60000000)
    y = (m - _ONE) + np.where(low, m, np.float32(0))
    e = e - np.where(low, _ONE, np.float32(0))
    y2 = y * y
    y3 = y2 * y
    q1 = _fma(_fma(y, _f32(0x3FB2043760000000), _f32(0xBFBD7A3700000000)),
              y, _f32(0x3FBDE4A340000000))
    q2 = _fma(_fma(y, _f32(0xBFBFCBA9E0000000), _f32(0x3FC23D37E0000000)),
              y, _f32(0xBFC555CA00000000))
    q3 = _fma(_fma(y, _f32(0x3FC999D580000000), _f32(0xBFCFFFFF80000000)),
              y, _f32(0x3FD5555540000000))
    r = _fma(_fma(_fma(q1, y3, q2), y3, q3), y3,
             e * _f32(0xBF2BD01060000000))
    return _fma(e, _f32(0x3FE6300000000000),
                _fma(-y2, np.float32(0.5), y) + r)


# log1p's rational approximation for |x| < sqrt(2) - 1 (Cephes, as XLA
# evaluates it), highest power first after the leading 1 / constant
_LOG1P_DEN = (0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000,
              0x4073519460000000, 0x406B0DB140000000, 0x404E0F3040000000)
_LOG1P_NUM = (0x3FDFE818A0000000, 0x401A509F40000000, 0x403DE97380000000,
              0x404E798EC0000000, 0x404C8E75A0000000, 0x40340A2020000000)


def _log1p(a: np.ndarray) -> np.ndarray:
    """XLA's f32 ``log1p``: the rational form near 0, ``log(1 + a)``
    elsewhere."""
    large = _log((a + _ONE).astype(np.float32))
    a2 = a * a
    den = np.ones_like(a)
    for c in _LOG1P_DEN:
        den = _fma(den, a, _f32(c))
    num = np.full_like(a, _f32(0x3F07BC0960000000))
    for c in _LOG1P_NUM:
        num = _fma(num, a, _f32(c))
    small = a + _fma(a2, np.float32(-0.5), (a * a2) * (num / den))
    return np.where(np.abs(a) < _f32(0x3FDA8279A0000000), small, large)


# Giles' erf_inv coefficients, w < 5 and w >= 5, highest power first
_ERFINV_LT5 = (0x3E5E2CB100000000, 0x3E970966C0000000, 0xBECD8E6AE0000000,
               0xBED26B5820000000, 0x3F2CA65B60000000, 0xBF548A8100000000,
               0xBF711C9DE0000000, 0x3FCF91EC60000000, 0x3FF805C5E0000000)
_ERFINV_GE5 = (0xBF2A3E1360000000, 0x3F1A76AD60000000, 0x3F561B8E40000000,
               0xBF6E17BCE0000000, 0x3F77824F60000000, 0xBF7F38BAE0000000,
               0x3F8354AFC0000000, 0x3FF006DB60000000, 0x4006A9EFC0000000)


def normal_numpy(key: np.ndarray, shape) -> np.ndarray:
    """Standard-normal f32 draws, bit for bit
    ``jax.random.normal(key, shape, jnp.float32)``."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - _ONE
    lo = _f32(0xBFEFFFFFE0000000)  # nextafter(-1, 0)
    u = np.maximum(lo, _fma(floats, np.float32(2.0), lo))
    log_term = _log1p(u * (-u))  # log(1 - u^2) = -w
    small = log_term > np.float32(-5.0)
    w = np.where(small, np.float32(-2.5) - log_term,
                 np.sqrt(-log_term) - np.float32(3.0))
    p = np.where(small, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(small, _f32(c_lt), _f32(c_ge)))
    p = np.where(np.abs(u) == _ONE, np.float32(np.inf), p)
    return ((u * p) * _f32(0x3FF6A09E60000000)).astype(np.float32)


def normal(key: np.ndarray, shape, device="cpu") -> torch.Tensor:
    """:func:`normal_numpy` as an f32 tensor on ``device``."""
    return torch.from_numpy(normal_numpy(key, shape)).to(device)

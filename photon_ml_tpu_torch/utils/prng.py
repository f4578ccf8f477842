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

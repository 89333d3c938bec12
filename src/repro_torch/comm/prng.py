"""Threefry-2x32 keys on the host, bitwise equal to ``jax.random``'s.

The wire's dither (``comm.compressors.wire_dither``) keys a per-element hash
with four threefry ``fold_in``s of the epoch's consensus key, and that key
is split off the epoch rng once an epoch.  These are O(1) scalar operations,
so they run here in numpy ``uint32`` on the key data (the ``(2,)`` array
``jax.random.key_data`` returns), with JAX's default
``jax_threefry_partitionable=True`` semantics:

* ``key(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]``;
* ``fold_in(k, data)`` is ``threefry2x32(k, [data >> 32, data & mask])``;
* ``split(k, n)[i]`` is ``threefry2x32(k, [i >> 32, i & mask])``, so for
  ``n <= 2**32`` the i-th split key equals ``fold_in(k, i)``.
"""
from __future__ import annotations

import numpy as np

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key, x0: int, x1: int) -> tuple:
    """The threefry-2x32 block cipher (20 rounds) of one counter pair."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _pair(data: int) -> tuple:
    data = int(data)
    if data < 0:
        data &= (1 << 64) - 1
    return (data >> 32) & _MASK, data & _MASK


def key(seed: int) -> np.ndarray:
    """Key data of ``jax.random.key(seed)``."""
    return np.array(_pair(seed), dtype=np.uint32)


def fold_in(k, data: int) -> np.ndarray:
    """Key data of ``jax.random.fold_in(k, data)``."""
    return np.array(threefry2x32(k, *_pair(data)), dtype=np.uint32)


def split(k, num: int = 2) -> np.ndarray:
    """``(num, 2)`` key data of ``jax.random.split(k, num)``."""
    return np.array([threefry2x32(k, *_pair(i)) for i in range(num)],
                    dtype=np.uint32).reshape(num, 2)

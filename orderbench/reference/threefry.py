"""Threefry-2x32 in NumPy: the draws the ordering's randomness is defined by.

The configuration states that every random choice of an ordering (the
matching's coins, tie breaks and grant keys, the FM pass noise) is drawn
from threefry-2x32 keys as ``jax.random`` draws them with
``jax_threefry_partitionable=True``:

* a key of seed ``s`` is the word pair ``(0, s mod 2**32)``;
* ``split(key, num)`` hashes the counters ``(0, i)``, ``i < num``;
* ``random_bits(key, shape)`` hashes ``(0, i)`` over the flat index of
  ``shape`` and xors the two output words;
* ``uniform`` maps bits to ``[0, 1)`` as ``(bits >> 9) | 0x3F800000``
  read as float32, minus 1; ``bernoulli(p)`` is ``uniform < p``.

Written here from that definition with uint32 arithmetic, which wraps.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def hash2x32(k0, k1, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32, 20 rounds, of counter words ``(x0, x1)`` under key
    ``(k0, k1)``; everything uint32."""
    k0, k1 = np.uint32(k0), np.uint32(k1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for step in range(5):
            for r in _ROT[step % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(step + 1) % 3]
            x1 = x1 + ks[(step + 2) % 3] + np.uint32(step + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def _iota(k: np.ndarray, size: int):
    idx = np.arange(size, dtype=np.uint64)
    return hash2x32(k[0], k[1], (idx >> np.uint64(32)).astype(np.uint32),
                    (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``num`` keys of one key: (2,) → (num, 2) uint32."""
    b0, b1 = _iota(np.asarray(k, dtype=np.uint32), num)
    return np.stack([b0, b1], axis=-1)


def random_bits(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    shape = tuple(int(s) for s in shape)
    b0, b1 = _iota(np.asarray(k, dtype=np.uint32), math.prod(shape))
    return (b0 ^ b1).reshape(shape)


def uniform(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    bits = (random_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def bernoulli(k: np.ndarray, p: float, shape: Sequence[int]) -> np.ndarray:
    return uniform(k, shape) < np.float32(p)

"""Threefry-2x32 counter-based PRNG, bit-compatible with ``jax.random``.

The ordering's randomness (matching coins and tiebreaks, FM tiebreak
noise) comes from threefry keys derived from integer seeds.  This module
reproduces the reference's draws bit for bit under JAX's default
``jax_threefry_partitionable=True``:

* ``PRNGKey(seed)`` is ``[0, seed]`` (32-bit seeds);
* ``split(key, num)`` hashes the counters ``(0, i)`` for ``i < num``;
* ``random_bits(key, shape)`` hashes ``(0, i)`` over the flattened index
  of ``shape`` and xors the two output words, so the bits depend on the
  whole shape, not only on the element;
* ``uniform`` maps bits to ``[0, 1)`` as ``(bits >> 9) | 0x3F800000``
  bit-cast to float32, minus 1; ``bernoulli(p)`` is ``uniform < p``.

Keys are int64 tensors whose last axis holds the two 32-bit words; all
arithmetic is int64 masked to 32 bits, so it runs on any device.  A
leading batch shape on a key batches every function over keys.  There is
no global generator: keys are passed explicitly.

``split_host(seeds, counts)`` is the FM lanes' key split on the host: for
each seed ``s`` with count ``c`` the rows of ``split(PRNGKey(s), c)``, bit
for bit, for a whole bucket of works in one NumPy uint32 pass.  The torch
functions cost one dispatcher call per operation on tensors of a few
elements, ~180 calls a work; the packing of an FM bucket needs every
work's lane keys on the host, so it takes them from here.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of counter words ``(x0, x1)``.

    All arguments are int64 tensors holding 32-bit values; they broadcast
    against each other.  Returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for step in range(5):
        for r in _ROT[step % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & _M32
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & _M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Key of an integer seed: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def _hash_iota(key: torch.Tensor, size: int):
    """Hash counters ``0 .. size-1`` under every key of a key batch."""
    idx = torch.arange(size, dtype=torch.int64, device=key.device)
    k0 = key[..., 0:1]
    k1 = key[..., 1:2]
    return threefry2x32(k0, k1, idx >> 32, idx & _M32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys per key: (..., 2) → (..., num, 2)."""
    b0, b1 = _hash_iota(key, num)
    return torch.stack([b0, b1], dim=-1)


def split_host(seeds: Sequence[int], counts: Sequence[int]) -> np.ndarray:
    """``split(PRNGKey(s), c)`` for every ``(s, c)``, stacked: (Σc, 2) int64.

    One threefry pass over a flat lane axis in uint32 arithmetic, which
    wraps by itself; the rotations and sums run in place.
    """
    counts = np.asarray(counts, np.int64)
    k1 = np.repeat(np.array([int(s) & _M32 for s in seeds], np.uint32),
                   counts)
    ends = np.cumsum(counts)
    x1 = np.arange(len(k1), dtype=np.uint32)            # counter (0, i)
    x1 -= np.repeat((ends - counts).astype(np.uint32), counts)
    ks = (np.uint32(0), k1, k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.zeros_like(x1)
    x1 += k1
    t = np.empty_like(x1)
    for step in range(5):
        for r in _ROT[step % 2]:
            x0 += x1
            np.left_shift(x1, np.uint32(r), out=t)
            x1 >>= np.uint32(32 - r)
            x1 |= t
            x1 ^= x0
        x0 += ks[(step + 1) % 3]
        x1 += ks[(step + 2) % 3]
        x1 += np.uint32(step + 1)
    return np.stack([x0, x1], axis=1).astype(np.int64)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element: (..., 2) → (..., *shape) int64."""
    shape = tuple(int(s) for s in shape)
    b0, b1 = _hash_iota(key, math.prod(shape))
    return (b0 ^ b1).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 uniform in [0, 1): (..., 2) → (..., *shape)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: Union[float, torch.Tensor],
              shape: Sequence[int]) -> torch.Tensor:
    """Boolean draws with probability ``p`` (compared in float32)."""
    p = torch.as_tensor(p, dtype=torch.float32, device=key.device)
    return uniform(key, shape) < p

"""The port's threefry PRNG against ``jax.random``, bit for bit.

Exact equality is the stated tolerance: the port must reproduce the
reference's random bits, or no ordering could match.  Covers the shapes
the ordering draws: (2, n) FM noise, (n, d) matching tiebreaks, (n,)
coins and grant tiebreaks, and lane batches of keys.
"""
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.kernels.fm_fused import fm_noise as jax_fm_noise  # noqa: E402
from repro.util import mix_seeds as jax_mix_seeds, pow2 as jax_pow2  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.convert import key_from_array  # noqa: E402
from repro_torch.kernels.fm_fused import fm_noise  # noqa: E402
from repro_torch.util import mix_seeds, pow2  # noqa: E402

SEEDS = [0, 1, 5, 97, 12345, 2 ** 31 - 1, 2 ** 31 + 7, 4_000_000_000]
SHAPES = [(2, 37), (2, 64), (50, 8), (33, 5), (64,), (1,), (257,)]


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split(seed):
    ref = np.asarray(jax.random.PRNGKey(seed))
    key = prng.PRNGKey(seed)
    assert np.array_equal(key.numpy(), ref.astype(np.int64))
    for num in (2, 3, 8, 13):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
        assert np.array_equal(prng.split(key, num).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_and_bernoulli_over_seeds(shape):
    for seed in range(0, 400, 23):
        jk = jax.random.PRNGKey(seed)
        key = prng.PRNGKey(seed)
        u = np.asarray(jax.random.uniform(jk, shape))
        assert np.array_equal(prng.uniform(key, shape).numpy(), u), seed
        b = np.asarray(jax.random.bernoulli(jk, 0.5, shape))
        assert np.array_equal(prng.bernoulli(key, 0.5, shape).numpy(), b)


def test_key_batches_match_vmap():
    """A leading key axis batches every function, as vmap does."""
    jkeys = jax.random.split(jax.random.PRNGKey(11), 6)
    keys = key_from_array(np.asarray(jkeys))
    for shape in [(2, 40), (16, 8), (40,)]:
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(
            jkeys))
        assert np.array_equal(prng.uniform(keys, shape).numpy(), want)
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(jkeys))
    assert np.array_equal(prng.split(keys, 3).numpy(), want)
    rkeys = jax.random.split(jax.random.PRNGKey(3), 8)        # matching's
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(rkeys))
    got = prng.split(key_from_array(np.asarray(rkeys)), 3)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,passes", [(16, 1), (64, 3), (100, 2)])
def test_fm_noise_matches_reference(n, passes):
    jkeys = jax.random.split(jax.random.PRNGKey(n + passes), 5)
    want = np.asarray(jax_fm_noise(jkeys, n, passes))
    got = fm_noise(key_from_array(np.asarray(jkeys)), n, passes)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


def test_seed_helpers_are_copies():
    for vals in [(0,), (1, 2), (12345, 0), (7, 3, 9)]:
        assert mix_seeds(*vals) == jax_mix_seeds(*vals)
    for x, lo in [(1, 64), (64, 64), (65, 64), (900, 8), (3, 2)]:
        assert pow2(x, lo) == jax_pow2(x, lo)


def test_key_from_array_rejects_bad_shape():
    with pytest.raises(ValueError):
        key_from_array(np.zeros(3, np.uint32))

"""The port's threefry PRNG against ``jax.random``, bit for bit.

Exact equality is the stated tolerance: the port must reproduce the
reference's random bits, or no ordering could match.  Covers the shapes
the ordering draws: (2, n) FM noise, (n, d) matching tiebreaks, (n,)
coins and grant tiebreaks, and lane batches of keys; and a scalar model
of the rule by which the FM kernels draw their noise in place.
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
from repro_torch.kernels.fm_fused import fm_noise, fm_noise_plain  # noqa: E402
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


HOST_SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32 + 7, -3] + [
    int(s) for s in np.random.default_rng(63).integers(0, 2 ** 63 - 1, 64)]


@pytest.mark.parametrize("counts", [1, 2, 3, 4, 8, 16, "mixed"])
def test_split_host_equals_split(counts):
    """The host split of a bucket's seeds is each seed's ``split`` rows,
    bit for bit, in one call: negative and 63-bit seeds masked as
    ``PRNGKey`` masks them, and counts that differ from work to work."""
    if counts == "mixed":
        counts = [int(c) for c in np.random.default_rng(5).choice(
            [1, 2, 3, 4, 8, 16], len(HOST_SEEDS))]
    else:
        counts = [counts] * len(HOST_SEEDS)
    got = prng.split_host(HOST_SEEDS, counts)
    want = torch.cat([prng.split(prng.PRNGKey(s), c)
                      for s, c in zip(HOST_SEEDS, counts)])
    assert got.dtype == np.int64 and got.shape == (sum(counts), 2)
    assert np.array_equal(got, want.numpy())


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


_M32 = 0xFFFFFFFF


def _threefry(k0, k1, x0, x1):
    """Threefry-2x32 on Python ints, as ``csrc/threefry.cuh`` writes it."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for step in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[step % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & _M32
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & _M32
    return x0, x1


def _kernel_noise_entry(key, p, s, n, v):
    """The FM kernels' in-place draw, one entry at a time: pass p's subkey
    is split(k_p)[1], with k_0 the lane's key and k_{q+1} = split(k_q)[0];
    side s of vertex v is the uniform at flat index s * n + v."""
    k = key
    for _ in range(p):
        k = _threefry(*k, 0, 0)
    sub = _threefry(*k, 0, 1)
    idx = s * n + v
    b0, b1 = _threefry(*sub, idx >> 32, idx & _M32)
    bits = np.uint32(((b0 ^ b1) >> 9) | 0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


@pytest.mark.parametrize("n", [64, 1000, 8192])
@pytest.mark.parametrize("passes", [1, 2, 3])
def test_kernel_draw_rule_equals_fm_noise(passes, n):
    """The rule the FM kernels draw by, on sampled (lane, pass, side,
    vertex), equals ``fm_noise_plain`` and the reference's ``fm_noise``."""
    L = 4
    jkeys = jax.random.split(jax.random.PRNGKey(31 * n + passes), L)
    want = np.asarray(jax_fm_noise(jkeys, n, passes))
    keys = key_from_array(np.asarray(jkeys))
    plain = fm_noise_plain(keys, n, passes).numpy()
    rng = np.random.default_rng(n + passes)
    samples = [(0, 0, 0, 0), (L - 1, passes - 1, 1, n - 1)] + [
        tuple(int(x) for x in t) for t in zip(
            rng.integers(0, L, 40), rng.integers(0, passes, 40),
            rng.integers(0, 2, 40), rng.integers(0, n, 40))]
    for lane, p, s, v in samples:
        key = tuple(int(w) for w in keys[lane])
        got = _kernel_noise_entry(key, p, s, n, v)
        assert got == plain[lane, p, s, v] == want[lane, p, s, v], \
            (lane, p, s, v)
        assert got.tobytes() == plain[lane, p, s, v].tobytes()


def test_seed_helpers_are_copies():
    for vals in [(0,), (1, 2), (12345, 0), (7, 3, 9)]:
        assert mix_seeds(*vals) == jax_mix_seeds(*vals)
    for x, lo in [(1, 64), (64, 64), (65, 64), (900, 8), (3, 2)]:
        assert pow2(x, lo) == jax_pow2(x, lo)


def test_key_from_array_rejects_bad_shape():
    with pytest.raises(ValueError):
        key_from_array(np.zeros(3, np.uint32))

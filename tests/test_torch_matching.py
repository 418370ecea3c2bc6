"""The port's matching against the reference, exactly, on the CPU.

``heavy_edge_matching_multi_plain`` (what the matching runs on CPU tensors,
and what the CUDA kernel is held to on the card) resolves each grant with
one packed 64-bit word per proposal instead of the reference's
``segment_max`` then ``segment_min``.  It must give the reference's
matching bit for bit: -1 slots anywhere in a row, grant keys that tie
(weights of 2^24, where the tie draw rounds away, so the lowest proposer id
must win), zero and negative weights (the order-preserving image of a
negative float), one round and eight.
"""
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.matching import heavy_edge_matching_multi as jax_hem  # noqa: E402
from repro_torch.convert import key_from_array  # noqa: E402
from repro_torch.core import coarsen  # noqa: E402
from repro_torch.core import matching as core_matching  # noqa: E402
from repro_torch.graphs.generators import grid3d  # noqa: E402
from repro_torch.kernels import band_batch, matching  # noqa: E402


def _bucket(seed, L, n, d, weights):
    """ELL lanes with -1 slots anywhere in a row and symmetric-free ids."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (L, n, d)).astype(np.int32)
    nbr[rng.random((L, n, d)) < 0.4] = -1
    nbr[:, -n // 16:] = -1                              # padding rows
    if weights == "small":
        w = rng.integers(1, 4, (L, n, d))
    elif weights == "tied":
        w = np.full((L, n, d), 2 ** 24)
    elif weights == "signed":
        w = rng.choice([-2 ** 31, -2 ** 24, -7, -1, 0, 0, 1, 3], (L, n, d))
    else:
        w = rng.integers(-2 ** 31, 2 ** 31, (L, n, d))
    wgt = np.where(nbr >= 0, w, 0).astype(np.int32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), L))
    return nbr, wgt, keys


def _both(nbr, wgt, keys, rounds):
    want = np.asarray(jax_hem(jnp.asarray(nbr), jnp.asarray(wgt),
                              jnp.asarray(keys), rounds=rounds))
    got = matching.heavy_edge_matching_multi(
        torch.from_numpy(nbr), torch.from_numpy(wgt), key_from_array(keys),
        rounds=rounds)
    assert got.dtype == torch.int32
    return got.numpy(), want


@pytest.mark.parametrize("rounds", [1, 8])
@pytest.mark.parametrize("L,n,d", [(1, 64, 8), (4, 128, 8), (3, 64, 32),
                                   (2, 256, 16)])
def test_plain_matching_equals_reference(L, n, d, rounds):
    before = matching.launches
    got, want = _both(*_bucket(L * n + d, L, n, d, "small"), rounds)
    assert np.array_equal(got, want), f"{(got != want).sum()} mismatches"
    assert matching.launches == before           # CPU tensors never launch
    for lane in got:
        assert core_matching.validate_matching(lane)


@pytest.mark.parametrize("rounds", [1, 8])
@pytest.mark.parametrize("weights", ["tied", "signed", "int32"])
def test_plain_matching_grant_ties_and_signs(weights, rounds):
    nbr, wgt, keys = _bucket(17 + rounds, 3, 128, 8, weights)
    got, want = _both(nbr, wgt, keys, rounds)
    assert np.array_equal(got, want), f"{(got != want).sum()} mismatches"
    if weights == "tied" and rounds == 1:
        # every score and grant key ties: each matched acceptor took its
        # lowest proposer, so some proposer lost on the id alone
        assert (got != np.arange(128)).any()


def test_grant_word_orders_keys_then_lowest_id():
    keys = np.array([-np.inf, -2.0 ** 31, -2.0 ** 24, -7.5, -1.0, -2 ** -20,
                     0.0, 2 ** -20, 0.5, 1.0, 7.25, 2.0 ** 24, 2.0 ** 31],
                    np.float32)
    ids = np.arange(len(keys))
    w = matching.grant_word(torch.from_numpy(keys), torch.from_numpy(ids))
    assert torch.all(w[1:] > w[:-1])             # increasing with the key
    tied = matching.grant_word(torch.full((4,), 2.0 ** 24),
                               torch.tensor([0, 5, 6, 9]))
    assert torch.all(tied[1:] < tied[:-1])       # equal keys: lower id wins


def test_plain_tally_counts_the_draws():
    nbr, wgt, keys = _bucket(5, 2, 64, 8, "small")
    tally = []
    matching.heavy_edge_matching_multi_plain(
        torch.from_numpy(nbr), torch.from_numpy(wgt), key_from_array(keys),
        rounds=8, tally=tally)
    assert len(tally) == 8
    assert tally[0][0] == 2 * 64                 # every vertex starts free
    coins = [t[0] for t in tally]
    assert all(a >= b for a, b in zip(coins, coins[1:]))
    assert all(t[2] <= t[1] for t in tally)      # a proposal scores a slot


def test_matching_wrapper_checks_inputs():
    nbr, wgt, keys = _bucket(1, 2, 64, 8, "small")
    t = [torch.from_numpy(nbr), torch.from_numpy(wgt), key_from_array(keys)]
    with pytest.raises(ValueError):              # wgt must be int32
        matching.heavy_edge_matching_multi(t[0], t[1].long(), t[2])
    with pytest.raises(ValueError):              # one key per lane
        matching.heavy_edge_matching_multi(t[0], t[1], t[2][:1])
    with pytest.raises(ValueError):              # keys are int64 words
        matching.heavy_edge_matching_multi(t[0], t[1], t[2].int())
    with pytest.raises(ValueError):              # the kernel takes the card
        matching.heavy_edge_matching_multi_kernel(*t)


def test_main_path_buckets_take_the_one_launch_design():
    """The matching buckets of the main path run in one launch: one CTA for
    the small buckets that most calls have, 16 at grid3d(30³)'s root
    (32768, 8), every level of grid3d(20³)'s hierarchy on the cluster
    design; lanes of 2^17 rows and more run the grid design."""
    plan = band_batch.lane_plan
    assert plan(512, 16) == ("cluster", 1)
    assert plan(2048, 8) == ("cluster", 1)
    assert plan(1024, 32) == ("cluster", 2)
    assert plan(8192, 32) == ("cluster", 16)
    assert plan(32768, 8) == ("cluster", 16)
    assert plan(2 ** 17, 8) == ("grid", None)
    assert plan(2 ** 20, 8) == ("grid", None)
    state = coarsen.coarsen_multilevel(grid3d(20, 20, 20), seed=0, nproc=8,
                                       device="cpu")
    for lv in state.levels:
        n_pad, d_pad, _ = coarsen.match_work_for(lv.graph, 0).bucket_key()
        design, C = plan(n_pad, d_pad)
        assert design == "cluster" and C == band_batch.cluster_size(
            n_pad, d_pad)

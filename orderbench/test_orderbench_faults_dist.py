"""The distributed cell's check fails what it has to fail (CPU, small):
its control (half the matching rounds in the endgame's coarsening), a
distributed matching that returns its state unchanged (every vertex
single), an FM call packed wrong, and, with its parts on a group
(the traffic key ``cards``, here 4 CPU members), an exchange between the
group's members lost.  On the group the cell is correct, orders as on
one device at equal seeds, and its launch records count the bytes the
members copied."""
from __future__ import annotations

import contextlib

import pytest

from orderbench import control, test_orderbench_faults, testing

DIST = "m3d-30-noband.dist8"
ON_GROUP = {"cards": 4}


@contextlib.contextmanager
def dmatch_unchanged():
    from repro_torch.core import dgraph
    from repro_torch.service import router
    fn = router.distributed_matching_stacked

    def match(dgs, seeds, *a, **kw):
        fn(dgs, seeds, *a, **kw)
        return [dgraph.shard_gids(dg) for dg in dgs]
    router.distributed_matching_stacked = match
    try:
        yield
    finally:
        router.distributed_matching_stacked = fn


def exchange_lost():
    """The group's gather of rows between phases leaves out member 1's
    copy into the others: their replicas keep stale rows of its parts."""
    from repro_torch.core import dgraph

    def make(fn):
        def gather(group, ranges, rows):
            lost = tuple((p0, p0) if m == 1 else (p0, p1)
                         for m, (p0, p1) in enumerate(ranges))
            return fn(group, lost, rows)
        return gather
    return test_orderbench_faults.patched(dgraph, "_gather_rows", make)


def observed(traffic=None):
    """A small CPU run of the distributed cell, with ``traffic``'s keys
    over its own, the window's permutations by ordering seed and its
    launch records kept."""
    from repro_torch.core import dnd
    from repro_torch.obs.instrument import instrument
    perms, seen = {}, {}

    def make(fn):
        def order(dg, seed=0, *a, **kw):
            perm = fn(dg, seed, *a, **kw)
            perms[seed] = perm.copy()
            return perm
        return order

    @contextlib.contextmanager
    def hook():
        with test_orderbench_faults.patched(
                dnd, "distributed_nested_dissection", make), \
                instrument() as ins:
            seen["ins"] = ins
            yield
    out = testing.cpu_run(DIST, window_hook=hook, traffic=traffic)
    return out["result"], perms, seen["ins"]


@pytest.fixture(scope="module")
def one_card():
    return observed()


@pytest.fixture(scope="module")
def on_group():
    return observed(ON_GROUP)


def test_sound_run_is_correct(one_card):
    res = one_card[0]
    assert res["correct"], res["checks"]


def test_sound_run_on_a_group_is_correct(on_group):
    res = on_group[0]
    assert res["correct"], res["checks"]
    assert res["checks"]["unchecked"]["value"] == 0
    for kind in ("dmatch", "dhalo", "match", "fm"):
        assert res["checks"][f"{kind}_bad"]["value"] == 0


def test_group_orders_as_one_card_at_equal_seeds(one_card, on_group):
    (_, one, _), (_, grp, _) = one_card, on_group
    both = set(one) & set(grp)
    assert both
    for s in both:
        assert (one[s] == grp[s]).all(), s


def _xbytes(run):
    return [d["xbytes"] for d in run[2].launches if "xbytes" in d]


def test_xbytes_counted_on_the_group_only(one_card, on_group):
    assert sum(_xbytes(on_group)) > 0
    assert _xbytes(one_card) == []


def test_fm_packed_wrong_is_not_correct():
    res = testing.cpu_run(DIST, window_hook=test_orderbench_faults
                          .pack_edge_dropped)["result"]
    assert res["correct"] is False
    assert res["checks"]["fmpack_bad"]["value"] > 0


def test_dmatch_unchanged_is_not_correct():
    res = testing.cpu_run(DIST, window_hook=dmatch_unchanged)["result"]
    assert res["correct"] is False
    assert res["checks"]["dmatch_bad"]["value"] > 0


def test_exchange_lost_on_a_group_is_not_correct():
    res = testing.cpu_run(DIST, window_hook=exchange_lost,
                          traffic=ON_GROUP)["result"]
    assert res["correct"] is False
    got = {k: res["checks"][k]["value"] for k in ("dhalo_bad", "dmatch_bad")}
    assert sum(got.values()) > 0, got


def test_control_is_not_correct():
    res = testing.cpu_run(
        DIST, window_hook=lambda: control.installed("short_matching")
    )["result"]
    assert res["correct"] is False
    assert res["checks"]["match_bad"]["value"] > 0

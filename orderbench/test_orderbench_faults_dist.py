"""The distributed cell's check fails what it has to fail (CPU, small):
its control (half the matching rounds in the endgame's coarsening), a
distributed matching that returns its state unchanged (every vertex
single), and an FM call packed wrong."""
from __future__ import annotations

import contextlib

from orderbench import control, test_orderbench_faults, testing

DIST = "m3d-30-noband.dist8"


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


def test_sound_run_is_correct():
    res = testing.cpu_run(DIST)["result"]
    assert res["correct"], res["checks"]


def test_fm_packed_wrong_is_not_correct():
    res = testing.cpu_run(DIST, window_hook=test_orderbench_faults
                          .pack_edge_dropped)["result"]
    assert res["correct"] is False
    assert res["checks"]["fmpack_bad"]["value"] > 0


def test_dmatch_unchanged_is_not_correct():
    res = testing.cpu_run(DIST, window_hook=dmatch_unchanged)["result"]
    assert res["correct"] is False
    assert res["checks"]["dmatch_bad"]["value"] > 0


def test_control_is_not_correct():
    res = testing.cpu_run(
        DIST, window_hook=lambda: control.installed("short_matching")
    )["result"]
    assert res["correct"] is False
    assert res["checks"]["match_bad"]["value"] > 0

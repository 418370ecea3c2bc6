"""The distributed entry with the band graph on (CPU, small): a sound run
is correct with the centralized and the distributed band BFS and the
distributed levels' band refinement sampled, on the sharded refinement
(this size's) and on both paths (the centralized one's threshold
raised); and the
check fails the distributed BFS altered where it is produced, the
centralized BFS reached by another way than the one recorded, the folded
instances' band cut one layer short, a distributed level's band cut one
layer short on either path, the centralized band's answer dropped, and
the control."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from orderbench import control, testing
from orderbench.test_orderbench_faults import patched
from orderbench.test_orderbench_faults_band import BAND, assert_sound, \
    band_one_layer_short, bfs_by_another_way
from orderbench.test_orderbench_faults_dist import DIST

#: the distributed levels' bands of up to 300 vertices centralized (10 of
#: the 13 at this size), the largest sharded as at full size
CENTRAL = dict(BAND, band_central_threshold=300)


def dbfs_altered():
    """One lane's distance of the distributed BFS changed on its way out."""
    from repro_torch.service import router

    def make(fn):
        def bfs(dgs, srcs, *a, **kw):
            out = [np.array(o, copy=True) for o in fn(dgs, srcs, *a, **kw)]
            out[0].flat[0] += 1
            return out
        return bfs
    return patched(router, "distributed_bfs_stacked", make)


def central_band_one_layer_short():
    from repro_torch.core import dnd

    def make(fn):
        def task(dg, part_sh, dist_sh, seed, k_fm, cfg):
            short = dataclasses.replace(cfg, band_width=cfg.band_width - 1)
            return (yield from fn(dg, part_sh, dist_sh, seed, k_fm, short))
        return task
    return patched(dnd, "_centralize_band_task", make)


def central_band_unprojected():
    """A step that returns its state unchanged: the level keeps its part
    and FM's answer on the centralized band is dropped."""
    from repro_torch.core import dnd

    def make(fn):
        def task(dg, part_sh, *args):
            yield from fn(dg, part_sh, *args)
            return np.array(part_sh, copy=True)
        return task
    return patched(dnd, "_centralize_band_task", make)


def sharded_band_one_layer_short():
    from repro_torch.core import dnd

    def make(fn):
        def task(dg, part_sh, keep_sh, dist_sh, seed, cfg):
            keep = keep_sh & (dist_sh < cfg.band_width)
            return (yield from fn(dg, part_sh, keep, dist_sh, seed, cfg))
        return task
    return patched(dnd, "_sharded_band_task", make)


@pytest.mark.parametrize("nd", [BAND, CENTRAL], ids=["sharded", "both"])
def test_sound_band_run_is_correct(nd):
    res = testing.cpu_run(DIST, nd=nd)["result"]
    assert_sound(res)
    assert {"dbfs_bad", "dband_bad"} <= set(res["checks"])


CASES = [(BAND, dbfs_altered, "dbfs_bad"),
         (BAND, bfs_by_another_way, "unchecked"),
         (BAND, band_one_layer_short, "band_bad"),
         (BAND, sharded_band_one_layer_short, "dband_bad"),
         (CENTRAL, central_band_one_layer_short, "dband_bad"),
         (CENTRAL, central_band_unprojected, "dband_bad")]


@pytest.mark.parametrize("nd,fault,number", CASES,
                         ids=[f.__name__ for _, f, _ in CASES])
def test_band_fault_is_not_correct(nd, fault, number):
    res = testing.cpu_run(DIST, window_hook=fault, nd=nd)["result"]
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


def test_control_on_the_band_is_not_correct():
    res = testing.cpu_run(
        DIST, window_hook=lambda: control.installed("short_matching"),
        nd=BAND)["result"]
    assert res["correct"] is False
    assert res["checks"]["match_bad"]["value"] > 0

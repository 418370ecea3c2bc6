"""With the band graph on, the check judges the band BFS and fails what it
has to fail (CPU, small): the no-band cells' paths run with
``nd_config.use_band`` true, the published strategy's refinement.

A sound run is correct with the band BFS, the band graphs and their
projections sampled (``bfs_bad``, ``band_bad``, ``band_proj_bad`` judged
and ``unchecked`` 0) and every band FM call packed as the benchmark
packs it, locked anchors and all (``fmpack_bad`` 0).  Planted under the
window alone: one lane's distance altered where it is produced, the BFS
returning only its source layer, the BFS reached by another way than the
one recorded, the band cut one layer short, the anchors wired to the
layer inside the last, the refined band left unprojected, and the
control.  The distributed entry's are in
``test_orderbench_faults_band_dist.py``.
"""
from __future__ import annotations

import contextlib

import pytest
import torch

from orderbench import control, testing
from orderbench.test_orderbench_faults import SINGLE, STREAM, patched

BAND = {"use_band": True}


def _bfs(change):
    from repro_torch.core import band

    def make(fn):
        def bfs(nbr, src, width):
            return change(fn(nbr, src, width).clone(), src)
        return bfs
    return patched(band, "bfs_multi", make)


def bfs_altered():
    def change(out, src):
        out[0, 0] += 1
        return out
    return _bfs(change)


def bfs_source_layer_only():
    from repro_torch.kernels import band_batch

    def change(out, src):
        return torch.where(src != 0, 0, band_batch.UNREACH).to(out.dtype)
    return _bfs(change)


def bfs_by_another_way():
    """The band distances reached under a name the recorder does not
    wrap: each executor's call runs ``band_batch.bfs_multi`` itself."""
    from repro_torch.core import band, nd
    from repro_torch.kernels import band_batch
    from repro_torch.service import router

    def make(fn):
        def execute(works, device=None):
            recorded = band.bfs_multi
            band.bfs_multi = band_batch.bfs_multi
            try:
                return fn(works, device)
            finally:
                band.bfs_multi = recorded
        return execute
    stack = contextlib.ExitStack()
    for module in (nd, router):
        stack.enter_context(patched(module, "execute_bfs_works", make))
    return stack


def band_one_layer_short():
    from repro_torch.core import nd

    def make(fn):
        def extract(g, part, width=3, dist=None, device=None):
            return fn(g, part, width=width - 1, dist=dist, device=device)
        return extract
    return patched(nd, "extract_band", make)


def anchors_on_the_layer_inside():
    from repro_torch.core import band

    def make(fn):
        def anchors(sub, band_part, band_dist, width, w_out0, w_out1):
            return fn(sub, band_part, band_dist, width - 1, w_out0, w_out1)
        return anchors
    return patched(band, "band_graph_with_anchors", make)


def band_left_unprojected():
    """A step that returns its state unchanged: FM's refined band is
    dropped and the level keeps its projected part."""
    from repro_torch.core import nd

    def make(fn):
        def project(part, band_part, old_ids):
            return part.copy()
        return project
    return patched(nd, "project_band", make)


CASES = [(SINGLE, bfs_altered, "bfs_bad"),
         (STREAM, bfs_altered, "bfs_bad"),
         (SINGLE, bfs_source_layer_only, "bfs_bad"),
         (SINGLE, bfs_by_another_way, "unchecked"),
         (STREAM, bfs_by_another_way, "unchecked"),
         (SINGLE, band_one_layer_short, "band_bad"),
         (STREAM, band_one_layer_short, "band_bad"),
         (SINGLE, anchors_on_the_layer_inside, "band_bad"),
         (SINGLE, band_left_unprojected, "band_proj_bad"),
         (STREAM, band_left_unprojected, "band_proj_bad")]


def assert_sound(res):
    assert res["correct"], res["checks"]
    checks = res["checks"]
    assert {"bfs_bad", "band_bad", "band_proj_bad"} <= set(checks)
    assert checks["unchecked"]["value"] == 0
    assert checks["fmpack_bad"]["value"] == 0


@pytest.mark.parametrize("cell", [SINGLE, STREAM])
def test_sound_band_runs_are_correct(cell):
    assert_sound(testing.cpu_run(cell, nd=BAND)["result"])


@pytest.mark.parametrize("cell,fault,number", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f, _ in CASES])
def test_band_fault_is_not_correct(cell, fault, number):
    res = testing.cpu_run(cell, window_hook=fault, nd=BAND)["result"]
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


@pytest.mark.parametrize("cell", [SINGLE, STREAM])
def test_control_on_the_band_is_not_correct(cell):
    res = testing.cpu_run(
        cell, window_hook=lambda: control.installed("short_matching"),
        nd=BAND)["result"]
    assert res["correct"] is False
    assert res["checks"]["match_bad"]["value"] > 0

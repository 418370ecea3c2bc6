"""The check fails what it has to fail: the control (the reference in
the program's place with half the matching rounds) and each fault a cell
can have, planted under the timed path of a whole (CPU, small) run.

Faults: a step that returns its state unchanged (FM keeps its input
parts), half of the
batch left out (the matching's second half of lanes left single), an
answer altered where it is produced (one matching's mate, one
permutation entry), an FM call packed wrong (an edge dropped or moved in
a tile, two lanes' keys swapped), and a kernel reached by another way
than the one recorded.  Each is planted around the window alone, after a
sound set-up.  The distributed cell's are in
``test_orderbench_faults_dist.py``, with the one fault that only parts
on a group of devices can have: an exchange between its members lost
(no cell spans cards yet; the test puts the distributed cell's parts on
CPU members).
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from orderbench import control, testing

SINGLE, STREAM = "m3d-30-noband.single", "mix-noband.stream16"


@contextlib.contextmanager
def patched(module, name, make):
    saved = getattr(module, name)
    setattr(module, name, make(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def fm_unchanged():
    from repro_torch.kernels import ops

    def make(fn):
        def fm(nbr, lane_work, vwgt, parts, locked, *a, **kw):
            _, sep_w, imb = fn(nbr, lane_work, vwgt, parts, locked, *a, **kw)
            return parts.clone(), sep_w, imb
        return fm
    return patched(ops, "fm_fused_multi", make)


def _matching(change):
    from repro_torch.core import coarsen

    def make(fn):
        def match(nbr, wgt, keys, rounds=8):
            return change(fn(nbr, wgt, keys, rounds=rounds).clone())
        return match
    return patched(coarsen, "heavy_edge_matching_multi", make)


def match_half():
    def change(out):
        L, n = out.shape
        out[L // 2:] = torch.arange(n, dtype=out.dtype)
        return out
    return _matching(change)


def match_altered():
    def change(out):
        v = int(torch.nonzero(out[0] != torch.arange(out.shape[1]))[0, 0]) \
            if bool((out[0] != torch.arange(out.shape[1])).any()) else 0
        out[0, v] = v                    # v's mate forgets v
        return out
    return _matching(change)


def perm_altered():
    from repro_torch.core import nd

    def make(fn):
        def order(*a, **kw):
            perm = np.array(fn(*a, **kw))
            perm[-1] = perm[0]
            return perm
        return order
    return patched(nd, "nested_dissection", make)


def _packing(change):
    from repro_torch.core import fm as core_fm

    def make(fn):
        def pack(works):
            host, counts = fn(works)
            change(host)
            return host, counts
        return pack
    return patched(core_fm, "pack_fm_bucket", make)


def _first_edge(nbr):
    w, v, j = (int(i) for i in torch.nonzero(nbr >= 0)[0])
    return w, v, j


def pack_edge_dropped():
    def change(host):
        w, v, j = _first_edge(host["nbr"])
        host["nbr"][w, v, j] = -1
    return _packing(change)


def pack_edge_moved():
    def change(host):
        w, v, j = _first_edge(host["nbr"])
        n = int((host["vwgt"][0] > 0).sum())
        host["nbr"][w, v, j] = (int(host["nbr"][w, v, j]) + 1) % n
    return _packing(change)


def pack_keys_swapped():
    def change(host):
        host["keys"][[0, 1]] = host["keys"][[1, 0]].clone()
    return _packing(change)


def fm_by_another_way():
    """The FM kernel reached under a name the recorder does not wrap."""
    from repro_torch.kernels import fm_fused, ops

    def make(fn):
        def refine(*a, **kw):
            recorded = ops.fm_fused_multi
            ops.fm_fused_multi = fm_fused.fm_fused_multi
            try:
                return fn(*a, **kw)
            finally:
                ops.fm_fused_multi = recorded
        return refine
    return patched(ops, "fm_refine_batch", make)


CASES = [(SINGLE, fm_unchanged, "fm_bad"),
         (SINGLE, match_half, "match_bad"),
         (SINGLE, match_altered, "match_bad"),
         (SINGLE, perm_altered, "not_perm"),
         (STREAM, fm_unchanged, "fm_bad"),
         (STREAM, match_half, "match_bad"),
         (SINGLE, pack_edge_dropped, "fmpack_bad"),
         (SINGLE, pack_edge_moved, "fmpack_bad"),
         (SINGLE, pack_keys_swapped, "fmpack_bad"),
         (STREAM, pack_edge_dropped, "fmpack_bad"),
         (SINGLE, fm_by_another_way, "unchecked"),
         (STREAM, fm_by_another_way, "unchecked")]


@pytest.mark.parametrize("cell", [SINGLE, STREAM])
def test_sound_runs_are_correct(cell):
    res = testing.cpu_run(cell)["result"]
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell,fault,number", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f, _ in CASES])
def test_fault_is_not_correct(cell, fault, number):
    res = testing.cpu_run(cell, window_hook=fault)["result"]
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


@pytest.mark.parametrize("cell", [SINGLE, STREAM])
def test_control_is_not_correct(cell):
    res = testing.cpu_run(
        cell, window_hook=lambda: control.installed("short_matching")
    )["result"]
    assert res["correct"] is False
    assert res["checks"]["match_bad"]["value"] > 0

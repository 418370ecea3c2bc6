"""The band BFS's roofline count (CPU): the bytes of a call by hand, the
recorder's shapes, and the trace's kernels matched by their whole name."""
from __future__ import annotations

import pytest
import torch

from orderbench import harness, readers, record, roofline, testing

#: two lanes of 4 rows padded to 3 slots, each row's ids first (as the
#: program packs them); vertex 3 of lane 0 is padding
NBR = [[[1, -1, -1], [0, 2, -1], [1, -1, -1], [-1, -1, -1]],
       [[1, 2, 3], [0, 2, -1], [0, 1, -1], [0, -1, -1]]]
SRC = [[1, 0, 0, 0], [0, 0, 1, 0]]
#: 1 + 2 + 1 + 0 and 3 + 2 + 2 + 1 ids; 2 × 4 sources read and 2 × 4
#: distances written, 4 bytes each
SLOTS = 12
BYTES = 4 * SLOTS + 4 * 8 + 4 * 8


def _call(shapes: bool):
    from repro_torch.core import band
    rec = record.Recorder(seed=1)
    rec.shapes = shapes
    nbr = torch.tensor(NBR, dtype=torch.int32)
    src = torch.tensor(SRC, dtype=torch.int32)
    with rec.installed():
        band.bfs_multi(nbr, src, 3)
    return rec.bfs_launch_shapes()


def test_bfs_launch_bytes_by_hand():
    (launch,) = _call(shapes=True)
    assert launch == {"shape": (2, 4, 3), "slots": SLOTS}
    assert roofline.bfs_launch_bytes(launch["shape"], launch["slots"]) \
        == BYTES == 112
    assert roofline.bfs_bound_s([launch, launch]) == \
        2 * BYTES / roofline.HBM_BYTES_PER_S
    assert _call(shapes=False) == []


@pytest.mark.parametrize("trace_name,counted", [
    ("void (anonymous namespace)::bfs_lanes<true>(int const*, int const*, "
     "int*, int*, int, int, int, bool, int, int)", True),
    ("(anonymous namespace)::bfs_init(int const*, int*, long)", True),
    ("bfs_relax", True),
    ("void (anonymous namespace)::dbfs_lanes<2>(int const*, int const*)",
     False),
    ("(anonymous namespace)::dbfs_init(int const*, int*)", False),
    ("void (anonymous namespace)::bfs_lanes_wide(int const*)", False),
])
def test_kernel_name_is_the_whole_name(trace_name, counted):
    assert bool(readers.BFS_KERNEL.search(trace_name)) is counted


def _window(kernel_s, launches):
    w = harness.Window()
    w.profile = {"kernel_s": kernel_s}
    w.bfs_launches = launches
    return w


def test_bfs_roofline_counts_only_the_band_kernels():
    launch = {"shape": (2, 4, 3), "slots": SLOTS}
    dist = {"void (anonymous namespace)::dbfs_lanes<0>(int const*)": 1e-3,
            "(anonymous namespace)::dbfs_init(int const*, int*)": 1e-3}
    assert readers.bfs_roofline_pct(_window(dist, [launch])) is None
    band = dict(dist, **{
        "void (anonymous namespace)::bfs_lanes<true>(int const*)": 3e-9,
        "(anonymous namespace)::bfs_init(int const*, int*, long)": 1e-9})
    got = readers.bfs_roofline_pct(_window(band, [launch]))
    assert got == pytest.approx(100.0 * BYTES / roofline.HBM_BYTES_PER_S
                                / 4e-9)
    assert readers.bfs_roofline_pct(_window(band, [])) is None


def _traced_window(monkeypatch, nd=None) -> harness.Window:
    seen = []

    class Kept(harness.Window):
        def __init__(self):
            super().__init__()
            seen.append(self)
    monkeypatch.setattr(harness, "Window", Kept)
    res = testing.cpu_run("m3d-30-noband.single", traced=True,
                          nd=nd)["result"]
    assert res["correct"], res["checks"]
    (w,) = seen
    assert w.profile is not None
    return w


def test_no_band_run_has_no_bfs_roofline(monkeypatch):
    w = _traced_window(monkeypatch)
    assert w.bfs_launches == []
    assert readers.bfs_roofline_pct(w) is None


def test_band_run_keeps_each_bfs_call_shape(monkeypatch):
    w = _traced_window(monkeypatch, nd={"use_band": True})
    assert w.bfs_launches
    for d in w.bfs_launches:
        L, n, dmax = d["shape"]
        assert 0 < d["slots"] <= L * n * dmax

"""The distributed ordering's parts on a group of devices.

``dgraph.make_parts_group`` is the counterpart of the reference's
``make_parts_mesh``: a collective called with ``group=`` places its P
parts on the group's members in contiguous blocks, and gathers each
member's rows into the others' replicas between its phases.  On the CPU a
group of CPU devices runs the kernels' plain versions under the same
schedule.  Every result must equal the one-device call's bit for bit
(exact equality is the stated tolerance: the collectives move integer
words and the matching's float scores are the same single adds), for
groups of D = 2, 3 and P (an uneven split at P = 8, D = 3), several
lanes, empty parts, and the matching dense, at its lossless cap and at a
cap that drops proposals; then the orderings through
``distributed_order_batch`` and the service.  The reference's own
permutation at groups of 1, 3 and 8 is checked in ``test_torch_dnd.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import dgraph as D
from repro_torch.core import dnd
from repro_torch.core.dnd import DBFSWork, DHaloWork, DMatchWork, DNDConfig
from repro_torch.graphs import generators as G
from repro_torch.kernels import dgraph_ops as K
from repro_torch.service import OrderingService
from repro_torch.service.router import execute_wave

CPU = "cpu"
GROUPS = (2, 3, 8)
GATHER_FREE = dict(centralize_threshold=256, band_central_threshold=128)


def _group(size: int, nparts: int = 8) -> D.PartsGroup:
    return D.make_parts_group([CPU] * size, nparts)


def _stack(case: str = "lanes"):
    """``lanes``: three lanes of two same-bucket graphs over 8 parts;
    ``empty``: one graph whose parts 1 and 4 are empty (an induced
    subgraph keeps each part's kept vertices in place), so vtxdist repeats
    entries inside a member's range and at a member's edge."""
    a = D.distribute(G.grid2d(20, 17), 8)
    if case == "lanes":
        dgs = [a, D.distribute(G.grid2d(17, 20), 8), a]
        assert len({D.dgraph_bucket(d) for d in dgs}) == 1
        return dgs
    keep = D.shard_gids(a) % 5 != 0
    keep[[1, 4]] = False
    c = D.dgraph_induced(a, keep)[0]
    assert list(c.n_loc).count(0) == 2
    return [c]


CASES = ("lanes", "empty")


def _inputs(dgs, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.integers(-99, 1 << 20, (d.nparts, d.n_loc_max)).astype(
        np.int32) for d in dgs]
    srcs = [(rng.random((d.nparts, d.n_loc_max)) < 0.04).astype(np.int32)
            for d in dgs]
    return xs, srcs, [11 + 7 * k for k in range(len(dgs))]


def test_layout_is_contiguous_balanced_blocks():
    assert _group(3).ranges == ((0, 2), (2, 5), (5, 8))
    assert _group(8).ranges == tuple((p, p + 1) for p in range(8))
    g = _group(3)
    # a fold's fewer parts take the first min(D, P) members
    assert g.layout(2) == ((0, 1), (1, 2))
    assert g.layout(1) == ((0, 1),)
    assert g.layout(5) == ((0, 1), (1, 3), (3, 5))
    assert not _group(2).distinct and g.size == 3


def test_make_parts_group_raises_without_the_cards():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < 4:
        with pytest.raises(RuntimeError):
            D.make_parts_group(4, 8)
    with pytest.raises(RuntimeError):
        D.make_parts_group(have + 1, 8)
    with pytest.raises(RuntimeError):
        D.make_parts_group([f"cuda:{have}"] * 2, 8)
    with pytest.raises(ValueError):
        D.make_parts_group([CPU] * 9, 8)
    with pytest.raises(ValueError):
        D.make_parts_group([], 8)
    with pytest.raises(ValueError):
        D.make_parts_group(["cpu", "meta"], 8)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("size", GROUPS)
def test_halo_on_a_group_equals_one_device(size, case):
    dgs = _stack(case)
    xs, _, _ = _inputs(dgs)
    want = D.halo_exchange_stacked(dgs, xs, device=CPU)
    with D.instrument() as ins:
        got = D.halo_exchange_stacked(dgs, xs, group=_group(size))
    L, (P, nlm) = len(dgs), xs[0].shape
    for dg, x, lane, one in zip(dgs, xs, got, want):
        assert np.array_equal(lane, one)
        assert np.array_equal(lane, D.halo_reference(dg, x))
    rec, = ins.launches
    assert rec["group"] == size
    assert rec["xbytes"] == (size - 1) * 4 * L * P * nlm
    # float32 words move bit for bit too
    xf = [x.astype(np.float32) + 0.25 for x in xs]
    for lane, dg, x in zip(D.halo_exchange_stacked(dgs, xf,
                                                   group=_group(size)),
                           dgs, xf):
        assert np.array_equal(lane.view(np.int32),
                              D.halo_reference(dg, x).view(np.int32))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("width", [0, 1, 3])
@pytest.mark.parametrize("size", GROUPS)
def test_bfs_on_a_group_equals_one_device(size, width, case):
    dgs = _stack(case)
    _, srcs, _ = _inputs(dgs, width)
    want = D.distributed_bfs_stacked(dgs, srcs, width, device=CPU)
    with D.instrument() as ins:
        got = D.distributed_bfs_stacked(dgs, srcs, width, group=_group(size))
    for lane, one, dg, src in zip(got, want, dgs, srcs):
        assert np.array_equal(lane, one)
        assert np.array_equal(lane, D.distributed_bfs(dg, src, width,
                                                      device=CPU))
    L, P, nlm = len(dgs), *dgs[0].nbr_gst.shape[:2]
    rec, = ins.launches
    assert (rec["group"], rec["xbytes"]) == (
        size, width * (size - 1) * 4 * L * P * nlm)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("size", GROUPS)
def test_matching_on_a_group_equals_one_device(size, case):
    dgs = _stack(case)
    _, _, seeds = _inputs(dgs)
    want = D.distributed_matching_stacked(dgs, seeds, device=CPU)
    with D.instrument() as ins:
        got = D.distributed_matching_stacked(dgs, seeds, group=_group(size))
    for lane, one, dg, seed in zip(got, want, dgs, seeds):
        assert np.array_equal(lane, one)
        assert np.array_equal(lane, D.distributed_matching(
            dg, seed, flat=False, device=CPU))
    flat = D.unshard_vector(dgs[0], got[0])
    assert (flat != np.arange(dgs[0].n_global)).any()
    rec, = ins.launches
    L, P, nlm = len(dgs), *dgs[0].nbr_gst.shape[:2]
    # a round gathers the proposals (targets and weights, or at the path's
    # cap the compacted targets, weights and proposer gids), and each round
    # after the first the mates first; the empty parts' case compacts
    cap = rec["cap"]
    assert (cap > 0) == (case == "empty")
    width = 3 * cap if cap else 2 * nlm
    assert rec["xbytes"] == (size - 1) * 4 * L * P * (8 * width + 7 * nlm)


def _match_args(dgs, seeds):
    st = [torch.from_numpy(np.stack([np.asarray(getattr(d, f), np.int32)
                                     for d in dgs]))
          for f in ("nbr_gst", "ewgt_gst", "ghost_gid", "vtxdist", "n_loc")]
    return st + [torch.tensor([s & 0x7FFFFFFF for s in seeds],
                              dtype=torch.int32)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rounds", [1, 8])
@pytest.mark.parametrize("size", GROUPS)
def test_matching_on_a_group_at_caps(size, rounds, case):
    """The group's compacted gather at the lossless cap and at caps that
    drop proposals: each part keeps its first ``cap`` in row order, as the
    one-device kernels' rank does (``dmatch_plain``)."""
    dgs = _stack(case)
    _, _, seeds = _inputs(dgs)
    nlm = dgs[0].n_loc_max
    args = _match_args(dgs, seeds)
    lossless = D._match_proposal_cap(dgs, nlm)
    group = _group(size)
    for cap in (lossless, 3, 1):
        moved = []
        got = D._dmatch_group(group, group.ranges, dgs, seeds, rounds, cap,
                              moved)
        want = K.dmatch_plain(*args, rounds, cap)
        assert np.array_equal(got, want.numpy()), cap
        L, P = len(dgs), dgs[0].nparts
        assert sum(moved) == (size - 1) * 4 * L * P * (
            3 * cap * rounds + nlm * (rounds - 1))
    assert not np.array_equal(K.dmatch_plain(*args, rounds, 1),
                              K.dmatch_plain(*args, rounds, lossless))


def test_group_member_phases_check_their_inputs():
    dgs = _stack()
    args = _match_args(dgs, [1, 2, 3])
    with pytest.raises(ValueError):          # structure of 8 parts for 2
        K.DMatchParts(*args, parts=(0, 2))
    with pytest.raises(ValueError):
        K.DMatchParts(*[a[:, 2:4] if a.dim() > 2 else a for a in args],
                      parts=(2, 5))
    with pytest.raises(ValueError):
        K.part_range(8, (3, 3))
    dist = torch.zeros((3, 8, dgs[0].n_loc_max), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.dbfs_init(dist[:, :2], args[2][:, :3], args[3], dist, (0, 2))


def test_part_range_plain_versions_cover_the_whole_call():
    """The halo and the BFS step on ranges that tile the parts give the
    whole call's rows; the CPU counts no launch."""
    dgs = _stack()
    xs, srcs, _ = _inputs(dgs, 4)
    x = torch.from_numpy(np.stack(xs))
    gg = torch.from_numpy(np.stack([d.ghost_gid for d in dgs]).astype(
        np.int32))
    vd = torch.from_numpy(np.stack([d.vtxdist for d in dgs]).astype(np.int32))
    nbr = torch.from_numpy(np.stack([d.nbr_gst for d in dgs]))
    tables = [D.ghost_slots(d, torch.device(CPU)) for d in dgs]
    whole = K.halo(x, tables)
    before = (K.halo_launches, K.dbfs_launches, K.relax_launches)
    parts = ((0, 3), (3, 4), (4, 8))
    assert torch.equal(torch.cat([K.halo(x, tables, p) for p in parts], 1),
                       whole)
    src = torch.from_numpy(np.stack(srcs))
    want = K.dbfs_plain(nbr, src, gg, vd, 2)
    bufs = torch.empty((2, *src.shape), dtype=torch.int32)
    slots = [K.dbfs_init(src[:, a:b], gg[:, a:b], vd, bufs[0], (a, b))
             for a, b in parts]
    for k in range(2):
        for (a, b), s in zip(parts, slots):
            K.dbfs_step(nbr[:, a:b], bufs[k % 2], bufs[(k + 1) % 2], s,
                        (a, b))
    assert torch.equal(bufs[0], want)
    assert (K.halo_launches, K.dbfs_launches, K.relax_launches) == before


def test_planned_launches_of_group_records():
    """A group of D members launches each kernel on each member: the grid
    design, D launches a halo, D inits and D relaxations a BFS step, and
    a matching round's propose (+ compaction), post and commit on each."""
    def rec(kind, bucket, rounds, **kw):
        return {"kind": kind, "nparts": 8, "bucket": bucket,
                "rounds": rounds, **kw}
    small = (4096, 8, 2048)               # the cluster design alone
    recs = [rec("dhalo", small, 1, group=3),
            rec("dbfs", small, 3, group=3),
            rec("dmatch", small, 8, cap=0, group=3),
            rec("dmatch", small, 8, cap=5, group=2),
            rec("dbfs", small, 3, group=1),
            rec("dmatch", small, 8, cap=0)]
    assert K.planned_launches(recs) == {
        "halo_launches": 3, "dbfs_launches": 3 + 1, "relax_launches": 9,
        "dmatch_launches": 3 * 25 + 2 * 33 + 1}
    assert K.plan(8, 4096, 8, group=2) == ("grid", None)
    assert K.dmatch_count("grid", 8, 0, group=4) == 4 * 25
    assert K.dbfs_counts("grid", 3, group=4) == (4, 12)


@pytest.mark.parametrize("size", GROUPS)
def test_a_wave_on_a_group_equals_one_device(size):
    dgs = _stack()
    xs, srcs, seeds = _inputs(dgs, 2)
    works = [w for dg, x, src, seed in zip(dgs, xs, srcs, seeds)
             for w in (DHaloWork(dg, x), DBFSWork(dg, src, 3),
                       DMatchWork(dg, seed))]
    want, _ = execute_wave(works, device=CPU)
    with D.instrument() as ins:
        got, summary = execute_wave(works, device=CPU, group=_group(size))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert summary["launches"] == {"dhalo": 1, "dbfs": 1, "dmatch": 1}
    assert {r["group"] for r in ins.launches} == {size}


def _small_requests():
    return [D.distribute(G.grid2d(22, 20), 8),
            D.distribute(G.grid2d(18, 18), 4)]


def test_order_batch_on_a_group_equals_one_device():
    dgs = _small_requests()
    cfgs = [DNDConfig(**GATHER_FREE)] * 2
    want = dnd.distributed_order_batch(dgs, [0, 3], cfgs, device=CPU)
    group = _group(3)
    with D.instrument() as ins:
        got = dnd.distributed_order_batch(dgs, [0, 3], cfgs, group=group)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    # the 8-part root on three members, the 4-part one and the folds on
    # the first two or three
    sizes = {r["group"] for r in ins.launches if r["kind"][0] == "d"}
    assert {2, 3} <= sizes
    assert all(r["xbytes"] > 0 for r in ins.launches
               if r.get("group", 1) > 1)


def test_depth_first_driver_on_a_group_equals_one_device():
    dg = _small_requests()[1]
    cfg = DNDConfig(frontier=False, **GATHER_FREE)
    want = dnd.distributed_nested_dissection(dg, 1, cfg, device=CPU)
    got = dnd.distributed_nested_dissection(dg, 1, cfg, group=_group(4, 4))
    assert np.array_equal(got, want)
    sep = dnd.distributed_separator(dg, 2, cfg, device=CPU)
    assert np.array_equal(dnd.distributed_separator(dg, 2, cfg,
                                                    group=_group(2, 4)), sep)


def test_submit_distributed_on_a_group_equals_one_device():
    dg = _small_requests()[0]
    cfg = DNDConfig(**GATHER_FREE)
    want = dnd.distributed_nested_dissection(dg, 0, cfg, device=CPU)
    svc = OrderingService(group=_group(3))
    assert svc.device == torch.device(CPU) and svc.group.size == 3
    rid = svc.submit_distributed(dg, 0, cfg)
    svc.drain()
    res = svc.poll(rid)
    assert res.status == "ok" and not res.cached and np.array_equal(res.perm, want)
    again = svc.submit_distributed(dg, 0, cfg)
    assert svc.poll(again).cached


def test_group_calls_from_threads_are_serialised():
    """Threads sharing one group (a service's pumps and a caller's direct
    calls): each call holds the group for its phases, so every result is
    its own one-device result."""
    import sys
    import threading
    dgs = _stack()
    group = _group(3)
    cases = [_inputs(dgs, seed) for seed in range(4)]
    want = [D.halo_exchange_stacked(dgs, xs, device=CPU)
            for xs, _, _ in cases]
    bad, old = [], sys.getswitchinterval()

    def run(k):
        xs, srcs, _ = cases[k]
        for _ in range(5):
            got = D.halo_exchange_stacked(dgs, xs, group=group)
            if not all(np.array_equal(a, b) for a, b in zip(got, want[k])):
                bad.append(k)
            D.distributed_bfs_stacked(dgs, srcs, 1, group=group)
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad

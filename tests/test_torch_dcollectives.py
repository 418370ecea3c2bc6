"""The distributed collectives' plain versions against the reference.

The reference's ``halo_exchange_stacked``, ``distributed_bfs_stacked``
and ``distributed_matching_stacked`` are ``shard_map`` programs; they run
once per file in a subprocess with 8 virtual host devices
(``procutil.run_json_script``).  Under jax 0.9.0 the ``shard_map``
varying-axes check rejects the matching's scan carry, so the child first
replaces ``jax.experimental.shard_map.shard_map`` with a wrapper around
``jax.shard_map(..., check_vma=False)`` (``SHIM``); no reference file
changes.  The port runs the same graphs in process with
``device="cpu"``, where the kernels' plain versions run, and must equal
the reference bit for bit: on the graphs of
``test_dnd_frontier.py::STACK_SCRIPT``, on a folded DGraph with empty
trailing parts and on a layout with an empty middle part, singleton and
lane-stacked, the matching against the reference's protocol with its
proposal compaction on and off (the port always runs the reference's
default, compaction on; its cap is lossless).  The launch records'
``words`` / ``cap`` / ``words_dense`` equal the reference's for
singleton calls (a stacked call has ``lanes_pad == lanes`` in the port,
the next power of two in the reference).
"""
import ctypes
import dataclasses
import os
import textwrap
import types

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from procutil import run_json_script  # noqa: E402
from repro.kernels.ops import ell_relax_step as jax_relax  # noqa: E402
from repro_torch.core import dgraph as D  # noqa: E402
from repro_torch.core.dnd import DBFSWork, DHaloWork, DMatchWork, \
    DNDConfig  # noqa: E402
from repro_torch.graphs import generators as G  # noqa: E402
from repro_torch.kernels import dgraph_ops as K  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.service.fingerprint import \
    dgraph_fingerprint  # noqa: E402
from repro_torch.service.router import execute_wave  # noqa: E402

CPU = "cpu"

#: run in the child before anything imports ``repro.core.dgraph``
SHIM = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.experimental.shard_map as _sm

    def _shard_map(f, mesh=None, in_specs=None, out_specs=None, **kw):
        kw.pop("check_rep", None)
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False, **kw)

    _sm.shard_map = _shard_map
""")

#: the cases, built with ``D`` (a dgraph module) and ``G`` (generators)
CASES = textwrap.dedent("""
    def build_cases(D, G):
        g0 = G.grid2d(13, 11)
        g0.vwgt = (1 + np.arange(g0.n) % 3).astype(np.int64)
        g20 = D.distribute(G.grid2d(20, 20), 8)
        return {
            "g13x11": D.distribute(g0, 4),
            "g12x12": D.distribute(G.grid2d(12, 12), 4),
            "g10x14": D.distribute(G.grid2d(10, 14), 4),
            "rgg150": D.distribute(G.rgg2d(150, seed=1), 4),
            # induced in place, then folded: parts 2-3 are empty
            "folded": D.dgraph_fold(
                D.dgraph_induced(g20, D.shard_gids(g20) < 150)[0]),
            # induced in place: parts 1, 4 and 7 are empty
            "induced": D.dgraph_induced(
                g20, (D.shard_gids(g20) // 50) % 3 != 1)[0],
            "mid_empty": D.distribute(
                g0, 4, vtxdist=np.array([0, 40, 40, 100, 143])),
        }

    def inputs(dg, k):
        rng = np.random.default_rng(k)
        x = rng.integers(0, 9, (dg.nparts, dg.n_loc_max)).astype(np.int32)
        return x, (x % 3 == 0).astype(np.int32), 7 + k

    STACK = ("g13x11", "g12x12", "g10x14")
""")

SCRIPT = SHIM + textwrap.dedent("""
    import json
    import numpy as np
    from repro.core import dgraph as D
    from repro.graphs import generators as G
""") + CASES + textwrap.dedent("""
    cases = build_cases(D, G)
    out = {}
    for k, name in enumerate(sorted(cases)):
        dg = cases[name]
        x, src, seed = inputs(dg, k)
        res = {"halo": D.halo_exchange_fn(dg)(x).tolist()}
        # the reference's owner slots: its halo of each slot's own index
        iota = np.arange(dg.nparts * dg.n_loc_max, dtype=np.int32)
        res["slots"] = D.halo_exchange_fn(dg)(
            iota.reshape(dg.nparts, -1)).tolist()
        for width in (1, 3):
            res[f"bfs{width}"] = D.distributed_bfs(dg, src, width).tolist()
        for compact in (False, True):
            D.set_match_compact(compact)
            with D.instrument() as ins:
                m = D.distributed_matching(dg, seed, flat=False)
            res[f"match{int(compact)}"] = m.tolist()
            res[f"record{int(compact)}"] = {
                f: ins.launches[0][f] for f in ("words", "cap",
                                                "words_dense")}
        out[name] = res
    dgs = [cases[n] for n in STACK]
    ins_ = [inputs(cases[n], sorted(cases).index(n)) for n in STACK]
    D.set_match_compact(True)
    out["stacked"] = {
        "halo": [a.tolist() for a in D.halo_exchange_stacked(
            dgs, [i[0] for i in ins_])],
        "bfs": [a.tolist() for a in D.distributed_bfs_stacked(
            dgs, [i[1] for i in ins_], 3)],
        "match": [a.tolist() for a in D.distributed_matching_stacked(
            dgs, [i[2] for i in ins_])],
    }
    print(json.dumps(out))
""")

_CACHE: dict = {}
NAMES = ("folded", "g10x14", "g12x12", "g13x11", "induced", "mid_empty",
         "rgg150")


def _ref() -> dict:
    if "out" not in _CACHE:
        _CACHE["out"] = run_json_script(SCRIPT, timeout=400)
    return _CACHE["out"]


def _cases():
    if "cases" not in _CACHE:
        scope = {"np": np}
        exec(CASES, scope)
        _CACHE["cases"] = (scope["build_cases"](D, G), scope["inputs"],
                           scope["STACK"])
    return _CACHE["cases"]


def _case(name):
    cases, inputs, _ = _cases()
    dg = cases[name]
    return dg, inputs(dg, sorted(cases).index(name))


def test_cases_keep_their_shapes():
    cases, _, stack = _cases()
    assert tuple(sorted(cases)) == NAMES
    assert len({D.dgraph_bucket(cases[n]) for n in stack}) == 1
    assert D.dgraph_bucket(cases["rgg150"]) != D.dgraph_bucket(
        cases["g13x11"])
    # empty parts repeat vtxdist entries, at the end and in the middle
    assert list(cases["folded"].n_loc).count(0) >= 1
    assert list(cases["mid_empty"].n_loc) == [40, 0, 60, 43]
    assert [k for k, n in enumerate(cases["induced"].n_loc) if n == 0] == \
        [1, 4, 7]
    # every case pads some part's ghost slots with -1
    assert all((cases[n].ghost_gid < 0).any() for n in NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_halo_equals_reference(name):
    dg, (x, _, _) = _case(name)
    got = D.halo_exchange_fn(dg, CPU)(x)
    assert got.dtype == np.int32
    assert np.array_equal(got, np.array(_ref()[name]["halo"]))
    assert np.array_equal(got, D.halo_reference(dg, x))
    # float32 words move bit for bit too
    xf = x.astype(np.float32) + 0.5
    assert np.array_equal(D.halo_exchange_fn(dg, CPU)(xf),
                          D.halo_reference(dg, xf))


# ------------------------------------------------------------------ #
# the halo's ghost slot tables: resolved once a DGraph, kept beside it
# ------------------------------------------------------------------ #
def _fresh_cases() -> dict:
    """The cases built anew: DGraphs on which no slot table is kept."""
    scope = {"np": np}
    exec(CASES, scope)
    return scope["build_cases"](D, G)


def _iota(dg):
    return np.arange(dg.nparts * dg.n_loc_max,
                     dtype=np.int32).reshape(dg.nparts, -1)


@pytest.mark.parametrize("name", NAMES)
def test_slot_table_equals_owner_slots_and_reference_owners(name):
    """The kept table is ``lane_slots``: ``owner_slots`` on real ghosts,
    -1 on padding, and the reference's owner slots (its halo of each
    slot's own index), on bucketed, folded and induced layouts with
    empty parts."""
    dg, _ = _case(name)
    P, nlm = dg.nparts, dg.n_loc_max
    table = D.ghost_slots(dg, torch.device(CPU))
    assert table.dtype == torch.int32
    assert table.shape == dg.ghost_gid.shape
    gg = torch.from_numpy(dg.ghost_gid.astype(np.int32))[None]
    vd = torch.from_numpy(dg.vtxdist.astype(np.int32))[None]
    assert torch.equal(table, K.lane_slots(gg, vd, nlm)[0])
    real = dg.ghost_gid >= 0
    flat = K.owner_slots(gg.reshape(1, -1), vd, nlm).reshape(table.shape)
    assert np.array_equal(table.numpy()[real], flat.numpy()[real])
    assert (table.numpy()[~real] == -1).all()
    ref = np.array(_ref()[name]["slots"])
    assert np.array_equal(ref[:, :nlm], _iota(dg))
    assert np.array_equal(np.where(real, table.numpy(), 0), ref[:, nlm:])
    assert (table.numpy() < P * nlm).all()


def test_slot_tables_resolved_once_per_dgraph():
    """Repeated exchanges of one DGraph resolve its table once; a wave of
    several DGraphs (some repeated) one table a distinct DGraph, in one
    launch record; the table stays out of the fields, the repr and the
    fingerprint."""
    cases = _fresh_cases()
    dgs = [cases[n] for n in ("g13x11", "g12x12", "g10x14")]
    xs = [_iota(d) * 3 + k for k, d in enumerate(dgs)]
    fp = dgraph_fingerprint(dgs[0], 0, DNDConfig())
    before = D.slot_resolutions
    for _ in range(3):
        got = D.halo_exchange_fn(dgs[0], CPU)(xs[0])
        assert np.array_equal(got, D.halo_reference(dgs[0], xs[0]))
    assert D.slot_resolutions == before + 1
    works = [DHaloWork(dgs[k % 3], xs[k % 3]) for k in range(7)]
    for _ in range(2):
        with D.instrument() as ins:
            outs, summary = execute_wave(works, device=CPU)
        assert D.slot_resolutions == before + 3
        assert summary["launches"]["dhalo"] == 1 == len(ins.launches)
        for w, out in zip(works, outs):
            assert np.array_equal(out, D.halo_reference(w.dg, w.x))
    assert dgraph_fingerprint(dgs[0], 0, DNDConfig()) == fp
    assert "_ghost_slots" not in repr(dgs[0])
    assert "_ghost_slots" not in {f.name for f in dataclasses.fields(D.DGraph)}
    assert dgs[0] == dgs[0]


@pytest.mark.parametrize("rebuild", ["fold", "induced", "coarsen"])
def test_rebuilt_dgraph_gets_its_own_table(rebuild):
    """A structure rebuild makes a new DGraph, which resolves its own
    table (the old one keeps its), and exchanges bit for bit."""
    dg = _fresh_cases()["g12x12"]
    old = D.ghost_slots(dg, torch.device(CPU))
    if rebuild == "fold":
        new = D.dgraph_fold(dg)
    elif rebuild == "induced":
        new, _ = D.dgraph_induced(dg, D.shard_gids(dg) % 3 != 0)
    else:
        new, _ = D.dgraph_coarsen(dg, D.distributed_matching(
            dg, 5, flat=False, device=CPU))
    before = D.slot_resolutions
    x = _iota(new) + 1
    assert np.array_equal(D.halo_exchange_fn(new, CPU)(x),
                          D.halo_reference(new, x))
    assert D.slot_resolutions == before + 1
    table = D.ghost_slots(new, torch.device(CPU))
    assert table is not old and D.ghost_slots(dg, torch.device(CPU)) is old
    assert torch.equal(table, K.lane_slots(
        torch.from_numpy(new.ghost_gid.astype(np.int32))[None],
        torch.from_numpy(new.vtxdist.astype(np.int32))[None],
        new.n_loc_max)[0])
    assert D.slot_resolutions == before + 1


def _slot_of(vd, P, nlm, lane, g):
    """dgraph.cu's slot_of: gid g's flat slot over every lane (int64 in
    the grid matching's table), by owner_of's upper-bound search, -1 for
    g < 0."""
    if g < 0:
        return -1
    lo, hi = 0, P + 1
    while lo < hi:
        mid = (lo + hi) >> 1
        if vd[mid] <= g:
            lo = mid + 1
        else:
            hi = mid
    o = min(max(lo - 1, 0), P - 1)
    return lane * P * nlm + o * nlm + min(max(g - int(vd[o]), 0), nlm - 1)


def test_int32_lane_tables_match_the_int64_flat_form():
    """Over many lanes (ranges with an empty part, ghost ids past the
    last part and -1): the int32 lane-local table plus the lane's base
    is the int64 flat slot of dgraph.cu's search, and a grid BFS step
    reading ghosts through either (the lane base from the row's lane)
    is the plain version's step."""
    rng = np.random.default_rng(16)
    L, P, nlm, d, Gn = 16, 5, 24, 6, 12
    vd = np.zeros((L, P + 1), np.int64)
    for lane in range(L):
        sizes = rng.integers(nlm // 2, nlm + 1, P)
        sizes[lane % P] = 0
        vd[lane, 1:] = np.cumsum(sizes)
    gg = rng.integers(-1, int(vd[:, -1].max()) + 4, (L, P, Gn))
    t32 = K.lane_slots(torch.from_numpy(gg.astype(np.int32)),
                       torch.from_numpy(vd.astype(np.int32)), nlm)
    assert t32.dtype == torch.int32
    flat = np.array([[[_slot_of(vd[lane], P, nlm, lane, g) for g in part]
                      for part in gg[lane]] for lane in range(L)])
    base = (np.arange(L) * P * nlm)[:, None, None]
    assert np.array_equal(np.where(gg >= 0, t32.numpy() + base, -1), flat)
    # one grid BFS step, ghosts read through each table
    nbr = torch.from_numpy(rng.integers(-1, nlm + Gn + 2, (L, P, nlm, d)
                                        ).astype(np.int32))
    dist = torch.from_numpy(rng.integers(0, 9, (L, P, nlm)).astype(np.int32))
    src = (dist == 0).int()
    dist = torch.where(src != 0, 0, K.BIG).int()
    every = dist.reshape(-1)
    by_lane = dist.reshape(L, P * nlm)
    ghosts32 = torch.where(t32 >= 0, by_lane.gather(
        1, t32.clamp(min=0).reshape(L, -1).long()).reshape(t32.shape), 0)
    f64 = torch.from_numpy(flat)
    ghosts64 = torch.where(f64 >= 0, every[f64.clamp(min=0)], 0)
    assert torch.equal(ghosts32, ghosts64)
    ext = torch.cat([dist, ghosts32], dim=2).reshape(L * P, -1)
    step = torch.minimum(dist, K.ell_relax_plain(
        nbr.reshape(L * P, nlm, d), ext, K.BIG).reshape(L, P, nlm))
    assert torch.equal(step, K.dbfs_plain(
        nbr, src, torch.from_numpy(gg.astype(np.int32)),
        torch.from_numpy(vd.astype(np.int32)), 1))


def test_halo_checks_its_lanes_and_tables():
    """A table a lane, alike, 1 to HALO_LANES lanes (the kernel's
    parameter block), and one vector of the bucket's shape a graph."""
    tb = torch.full((3, 4), -1, dtype=torch.int32)
    x = torch.zeros((2, 3, 8), dtype=torch.int32)
    for bad in ([tb], [tb, tb[:2]], [tb, tb.long()]):
        with pytest.raises(ValueError):
            K.halo(x, bad)
    with pytest.raises(ValueError):
        K.halo(x[:0], [])
    most = torch.zeros((K.HALO_LANES + 1, 3, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.halo(most, [tb] * (K.HALO_LANES + 1))
    assert K.halo(most[1:], [tb] * K.HALO_LANES).shape == (K.HALO_LANES, 3,
                                                            12)
    dg, (xg, _, _) = _case("g13x11")
    for dgs, xs in (([dg], [xg[:, :-1]]), ([dg, dg], [xg])):
        with pytest.raises(ValueError):
            D.halo_exchange_stacked(dgs, xs, device=CPU)


def test_stacked_halo_of_many_dgraphs_equals_singletons():
    """Twelve lanes of five DGraphs (three cases, two fresh copies) with
    float32 words: each lane its singleton exchange and the host oracle,
    bit for bit."""
    cases, _, stack = _cases()
    fresh = _fresh_cases()
    pool = [cases[n] for n in stack] + [fresh[n] for n in stack[:2]]
    dgs = [pool[k % len(pool)] for k in range(12)]
    rng = np.random.default_rng(12)
    xs = [rng.standard_normal((d.nparts, d.n_loc_max)).astype(np.float32)
          for d in dgs]
    got = D.halo_exchange_stacked(dgs, xs, device=CPU)
    for dg, x, lane in zip(dgs, xs, got):
        assert lane.dtype == np.float32
        assert np.array_equal(lane.view(np.int32),
                              D.halo_reference(dg, x).view(np.int32))
        assert np.array_equal(lane, D.halo_exchange_fn(dg, CPU)(x))


@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("name", NAMES)
def test_bfs_equals_reference(name, width):
    dg, (_, src, _) = _case(name)
    got = D.distributed_bfs(dg, src, width, device=CPU)
    assert np.array_equal(got, np.array(_ref()[name][f"bfs{width}"]))


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_matching_equals_reference(name, compact):
    """The port's matching equals the reference's with compaction on
    (its record too) and off (the reference's dense protocol); the
    kernels' dense call (cap 0) gives the same mates as the port's."""
    dg, (_, _, seed) = _case(name)
    with D.instrument() as ins:
        got = D.distributed_matching(dg, seed, flat=False, device=CPU)
    ref = _ref()[name]
    assert np.array_equal(got, np.array(ref[f"match{int(compact)}"]))
    rec = {f: ins.launches[0][f] for f in ("words", "cap", "words_dense")}
    ref_rec = ref[f"record{int(compact)}"]
    if compact:
        assert rec == ref_rec
    else:
        assert ref_rec["cap"] == 0
        assert ref_rec["words"] == ref_rec["words_dense"] \
            == rec["words_dense"]
        args = [torch.from_numpy(np.asarray(a, np.int32)[None]) for a in (
            dg.nbr_gst, dg.ewgt_gst, dg.ghost_gid, dg.vtxdist, dg.n_loc)]
        seeds = torch.tensor([seed & 0x7FFFFFFF], dtype=torch.int32)
        assert torch.equal(K.dmatch(*args, seeds, 8, 0),
                           K.dmatch(*args, seeds, 8, rec["cap"]))
    assert (rec["cap"] > 0) == (rec["words"] < rec["words_dense"])
    # an involution on real vertices, and some vertex really matched
    flat = D.unshard_vector(dg, got)
    assert np.array_equal(flat[flat], np.arange(dg.n_global))
    assert (flat != np.arange(dg.n_global)).any()


def test_stacked_lanes_equal_reference_and_singletons():
    cases, inputs, stack = _cases()
    dgs = [cases[n] for n in stack]
    ins_ = [inputs(cases[n], sorted(cases).index(n)) for n in stack]
    ref = _ref()["stacked"]
    with D.instrument() as ins:
        halo = D.halo_exchange_stacked(dgs, [i[0] for i in ins_],
                                       tags=["a", "b", "c"], device=CPU)
        bfs = D.distributed_bfs_stacked(dgs, [i[1] for i in ins_], 3,
                                        device=CPU)
        match = D.distributed_matching_stacked(dgs, [i[2] for i in ins_],
                                               device=CPU)
    for got, kind in ((halo, "halo"), (bfs, "bfs"), (match, "match")):
        for j, lane in enumerate(got):
            assert np.array_equal(lane, np.array(ref[kind][j])), (kind, j)
    for j, dg in enumerate(dgs):
        x, src, seed = ins_[j]
        assert np.array_equal(halo[j], D.halo_exchange_fn(dg, CPU)(x))
        assert np.array_equal(bfs[j], D.distributed_bfs(dg, src, 3,
                                                        device=CPU))
        assert np.array_equal(match[j], D.distributed_matching(
            dg, seed, flat=False, device=CPU))
    # one record a stacked call, with only the real lanes
    recs = [r for r in ins.launches]
    assert [r["kind"] for r in recs] == ["dhalo", "dbfs", "dmatch"]
    assert all(r["lanes"] == r["lanes_pad"] == 3 for r in recs)
    assert recs[0]["tags"] == ["a", "b", "c"]
    assert len(ins.halos) == 3


def test_mixed_wave_launches_equal_buckets_and_singletons():
    cases, inputs, _ = _cases()
    works = []
    for k, name in enumerate(sorted(cases)):
        dg = cases[name]
        x, src, seed = inputs(dg, k)
        works += [DHaloWork(dg, x), DBFSWork(dg, src, 3),
                  DMatchWork(dg, seed=seed)]
    with D.instrument() as ins:
        outs, summary = execute_wave(works, device=CPU)
    ref = _ref()
    for k, name in enumerate(sorted(cases)):
        halo, bfs, match = outs[3 * k:3 * k + 3]
        assert np.array_equal(halo, np.array(ref[name]["halo"]))
        assert np.array_equal(bfs, np.array(ref[name]["bfs3"]))
        assert np.array_equal(match, np.array(ref[name]["match1"]))
    for kind in ("dhalo", "dbfs", "dmatch"):
        assert summary["launches"][kind] == summary["buckets"][kind] \
            < summary["works"][kind] == len(cases)
    assert len(ins.launches) == sum(summary["launches"].values())


@pytest.mark.parametrize("L,n,d,m", [(1, 40, 4, 40), (3, 50, 6, 90),
                                     (2, 7, 1, 20)])
def test_ell_relax_step_equals_reference(L, n, d, m):
    rng = np.random.default_rng(L * 100 + d)
    nbr = rng.integers(0, m, (L, n, d)).astype(np.int32)
    nbr[rng.random((L, n, d)) < 0.3] = -1
    ext = rng.integers(0, 50, (L, m)).astype(np.int32)
    big = 2 ** 30
    want = np.asarray(jax_relax(jnp.asarray(nbr), jnp.asarray(ext), big))
    got = ops.ell_relax_step(nbr, ext, big, device=CPU)
    assert np.array_equal(got.numpy(), want)
    for j in range(L):                  # the 2-D form, lane by lane
        want1 = np.asarray(jax_relax(jnp.asarray(nbr[j]),
                                     jnp.asarray(ext[j]), big))
        assert np.array_equal(
            ops.ell_relax_step(nbr[j], ext[j], big, device=CPU).numpy(),
            want1)


def test_ids_outside_the_vector_are_padding():
    """An id past the vector (or past the ghost slots) reads as padding,
    so no input makes a kernel read outside its buffers."""
    rng = np.random.default_rng(9)
    nbr = rng.integers(0, 30, (2, 20, 5)).astype(np.int32)
    ext = torch.from_numpy(rng.integers(0, 9, (2, 30)).astype(np.int32))
    bad = nbr.copy()
    bad[:, ::3, 1] = 30 + np.arange(7)[None, :]
    pad = nbr.copy()
    pad[:, ::3, 1] = -1
    assert torch.equal(K.ell_relax(torch.from_numpy(bad), ext, 99),
                       K.ell_relax(torch.from_numpy(pad), ext, 99))
    dg, (_, _, seed) = _case("g13x11")
    W = dg.n_loc_max + dg.ghost_gid.shape[1]
    args = [torch.from_numpy(np.asarray(a, np.int32)[None]) for a in (
        dg.nbr_gst, dg.ewgt_gst, dg.ghost_gid, dg.vtxdist, dg.n_loc)]
    seeds = torch.tensor([seed], dtype=torch.int32)
    nb = args[0].clone()
    nb[0, :, :, -1] = torch.where(nb[0, :, :, -1] < 0, W + 3, -1)
    pd = nb.clone()
    pd[pd >= W] = -1
    assert torch.equal(K.dmatch(nb, *args[1:], seeds, 4),
                       K.dmatch(pd, *args[1:], seeds, 4))


# ------------------------------------------------------------------ #
# the card's designs of the BFS and the matching (kernels.dgraph_ops)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("side,want", [(16, ("cluster", 2)),
                                       (30, ("cluster", 16)),
                                       (40, ("grid", None))])
def test_plan_of_the_distributed_buckets(side, want):
    """grid3d(30³) over 8 parts, the distributed ordering's root bucket
    (8, 4096, 8, 2048), is 2^18 slots a lane: the largest the cluster
    takes, at 16 CTAs; grid3d(16³) takes 2, grid3d(40³) the grid."""
    dg = D.distribute(G.grid3d(side, side, side), 8)
    P, nlm, d, ghosts = D.dgraph_bucket(dg)
    assert K.plan(P, nlm, d) == want
    if side == 30:
        assert (P, nlm, d, ghosts) == (8, 4096, 8, 2048)


@pytest.mark.parametrize("shape,want", [
    ((8, 131072, 8), ("grid", None)),     # grid3d(100³) over 8 parts
    ((8, 4096, 8), ("cluster", 16)),      # 2^18 slots
    ((8, 4097, 8), ("grid", None)),
    ((2, 256, 32), ("cluster", 1)),       # the waves' many-lane buckets
    ((2, 128, 32), ("cluster", 1)),
    ((4, 64, 4), ("cluster", 1))])
def test_plan_by_lane_slots(shape, want):
    assert K.plan(*shape) == want


@pytest.mark.parametrize("width", [0, 1, 3])
def test_dbfs_launch_counts(width):
    assert K.dbfs_counts("cluster", width) == (1, 0)
    assert K.dbfs_counts("grid", width) == (1, width)


@pytest.mark.parametrize("cap", [0, 5])
@pytest.mark.parametrize("rounds", [0, 1, 8])
def test_dmatch_launch_counts(rounds, cap):
    assert K.dmatch_count("cluster", rounds, cap) == 1
    assert K.dmatch_count("grid", rounds, cap) == \
        1 + (3 if cap else 2) * rounds


def test_planned_launches_of_records():
    """Records of the cluster and grid buckets: one launch a cluster
    call, the grid's per-round and per-step launches."""
    def rec(kind, P, bucket, rounds, **kw):
        return {"kind": kind, "nparts": P, "bucket": bucket,
                "rounds": rounds, **kw}
    recs = [rec("dhalo", 8, (4096, 8, 2048), 1),
            rec("dbfs", 8, (4096, 8, 2048), 3),
            rec("dmatch", 8, (4096, 8, 2048), 8, cap=0),
            rec("dbfs", 8, (8192, 8, 4096), 3),
            rec("dmatch", 8, (8192, 8, 4096), 8, cap=0),
            rec("dmatch", 8, (8192, 8, 4096), 8, cap=5),
            rec("bfs", 0, (8192, 16), 3)]
    assert K.planned_launches(recs) == {
        "relax_launches": 3, "halo_launches": 1, "dbfs_launches": 2,
        "dmatch_launches": 1 + 17 + 25}


def test_stacked_calls_plan_one_launch_each_and_run_plain_on_cpu():
    """The CPU runs the plain versions and counts no launch; the records
    of a stacked call plan one cluster launch a BFS and a matching."""
    cases, inputs, stack = _cases()
    dgs = [cases[n] for n in stack]
    ins_ = [inputs(cases[n], sorted(cases).index(n)) for n in stack]
    before = (K.relax_launches, K.dbfs_launches, K.dmatch_launches)
    with D.instrument() as ins:
        D.distributed_bfs_stacked(dgs, [i[1] for i in ins_], 3, device=CPU)
        D.distributed_matching_stacked(dgs, [i[2] for i in ins_],
                                       device=CPU)
    assert (K.relax_launches, K.dbfs_launches, K.dmatch_launches) == before
    assert K.planned_launches(ins.launches) == {
        "relax_launches": 0, "halo_launches": 0, "dbfs_launches": 1,
        "dmatch_launches": 1}


class _Entries:
    """A stand-in for the dgraph library whose BFS and matching entries
    report ``reply`` (own kernels, ell_relax kernels, placement code) as
    what they enqueued, and record their names and arguments."""

    def __init__(self, reply):
        self.reply, self.calls = reply, []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            (ctypes.c_int * 3).from_address(args[-2])[:] = self.reply
            return 0
        return entry


@pytest.mark.parametrize("design,C,reply,place", [
    ("cluster", 16, (1, 0, 2), "distributed"),
    ("cluster", 1, (1, 0, 1), "shared"),
    ("cluster", 2, (1, 0, 0), "device"),
    ("grid", None, (2, 5, -1), "grid")])
def test_kernel_wrappers_count_what_the_entries_report(monkeypatch, design,
                                                        C, reply, place):
    """``dbfs_kernel`` and ``dmatch_kernel`` add what the C entry says it
    enqueued (here a grid reply no design's formula gives), not what the
    plan predicts, and name the state's placement."""
    fake = _Entries(reply)
    monkeypatch.setattr(K.build, "load", lambda name: fake)
    monkeypatch.setattr(K, "_stream", lambda t: 0)
    dg, (_, src, _) = _case("g13x11")
    t = {f: torch.from_numpy(np.asarray(getattr(dg, f), np.int32)[None])
         for f in ("nbr_gst", "ewgt_gst", "ghost_gid", "vtxdist", "n_loc")}
    before = (K.dbfs_launches, K.relax_launches, K.dmatch_launches)
    K.dbfs_kernel(t["nbr_gst"], torch.from_numpy(
        np.asarray(src, np.int32)[None]), t["ghost_gid"], t["vtxdist"], 3,
        design, C)
    assert K.state_place == place
    K.dmatch_kernel(*t.values(), torch.tensor([7], dtype=torch.int32), 8,
                    0, design, C)
    assert K.state_place == place
    assert (K.dbfs_launches, K.relax_launches, K.dmatch_launches) == (
        before[0] + reply[0], before[1] + reply[1], before[2] + reply[0])
    suffix = "_cluster_launch" if design == "cluster" else "_launch"
    assert [n for n, _ in fake.calls] == ["dbfs" + suffix, "dmatch" + suffix]
    if C is not None:                    # C, the counts, the stream
        assert all(a[-3] == C for _, a in fake.calls)


# A scalar model of the cluster matching (csrc/dgraph.cu, dmatch_lanes):
# each row's round role in a byte, each ghost's code resolved once (its
# owner slot, whose role byte holds the ghost's coin when the owner row
# has the ghost's gid; else -2 - slot and the ghost's own coin; -1 when no
# real row answers), and with a cap each proposal's rank in its part as
# its part's proposals on earlier CTAs plus its CTA's before it.  CTA k of
# C takes the lane's rows [k << s, (k + 1) << s), s = share_shift(N, C),
# as the kernel's `share` gives them, so a part may span CTAs and a CTA
# may get no row.  It must give the plain version's mates for any C.
OFF, PROPOSER, ACCEPTOR = 0, 1, 2


def share_shift(n, C):
    """dgraph.cu's share_shift: the smallest s with 2^s * C >= n."""
    per, s = -(-n // C), 0
    while (1 << s) < per:
        s += 1
    return s


def _hash(*xs):
    from repro_torch.core.matching import hash_mix
    return int(hash_mix(*(torch.tensor(x) for x in xs)))


def _grant(w, gid, tg, r):
    from repro_torch.core.matching import hash_unit
    from repro_torch.kernels.matching import grant_word
    score = torch.tensor([w], dtype=torch.float32) + hash_unit(
        torch.tensor([gid]), tg, r + 31)
    return int(grant_word(score, torch.tensor([gid]))[0])


def _cluster_match_model(dg, seed, rounds, cap, C):
    from repro_torch.core.matching import hash_unit
    P, nlm, d = dg.nbr_gst.shape
    gg, vd, nl = dg.ghost_gid, np.asarray(dg.vtxdist), np.asarray(dg.n_loc)
    N, empty = P * nlm, -2 ** 63
    slot = K.owner_slots  # (L, K) gids -> (L, K) flat slots

    def owner(g):
        return int(slot(torch.tensor([[g]]), torch.tensor(vd[None]),
                        nlm)[0, 0])

    def rows_of(n, k):
        shift = share_shift(n, C)
        return min(n, k << shift), min(n, (k + 1) << shift)

    def role(gid, r):
        return PROPOSER if _hash(gid, r, seed) & 1 else ACCEPTOR

    def code(tg):
        if tg < 0:
            return -1
        f = owner(tg)
        if f % nlm >= nl[f // nlm]:
            return -1
        return f if vd[f // nlm] + f % nlm == tg else -2 - f

    m = [-1] * N
    ro = [role(vd[v // nlm] + v % nlm, 0) if v % nlm < nl[v // nlm]
          else OFF for v in range(N)]
    codes = [code(int(tg)) for tg in gg.reshape(-1)]
    H = gg.shape[1]
    for r in range(rounds):
        cur, prop = [empty] * N, {}
        for v in (v for v in range(N) if ro[v] == PROPOSER):
            p, gid, best = v // nlm, vd[v // nlm] + v % nlm, None
            for j, c in enumerate(dg.nbr_gst[p, v % nlm]):
                if 0 <= c < nlm and ro[p * nlm + c] == ACCEPTOR:
                    tg = vd[p] + c
                elif nlm <= c < nlm + H and codes[p * H + c - nlm] != -1:
                    k, tg = codes[p * H + c - nlm], int(gg[p, c - nlm])
                    if k >= 0 and ro[k] != ACCEPTOR or k < -1 and (
                            ro[-2 - k] == OFF or _hash(tg, r, seed) & 1):
                        continue
                else:
                    continue
                w = float(dg.ewgt_gst[p, v % nlm, j])
                score = float(torch.tensor(w, dtype=torch.float32) +
                              hash_unit(torch.tensor(gid), tg, r + 17))
                if best is None or score > best[0]:
                    best = (score, tg, w)
            prop[v] = best
        posted = [v for v in sorted(prop) if prop[v]]
        if cap:
            pre, cnt = {}, np.zeros((C, P), np.int64)
            for k in range(C):
                lo, hi = rows_of(N, k)
                mine = [v for v in posted if lo <= v < hi]
                for i, v in enumerate(mine):
                    pre[v] = i
                for v in mine:
                    cnt[k, v // nlm] += 1
            kept = []
            for k in range(C):
                lo, hi = rows_of(N, k)
                for v in (v for v in posted if lo <= v < hi):
                    p = v // nlm
                    first = min(u for u in posted
                                if lo <= u < hi and u // nlm == p)
                    if cnt[:k, p].sum() + pre[v] - pre[first] < cap:
                        kept.append(v)
            posted = kept
        for v in posted:
            f = owner(prop[v][1])
            cur[f] = max(cur[f], _grant(prop[v][2], vd[v // nlm] + v % nlm,
                                        prop[v][1], r))
        for v in range(N):
            if ro[v] == OFF:
                continue
            gid, mate = vd[v // nlm] + v % nlm, -1
            if ro[v] == ACCEPTOR and cur[v] != empty:
                mate = 0x7FFFFFFF - (cur[v] & 0xFFFFFFFF)
            elif ro[v] == PROPOSER and prop[v] and \
                    cur[owner(prop[v][1])] & 0xFFFFFFFF == 0x7FFFFFFF - gid:
                mate = prop[v][1]
            if mate >= 0:
                m[v] = mate
            ro[v] = OFF if mate >= 0 else role(gid, r + 1)
    return np.array(m).reshape(P, nlm)


def far_ghosts(dg):
    """``dg``'s arrays with every fifth ghost's gid past the last part:
    its owner slot is clipped to the last part's last row, a real row
    with another gid when the last part is full."""
    gg = np.array(dg.ghost_gid)
    pick = (gg >= 0) & (np.arange(gg.size).reshape(gg.shape) % 5 == 0)
    gg[pick] = dg.vtxdist[-1] + 3
    return types.SimpleNamespace(
        nbr_gst=dg.nbr_gst, ewgt_gst=dg.ewgt_gst, ghost_gid=gg,
        vtxdist=dg.vtxdist, n_loc=dg.n_loc, n_loc_max=dg.n_loc_max)


@pytest.mark.parametrize("C", [1, 3, 16])
@pytest.mark.parametrize("cap", ["dense", "lossless", 3])
@pytest.mark.parametrize("name", ["g13x11", "far_ghosts"])
def test_cluster_matching_model_equals_plain(name, cap, C):
    """At 3 CTAs of 2^s rows the third gets no row, and at 16 every part
    of 64 rows spans four CTAs;
    ``far_ghosts`` (grid2d(16, 16) over 4 full parts) has ghosts whose
    owner row has another gid."""
    if name == "far_ghosts":
        full = D.distribute(G.grid2d(16, 16), 4)
        dg, seed = far_ghosts(full), 0   # a seed that tells the coins apart
        assert list(full.n_loc) == [full.n_loc_max] * 4
    else:
        dg, (_, _, seed) = _case(name)
    nlm = dg.n_loc_max
    cap = {"dense": 0, "lossless": D._match_proposal_cap([dg], nlm)}.get(
        cap, cap)
    args = [torch.from_numpy(np.asarray(a, np.int32)[None]) for a in (
        dg.nbr_gst, dg.ewgt_gst, dg.ghost_gid, dg.vtxdist, dg.n_loc)]
    want = K.dmatch_plain(*args, torch.tensor([seed], dtype=torch.int32),
                          4, cap)[0].numpy()
    rows = 1 << share_shift(dg.nbr_gst.shape[0] * nlm, C)
    if C == 3:                           # the third CTA gets no row
        assert 2 * rows >= dg.nbr_gst.shape[0] * nlm
    if C == 16:                          # each part spans CTAs
        assert rows < nlm
    got = _cluster_match_model(dg, seed, 4, cap, C)
    assert np.array_equal(got, want)
    if name == "far_ghosts":             # the -2 - slot codes are reached
        assert any(int(t) >= int(dg.vtxdist[-1]) for t in
                   np.asarray(dg.ghost_gid).reshape(-1))
    assert (want >= 0).any()

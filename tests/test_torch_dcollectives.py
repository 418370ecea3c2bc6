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
import os
import textwrap

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from procutil import run_json_script  # noqa: E402
from repro.kernels.ops import ell_relax_step as jax_relax  # noqa: E402
from repro_torch.core import dgraph as D  # noqa: E402
from repro_torch.core.dnd import DBFSWork, DHaloWork, \
    DMatchWork  # noqa: E402
from repro_torch.graphs import generators as G  # noqa: E402
from repro_torch.kernels import dgraph_ops as K  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
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
NAMES = ("folded", "g10x14", "g12x12", "g13x11", "mid_empty", "rgg150")


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

"""The port's distributed nested dissection against the reference.

The reference orders ``grid2d(28, 28)`` distributed over 8 parts with
the gather-free configuration of ``test_dnd_gatherfree.py``
(``centralize_threshold=256, band_central_threshold=128``, so the
sharded alternating-colour band refinement runs) under both drivers, in
one subprocess with 8 virtual host devices and the ``check_vma=False``
shim of ``test_torch_dcollectives.SHIM`` (applied in the child; no
reference file changes).  The port, with ``device="cpu"`` (the kernels'
plain versions), must give the same permutation bit for bit under both
drivers, keep every centralizing gather under the configuration's
bound, assemble the same permutation sharded, and refine its bands with
zero cross-shard conflicts and zero repairs.  At 2 parts the port's
gather log equals the reference's, one-part subtrees above the bound
included.  The same permutation comes out when the parts lie on a group
of 3 or of 8 CPU devices (``dgraph.make_parts_group``; 8 is the
reference's own layout, one part a device).  ``distributed_order_batch``
of three requests equals each ordered alone, and the service's
``submit_distributed`` returns the same permutation, then a cache hit.
"""
import os
import textwrap

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from procutil import run_json_script  # noqa: E402
from repro.core.dnd import conflict_loser as jax_loser  # noqa: E402
from repro_torch.core import dgraph as D  # noqa: E402
from repro_torch.core import dnd  # noqa: E402
from repro_torch.core.dnd import DNDConfig, DistOrdering  # noqa: E402
from repro_torch.graphs import generators as G  # noqa: E402
from repro_torch.service import OrderingService  # noqa: E402

CPU = "cpu"
SIDE = 28
GATHER_FREE = dict(centralize_threshold=256, band_central_threshold=128)

SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.experimental.shard_map as _sm

    def _shard_map(f, mesh=None, in_specs=None, out_specs=None, **kw):
        kw.pop("check_rep", None)
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False, **kw)

    _sm.shard_map = _shard_map
    import json
    from repro.core.dgraph import distribute, track_gathers
    from repro.core.dnd import DNDConfig, distributed_nested_dissection
    from repro.graphs import generators as G

    dg = distribute(G.grid2d({side}, {side}), 8)
    kw = dict(centralize_threshold=256, band_central_threshold=128)
    out = {{}}
    for frontier in (True, False):
        perm = distributed_nested_dissection(
            dg, seed=0, cfg=DNDConfig(frontier=frontier, **kw))
        out[str(frontier)] = perm.tolist()
    # two parts: each dissection child is a one-part subtree of ~280
    # vertices, above the gather-free bound of 256
    with track_gathers() as log:
        perm = distributed_nested_dissection(
            distribute(G.grid2d(24, 24), 2), seed=0, cfg=DNDConfig(**kw))
    out["two_parts"] = {{"perm": perm.tolist(), "gathers": log}}
    print(json.dumps(out))
""").format(side=SIDE)

_CACHE: dict = {}


def _ref() -> dict:
    if "ref" not in _CACHE:
        _CACHE["ref"] = run_json_script(SCRIPT, timeout=500)
    return _CACHE["ref"]


def _dg():
    return D.distribute(G.grid2d(SIDE, SIDE), 8)


def _ordered(frontier: bool, groups: int = 1):
    """The port's ordering tree of grid2d(28, 28) at P 8 under one driver,
    with its gathers, band stats and waves: on the CPU, or with its parts
    on a group of ``groups`` > 1 CPU devices."""
    key = ("dnd", frontier, groups)
    if key not in _CACHE:
        cfg = DNDConfig(frontier=frontier, **GATHER_FREE)
        place = (dict(device=CPU) if groups == 1 else
                 dict(group=D.make_parts_group([CPU] * groups, 8)))
        with D.instrument() as ins:
            dord = dnd.distributed_nested_dissection(
                _dg(), seed=0, cfg=cfg, return_tree=True, **place)
        _CACHE[key] = (dord, ins, cfg)
    return _CACHE[key]


@pytest.mark.parametrize("groups", [1, 3, 8])
@pytest.mark.parametrize("frontier", [True, False])
def test_distributed_nd_equals_reference(frontier, groups):
    dord, ins, _ = _ordered(frontier, groups)
    perm = dord.assemble()
    assert np.array_equal(np.sort(perm), np.arange(SIDE * SIDE))
    assert np.array_equal(perm, np.array(_ref()[str(frontier)]))
    assert {"dmatch", "dbfs"} <= {r["kind"] for r in ins.launches}
    assert {"match", "bfs", "fm", "rebuild", "endgame"} <= set(ins.stage_s)
    if frontier:
        # every wave: launches == live buckets ≤ works, per kind
        assert ins.waves and all(
            w["launches"][k] == w["buckets"][k] <= w["works"][k]
            for w in ins.waves for k in w["launches"])
        assert "dhalo" in {k for w in ins.waves for k in w["launches"]}
    else:
        # the depth-first driver runs the distributed works one a call;
        # only its batched endgame goes through router waves
        assert not any(k.startswith("d") for w in ins.waves
                       for k in w["launches"])
        assert all(r["lanes"] == 1 for r in ins.launches
                   if r["kind"].startswith("d"))
    # on a group, the root's collectives span all its members
    sizes = {r.get("group", 1) for r in ins.launches
             if r["kind"].startswith("d")}
    assert max(sizes) == groups


@pytest.mark.parametrize("frontier", [True, False])
def test_gather_free_guarantees(frontier):
    """``test_dnd_gatherfree.py::_check_nd``'s checks on the port."""
    dord, ins, cfg = _ordered(frontier)
    perm = dord.assemble()
    sizes = [s for _, s in ins.gathers]
    bound = max(cfg.centralize_threshold, cfg.band_central_threshold,
                2 * cfg.fold_threshold, cfg.coarse_target)
    assert max(sizes) <= bound and max(sizes) < perm.size // 2
    slices, vtx = dord.assemble_sharded()
    flat = np.concatenate([slices[q, :vtx[q + 1] - vtx[q]]
                           for q in range(len(vtx) - 1)])
    assert np.array_equal(flat, perm)
    assert int((dord.fragment_shards() > 0).sum()) > 1
    stats = ins.band_stats
    assert sum(1 for s in stats if s["schedule"] == "alt") > 0
    assert sum(sum(s["conflicts"]) for s in stats) == 0
    assert sum(sum(s["repairs"]) for s in stats) == 0
    assert all(s["anchor_min"] is None or s["anchor_min"] >= 0
               for s in stats)


def test_one_part_gathers_equal_reference(monkeypatch):
    """The gather-free bound holds for graphs spread over parts; a subtree
    whose process group is one part is handed to the sequential endgame
    whole, in the reference as in the port, whatever its size: at 2
    parts each dissection child is such a subtree above the bound."""
    parts_of = []
    for name in ("to_host", "unshard_vector"):
        fn = getattr(dnd, name)

        def noted(dg, *args, _fn=fn, **kw):
            parts_of.append(dg.nparts)
            return _fn(dg, *args, **kw)
        monkeypatch.setattr(dnd, name, noted)
    cfg = DNDConfig(**GATHER_FREE)
    bound = max(cfg.centralize_threshold, cfg.band_central_threshold,
                2 * cfg.fold_threshold, cfg.coarse_target)
    with D.track_gathers() as log:
        perm = dnd.distributed_nested_dissection(
            D.distribute(G.grid2d(24, 24), 2), seed=0, cfg=cfg, device=CPU)
    ref = _ref()["two_parts"]
    assert np.array_equal(perm, np.array(ref["perm"]))
    assert [tuple(g) for g in ref["gathers"]] == log
    assert len(parts_of) == len(log)
    above = [p for p, (_, n) in zip(parts_of, log) if n > bound]
    assert above and set(above) == {1}


def test_order_batch_equals_each_alone():
    cfg = DNDConfig(**GATHER_FREE)
    dgs = [_dg(), D.distribute(G.grid2d(20, 20), 8),
           D.distribute(G.grid2d(14, 12), 4)]
    seeds = [0, 1, 2]
    with D.instrument() as ins:
        batch = dnd.distributed_order_batch(dgs, seeds, [cfg] * 3,
                                            device=CPU)
    alone = [_ordered(True)[0].assemble()] + [
        dnd.distributed_nested_dissection(dg, seed=s, cfg=cfg, device=CPU)
        for dg, s in zip(dgs[1:], seeds[1:])]
    for a, b in zip(batch, alone):
        assert np.array_equal(a, b)
    assert max(w["requests"] for w in ins.waves) == 3
    assert any(w["shared_launches"] > 0 for w in ins.waves)
    with pytest.raises(AssertionError):
        dnd.distributed_order_batch(dgs[:1], 0, [DNDConfig(frontier=False)],
                                    device=CPU)


def test_submit_distributed_then_cache_hit():
    cfg = DNDConfig(**GATHER_FREE)
    svc = OrderingService(device=CPU)
    rid = svc.submit_distributed(_dg(), seed=0, cfg=cfg)
    svc.drain()
    res = svc.poll(rid)
    assert res.status == "ok" and not res.cached
    assert np.array_equal(res.perm, _ordered(True)[0].assemble())
    rid2 = svc.submit_distributed(_dg(), seed=0, cfg=cfg)
    res2 = svc.poll(rid2)
    assert res2 is not None and res2.cached
    assert np.array_equal(res2.perm, res.perm)
    st = svc.stats()
    assert st["computed"] == 1 and st["cache_hits"] == 1


def test_dist_ordering_tree_assembly():
    do = DistOrdering(10, 3)
    c0 = do.add_node(DistOrdering.root, 0, 4)
    c1 = do.add_node(DistOrdering.root, 4, 6)
    do.add_fragment(c0, np.array([3, 1, 0, 2]), 0)
    do.add_sharded_fragments(c1, [np.array([9, 8]), np.array([], int),
                                  np.array([7, 6, 5, 4])])
    perm = do.assemble()
    assert perm.tolist() == [3, 1, 0, 2, 9, 8, 7, 6, 5, 4]
    slices, vtx = do.assemble_sharded()
    flat = np.concatenate([slices[q, :vtx[q + 1] - vtx[q]]
                           for q in range(3)])
    assert np.array_equal(flat, perm)
    assert do.fragment_shards().tolist() == [2, 0, 1]
    with pytest.raises(AssertionError):
        do.add_node(c0, 3, 5)           # escapes the parent's block
    bad = DistOrdering(8, 2)
    b0 = bad.add_node(DistOrdering.root, 0, 4)
    bad.add_node(DistOrdering.root, 4, 4)
    bad.add_fragment(b0, np.arange(4), 0)
    with pytest.raises(AssertionError):
        bad.assemble()                  # a gap: the second node is empty


@pytest.mark.parametrize("rnd,seed", [(0, 0), (1, 5), (3, 1 << 40)])
def test_conflict_loser_equals_reference(rnd, seed):
    rng = np.random.default_rng(rnd)
    vg = rng.integers(0, 10 ** 6, 2048)
    ug = rng.integers(0, 10 ** 6, 2048)
    keep = vg != ug
    vg, ug = vg[keep], ug[keep]
    mine = dnd.conflict_loser(vg, ug, rnd, seed)
    assert np.array_equal(mine, jax_loser(vg, ug, rnd, seed))
    assert np.all(mine ^ dnd.conflict_loser(ug, vg, rnd, seed))


@pytest.mark.parametrize("central", [True, False])
def test_distributed_separator_and_band_refine_are_valid(central):
    """``distributed_separator`` and the band-refinement wrapper (sharded
    or centralized by ``band_central_threshold``) return valid
    separators: no 0-1 edge, both sides non-empty, padding 3."""
    cfg = DNDConfig(band_central_threshold=10 ** 9 if central else 0)
    dg = D.distribute(G.grid2d(16, 16), 4)
    src, dst, _ = D.dgraph_arcs(dg)

    def check(part_sh):
        v = D.valid_mask(dg)
        assert np.all(part_sh[~v] == 3)
        flat = D._raster_flat(dg, part_sh)
        assert min((flat == 0).sum(), (flat == 1).sum()) > 0
        assert not np.any((flat[src] == 0) & (flat[dst] == 1))

    part = dnd.distributed_separator(dg, 3, cfg, device=CPU)
    check(part)
    col = np.arange(dg.n_global) % 16
    plane = np.where(col < 7, 0, np.where(col > 7, 1, 2)).astype(np.int8)
    with dnd.track_band_stats() as stats:
        refined = dnd._band_refine_level_sh(
            dg, D.shard_vector(dg, plane, fill=3), 5, 4, cfg, device=CPU)
    check(refined)
    assert len(stats) == (0 if central else 1)

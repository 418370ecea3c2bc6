"""The plain reference: the symbolic factorisation against a dense
elimination, and the kernels' and collectives' definitions against the
program's plain versions on the CPU (the program's kernels equal those on
the card, which the benchmark's runs check)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from orderbench import gen, testing  # noqa: F401  (puts src on the path)
from orderbench.reference import dist as dref
from orderbench.reference import kernels as ref
from orderbench.reference import pack, symbolic, threefry

GRAPHS = [("grid2d", gen.grid2d(7, 9)), ("grid3d", gen.grid3d(4, 5, 3)),
          ("circuit", gen.circuit(60, 1)), ("rgg2d", gen.rgg2d(80, 2)),
          ("cage_like", gen.cage_like(64, 3))]


@pytest.mark.parametrize("name,g", GRAPHS)
def test_symbolic_counts_equal_dense_elimination(name, g):
    rng = np.random.default_rng(7)
    for perm in (np.arange(g.n), rng.permutation(g.n), rng.permutation(g.n)):
        c = symbolic.counts(g.xadj, g.adjncy, perm)
        assert np.array_equal(c, symbolic.dense_counts(g.xadj, g.adjncy,
                                                       perm))
        nnz, opc = symbolic.nnz_opc(g.xadj, g.adjncy, perm)
        assert nnz == c.sum() and opc == float((c.astype(float) ** 2).sum())


def test_is_permutation():
    assert symbolic.is_permutation(np.array([2, 0, 1]), 3)
    assert not symbolic.is_permutation(np.array([2, 0, 0]), 3)
    assert not symbolic.is_permutation(np.array([0, 1]), 3)
    assert not symbolic.is_permutation(np.array([0, 1, 3]), 3)


def test_threefry_matches_the_programs_draws():
    from repro_torch import prng
    for seed in (0, 5, 2 ** 31 + 3):
        k = prng.PRNGKey(seed)
        rk = threefry.key(seed)
        assert np.array_equal(prng.split(k, 5).numpy(),
                              threefry.split(rk, 5).astype(np.int64))
        assert np.array_equal(prng.uniform(k, (3, 7)).numpy(),
                              threefry.uniform(rk, (3, 7)))
        assert np.array_equal(prng.bernoulli(k, 0.5, (11,)).numpy(),
                              threefry.bernoulli(rk, 0.5, (11,)))


def _ell(g, n_pad=None, d_pad=None):
    deg = np.diff(g.xadj)
    n_pad = n_pad or g.n
    d_pad = d_pad or int(deg.max())
    nbr = np.full((n_pad, d_pad), -1, np.int32)
    wgt = np.zeros((n_pad, d_pad), np.int32)
    for v in range(g.n):
        row = g.adjncy[g.xadj[v]:g.xadj[v + 1]]
        nbr[v, :len(row)] = row
        wgt[v, :len(row)] = g.adjwgt[g.xadj[v]:g.xadj[v + 1]]
    return nbr, wgt


@pytest.mark.parametrize("name,g", GRAPHS)
def test_bfs_and_matching_equal_the_programs(name, g):
    from repro_torch.kernels.band_batch import bfs_multi_plain
    from repro_torch.kernels.matching import heavy_edge_matching_multi_plain
    nbr, wgt = _ell(g, n_pad=128, d_pad=16)
    rng = np.random.default_rng(3)
    src = (rng.random((2, 128)) < 0.05).astype(np.int32)
    nbr2 = np.stack([nbr, nbr])
    want = bfs_multi_plain(torch.from_numpy(nbr2), torch.from_numpy(src), 3)
    assert np.array_equal(ref.bfs(nbr2, src, 3), want.numpy())
    keys = np.array([[0, 9], [0, 2 ** 31 + 1]], np.int64)
    want = heavy_edge_matching_multi_plain(
        torch.from_numpy(nbr2), torch.from_numpy(np.stack([wgt, wgt])),
        torch.from_numpy(keys), 8)
    assert np.array_equal(ref.match(nbr2, np.stack([wgt, wgt]), keys, 8),
                          want.numpy())


@pytest.mark.parametrize("pos_only", [False, True])
def test_fm_equals_the_programs(pos_only):
    from repro_torch.kernels.fm_fused import fm_fused_multi
    g = gen.grid3d(5, 5, 4)
    nbr, _ = _ell(g, n_pad=128, d_pad=8)
    L = 4
    rng = np.random.default_rng(11)
    x = np.arange(128) // 25
    part = np.where(x < 2, 0, np.where(x == 2, 2, 1)).astype(np.int8)
    part[g.n:] = 0
    parts = np.stack([part] * L)
    vwgt = np.stack([np.where(np.arange(128) < g.n, 1, 0)] * L
                    ).astype(np.int64)
    locked = np.zeros((L, 128), bool)
    locked[:, g.n:] = True
    args = dict(
        nbr=torch.from_numpy(nbr[None]),
        lane_work=torch.zeros(L, dtype=torch.int32),
        vwgt=torch.from_numpy(vwgt), parts=torch.from_numpy(parts),
        locked=torch.from_numpy(locked),
        keys=torch.from_numpy(rng.integers(0, 2 ** 31, (L, 2))),
        eps_frac=torch.full((L,), 0.12, dtype=torch.float32),
        max_moves=torch.tensor([40, 40, 0, 25], dtype=torch.int32),
        n_pert=torch.tensor([0, 4, 4, 2], dtype=torch.int32))
    got = fm_fused_multi(*args.values(), passes=3, pos_only=pos_only)
    want = ref.fm(*(t.numpy() for t in args.values()), passes=3,
                  pos_only=pos_only)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("name,g", GRAPHS[:1] + GRAPHS[2:])
def test_distributed_collectives_equal_the_programs(name, g):
    from repro_torch.core import dgraph
    from orderbench.drive import program_graph
    dg = dgraph.distribute(program_graph(g), 4)
    arcs = dref.to_edges(dg.vtxdist, dg.nbr_gst, dg.ghost_gid, dg.n_loc)
    src = np.repeat(np.arange(g.n), np.diff(g.xadj))
    want = np.stack([src, g.adjncy.astype(np.int64)], 1)
    assert np.array_equal(arcs, want[np.lexsort((want[:, 1], want[:, 0]))])
    rng = np.random.default_rng(5)
    x = rng.integers(0, 99, dg.nbr_gst.shape[:2]).astype(np.int32)
    assert np.array_equal(
        dgraph.halo_exchange_stacked([dg], [x], device="cpu")[0],
        dref.halo(dg.vtxdist, dg.ghost_gid, x))
    s = (rng.random(dg.nbr_gst.shape[:2]) < 0.1).astype(np.int32)
    assert np.array_equal(
        dgraph.distributed_bfs_stacked([dg], [s], 3, device="cpu")[0],
        dref.bfs(dg.vtxdist, dg.nbr_gst, dg.ghost_gid, dg.n_loc, s, 3))
    for seed in (3, 2 ** 31 + 9):
        assert np.array_equal(
            dgraph.distributed_matching_stacked([dg], [seed], 8,
                                                device="cpu")[0],
            dref.match(dg.vtxdist, dg.nbr_gst, dg.ewgt_gst, dg.ghost_gid,
                       dg.n_loc, seed, 8))


def test_generators_equal_the_repositorys():
    from repro_torch.graphs import generators as G
    pairs = [(gen.grid3d(5, 6, 7), G.grid3d(5, 6, 7)),
             (gen.grid2d(9, 4), G.grid2d(9, 4)),
             (gen.circuit(500, 3), G.circuit(500, seed=3)),
             (gen.cage_like(300, 4), G.cage_like(300, seed=4))]
    for a, b in pairs:
        for k in ("xadj", "adjncy", "vwgt", "adjwgt"):
            assert np.array_equal(getattr(a, k), getattr(b, k))


def _work(g, seed, k_inst, tries, max_moves):
    from repro_torch.core.fm import FMWork
    from orderbench import drive
    pg = drive.program_graph(g)
    nbr, _ = pg.to_ell()
    rng = np.random.default_rng(seed)
    parts = rng.integers(0, 3, (max(tries, 1), g.n)).astype(np.int8)
    return FMWork(nbr=nbr, vwgt=pg.vwgt, part=parts[0],
                  locked=rng.random(g.n) < 0.2, seed=seed, k_inst=k_inst,
                  eps_frac=0.1, n_pert=4, max_moves=max_moves,
                  parts_init=parts if tries else None)


@pytest.mark.parametrize("k_inst,tries,max_moves",
                         [(8, 0, None), (3, 0, 20), (5, 3, None),
                          (1, 2, 5000)])
def test_packing_equals_the_programs(k_inst, tries, max_moves):
    """``reference.pack`` packs works as the program's FM executor does,
    padding lanes and tiles included."""
    from repro_torch.core import fm as core_fm
    from orderbench import record
    # two works of one bucket: 80 and 99 vertices, degrees up to 6
    works = [_work(gen.grid2d(9, 11), 3, k_inst, tries, max_moves),
             _work(gen.grid3d(4, 4, 5), 5, k_inst, tries, max_moves)]
    host, _ = core_fm.pack_fm_bucket(works)
    args = [host[f].numpy() if hasattr(host[f], "numpy") else host[f]
            for f in pack.FIELDS]
    kept = [record._work(w) for w in works]
    assert pack.check(args, kept)
    want = pack.pack(kept)
    for f, got in zip(pack.FIELDS, args):
        assert np.array_equal(np.asarray(got).astype(np.float64),
                              want[f].astype(np.float64)), f


def _edit(change):
    from orderbench import drive
    ell, _ = drive.program_graph(gen.grid2d(5, 6)).to_ell()
    ell = np.array(ell)
    change(ell)
    return ell


@pytest.mark.parametrize("name,change", [
    ("self_loop", lambda e: e.__setitem__((0, 0), 0)),
    ("one_way", lambda e: e.__setitem__((0, 0), -1)),
    ("repeated", lambda e: e.__setitem__((0, 1), e[0, 0])),
    ("out_of_range", lambda e: e.__setitem__((0, 0), 30))])
def test_unsound_work_graphs_are_refused(name, change):
    assert pack.sound_graph(_edit(lambda e: None), np.ones(30))
    assert not pack.sound_graph(_edit(change), np.ones(30))
    assert not pack.sound_graph(_edit(lambda e: None), -np.ones(30))


def test_fm_call_with_no_works_seen_is_refused():
    assert not pack.check([], None)

"""Plain NumPy definitions of the distributed ordering's collectives.

A distributed graph of P parts holds, per part p, the vertices
``vtxdist[p] <= gid < vtxdist[p + 1]`` as rows ``0 .. n_loc[p] - 1`` of
``(P, nlm, d)`` tables of compact neighbour ids: an id below ``nlm`` is a
row of the same part, an id ``nlm + k`` the part's k-th ghost, whose
global id is ``ghost_gid[p, k]`` (-1 pads).  From that layout these
functions compute, in global terms:

* ``halo``: each part's vector extended by its ghosts' values, read at
  their owners (0 for a padding ghost);
* ``bfs``: each vertex's hop distance from the sources, ``BIG`` beyond
  ``width``;
* ``match``: ``rounds`` rounds of the hash-coin heavy-edge matching (a
  vertex proposes when its coin of (gid, round, seed) is odd, to its
  heaviest unmatched acceptor neighbour, ties broken by a hash of both
  ids; each acceptor grants its heaviest proposal, ties by a hash and
  then the smaller id), the result as each row's mate gid, the row's own
  gid where it stays single, -1 on padding rows.

``to_edges`` reads the layout back into the global graph's edges, which
the benchmark compares with the graph it handed over.
"""
from __future__ import annotations

import numpy as np

BIG = 2 ** 30
_M32 = 0xFFFFFFFF


def _hash_u32(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
        return x ^ (x >> np.uint32(16))


def hash_mix(*xs) -> np.ndarray:
    """lowbias32 chained over the values, each taken mod 2**32."""
    h = None
    shape = np.broadcast_shapes(*(np.shape(x) for x in xs))
    for x in xs:
        x = (np.broadcast_to(np.asarray(x, dtype=np.int64), shape)
             & _M32).astype(np.uint32)
        prev = np.uint32(0x9E3779B9) if h is None else h
        with np.errstate(over="ignore"):
            h = _hash_u32(prev ^ (x * np.uint32(0x85EBCA6B) + np.uint32(1)))
    return h


def hash_unit(*xs) -> np.ndarray:
    """The hash rounded to float32, times 2**-32: a tie break in [0, 1)."""
    return hash_mix(*xs).astype(np.float32) * np.float32(2.0 ** -32)


def _layout(vtxdist, nbr, ghost_gid, n_loc):
    """(row gids (P, nlm), -1 on padding; neighbour gids (P, nlm, d), -1
    on padding slots)."""
    P, nlm, _ = nbr.shape
    G = ghost_gid.shape[1]
    li = np.arange(nlm)
    gid = np.where(li[None] < n_loc[:, None], vtxdist[:-1, None] + li, -1)
    ext = np.concatenate([gid, ghost_gid.astype(np.int64)], axis=1)
    ok = (nbr >= 0) & (nbr < nlm + G)
    tgt = np.take_along_axis(ext[:, None, :].repeat(nlm, 1),
                             np.where(ok, nbr, 0).astype(np.int64), axis=2)
    return gid, np.where(ok, tgt, -1)


def to_edges(vtxdist, nbr, ghost_gid, n_loc) -> np.ndarray:
    """The (gid, neighbour gid) arcs the layout holds, sorted."""
    gid, tgt = _layout(vtxdist, nbr, ghost_gid, n_loc)
    src = np.broadcast_to(gid[:, :, None], tgt.shape)
    keep = (src >= 0) & (tgt >= 0)
    arcs = np.stack([src[keep], tgt[keep]], 1)
    return arcs[np.lexsort((arcs[:, 1], arcs[:, 0]))]


def halo(vtxdist, ghost_gid, x: np.ndarray) -> np.ndarray:
    """x (P, nlm) → (P, nlm + G)."""
    P, nlm = x.shape
    flat = np.zeros(int(vtxdist[-1]), dtype=x.dtype)
    for p in range(P):
        lo, hi = vtxdist[p], vtxdist[p + 1]
        flat[lo:hi] = x[p, :hi - lo]
    g = ghost_gid.astype(np.int64)
    ghosts = np.where(g >= 0, flat[np.clip(g, 0, None)], 0).astype(x.dtype)
    return np.concatenate([x, ghosts], axis=1)


def bfs(vtxdist, nbr, ghost_gid, n_loc, src: np.ndarray,
        width: int) -> np.ndarray:
    """src (P, nlm) nonzero at sources → (P, nlm) int32 hop distances."""
    P, nlm, _ = nbr.shape
    gid, tgt = _layout(vtxdist, nbr, ghost_gid, n_loc)
    n = int(vtxdist[-1])
    dist = np.full(n, BIG, dtype=np.int64)
    real = gid >= 0
    dist[gid[real & (src != 0)]] = 0
    for hop in range(1, width + 1):
        near = np.where(tgt >= 0, dist[np.clip(tgt, 0, None)], BIG).min(2)
        step = np.minimum(dist[np.clip(gid, 0, None)], near + 1)
        dist[gid[real]] = step[real]
    out = np.where(real, dist[np.clip(gid, 0, None)], BIG)
    # a padding row has no neighbours: a source there is at 0
    return np.where(~real & (src != 0), 0, out).astype(np.int32)


def match(vtxdist, nbr, ewgt, ghost_gid, n_loc, seed: int,
          rounds: int) -> np.ndarray:
    """(P, nlm) int64 mate gids (own gid where single, -1 on padding)."""
    gid, tgt = _layout(vtxdist, nbr, ghost_gid, n_loc)
    n = int(vtxdist[-1])
    real = gid >= 0
    w = ewgt.astype(np.float32)
    seed = int(seed) & 0x7FFFFFFF
    mate = np.full(n, -1, dtype=np.int64)
    g_all = np.arange(n)
    rows = np.clip(gid, 0, None)
    for r in range(rounds):
        coin = (hash_mix(g_all, r, seed) & np.uint32(1)) == 1
        single = mate < 0
        t = np.clip(tgt, 0, None)
        cand = (tgt >= 0) & single[t] & ~coin[t]
        score = np.where(cand, w + hash_unit(gid[:, :, None], tgt, r + 17),
                         np.float32(-np.inf))
        slot = score.argmax(axis=2)[..., None]
        me_prop = real & single[rows] & coin[rows]
        has = cand.any(axis=2) & me_prop
        ptgt = np.where(has, np.take_along_axis(tgt, slot, 2)[..., 0], -1)
        pw = np.where(has, np.take_along_axis(w, slot, 2)[..., 0],
                      np.float32(0))
        # each acceptor grants its heaviest proposal (hash tie break,
        # then the smaller proposer id)
        p_from, p_to = gid[has], ptgt[has]
        key = pw[has] + hash_unit(p_from, p_to, r + 31)
        order = np.lexsort((p_from, -key, p_to))
        p_from, p_to = p_from[order], p_to[order]
        first = np.ones(len(p_to), dtype=bool)
        first[1:] = p_to[1:] != p_to[:-1]
        mate[p_from[first]] = p_to[first]
        mate[p_to[first]] = p_from[first]
    out = np.where(real, mate[rows], -1)
    return np.where(real & (out < 0), gid, out)

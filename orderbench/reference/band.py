"""Plain NumPy definition of the band graph a level is refined on
(Chevalier & Pellegrini, PT-Scotch, 2008, §3.3).

Around a level's separator (part 2) the band holds every vertex at most
``width`` hops from it, renumbered in increasing order, with the edges
between them.  Two anchors follow, side 0 then side 1: each carries the
weight of its side's vertices outside the band and is joined to its
side's band vertices at distance exactly ``width``.  The band's start is
the level's part on its vertices and the anchors' own sides; only the
anchors are locked.  After FM, the band's parts are written back over
the level's part at the vertices they stand for.

A distributed level (``reference.dist``'s layout) is read back into its
global CSR first (``level``), so that its band is the same definition in
global ids, which the distributed band keeps in increasing order.

Written from that definition on the level's CSR; shares no code with the
program.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from orderbench.reference import dist as dref

UNREACH = 2 ** 30


def distances(xadj: np.ndarray, adjncy: np.ndarray, src: np.ndarray,
              width: int) -> np.ndarray:
    """Hops from the ``src`` vertices, up to ``width``; ``UNREACH``
    beyond."""
    n = len(xadj) - 1
    dist = np.full(n, UNREACH, dtype=np.int64)
    frontier = np.flatnonzero(src)
    dist[frontier] = 0
    for hop in range(1, width + 1):
        reach = np.concatenate([adjncy[xadj[v]:xadj[v + 1]]
                                for v in frontier] or [np.zeros(0, int)])
        reach = np.unique(reach)
        reach = reach[dist[reach] == UNREACH]
        dist[reach] = hop
        frontier = reach
    return dist


def arcs(xadj: np.ndarray, adjncy: np.ndarray) -> np.ndarray:
    """A CSR's arcs (u, v), sorted."""
    src = np.repeat(np.arange(len(xadj) - 1), np.diff(xadj))
    a = np.stack([src, np.asarray(adjncy, np.int64)], 1)
    return a[np.lexsort((a[:, 1], a[:, 0]))]


def ell_arcs(nbr: np.ndarray) -> np.ndarray:
    """An (n, d) ELL table's arcs (row, id), -1 pads left out, sorted."""
    row, col = np.nonzero(np.asarray(nbr) >= 0)
    a = np.stack([row, np.asarray(nbr)[row, col].astype(np.int64)], 1)
    return a[np.lexsort((a[:, 1], a[:, 0]))]


def gathered(vtxdist: np.ndarray, x_sh: np.ndarray) -> np.ndarray:
    """A (P, nlm) per-part vector in global order."""
    return np.concatenate([np.asarray(x_sh)[p, :vtxdist[p + 1] - vtxdist[p]]
                           for p in range(len(vtxdist) - 1)])


def level(dg) -> tuple:
    """A distributed graph's global CSR ``xadj``, ``adjncy`` and weights."""
    a = dref.to_edges(dg.vtxdist, dg.nbr_gst, dg.ghost_gid, dg.n_loc)
    n = int(dg.vtxdist[-1])
    xadj = np.concatenate([[0], np.cumsum(np.bincount(a[:, 0], minlength=n))])
    return xadj, a[:, 1], gathered(dg.vtxdist, dg.vwgt)


def extract(xadj: np.ndarray, adjncy: np.ndarray, vwgt: np.ndarray,
            part: np.ndarray, width: int) -> Dict[str, np.ndarray]:
    """The band of a level (CSR ``xadj``, ``adjncy``, weights ``vwgt``,
    parts ``part``): its ``arcs``, ``vwgt``, ``part``, ``locked`` and
    ``ids`` (the level vertex each band vertex stands for, -1 for the
    anchors)."""
    xadj, adjncy = np.asarray(xadj, np.int64), np.asarray(adjncy, np.int64)
    part, vwgt = np.asarray(part), np.asarray(vwgt, np.int64)
    dist = distances(xadj, adjncy, part == 2, width)
    keep = dist <= width
    ids = np.flatnonzero(keep)
    nb = len(ids)
    new = np.full(len(keep), -1, dtype=np.int64)
    new[ids] = np.arange(nb)
    a = arcs(xadj, adjncy)
    a = new[a[keep[a[:, 0]] & keep[a[:, 1]]]]
    for side in (0, 1):
        last = new[ids[(dist[ids] == width) & (part[ids] == side)]]
        anchor = np.full(len(last), nb + side)
        a = np.concatenate([a, np.stack([anchor, last], 1),
                            np.stack([last, anchor], 1)])
    out = ~keep
    return dict(
        arcs=a[np.lexsort((a[:, 1], a[:, 0]))],
        vwgt=np.concatenate([vwgt[ids], [vwgt[out & (part == 0)].sum(),
                                         vwgt[out & (part == 1)].sum()]]),
        part=np.concatenate([part[ids], [0, 1]]),
        locked=np.arange(nb + 2) >= nb,
        ids=np.concatenate([ids, [-1, -1]]))


def project(part: np.ndarray, band_part: np.ndarray,
            ids: np.ndarray) -> np.ndarray:
    """The level's part with the band's parts written back."""
    out = np.array(part, copy=True)
    for b, v in enumerate(ids):
        if v >= 0:
            out[v] = band_part[b]
    return out

"""Band-graph extraction around a separator (paper §3.3).

Vertices at distance ≤ ``width`` (paper's principled default: 3) from the
projected separator are kept; two *anchor* vertices per side absorb the
remainder, carrying its total vertex weight so balance is preserved, and are
connected to the last band layer of their side.

The distance sweep is device work: pipeline tasks yield a ``BFSWork`` per
uncoarsening level and ``execute_bfs_works`` runs every work sharing a
padded ELL bucket as one ``kernels.band_batch.bfs_multi`` call, the CUDA
kernel on the card.  The band itself is built on the host.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.graph import Graph
from repro_torch.kernels.band_batch import bfs_multi, bfs_multi_plain
from repro_torch.obs.instrument import _note_launch
from repro_torch.util import download, host_tensor, pow2, resolve_device, \
    upload


def bfs_distance(nbr, src_mask, width: int) -> torch.Tensor:
    """dist[v] = min(graph distance to src, width+1), by width relaxations.

    The plain oracle of one band distance, on the CPU only (the
    reference's ``core.band.bfs_distance``): ``bfs_multi_plain`` on one
    lane.  ``nbr`` (n, d) ELL ids with -1 padding, ``src_mask`` (n,)
    bool.  Vertices farther than ``width`` keep ``band_batch.UNREACH``.  Raises
    ``ValueError`` for CUDA tensors: the card's distances come from
    ``kernels.band_batch.bfs_multi``.
    """
    nbr = torch.as_tensor(nbr)
    src_mask = torch.as_tensor(src_mask)
    if nbr.is_cuda or src_mask.is_cuda:
        raise ValueError("bfs_distance is the plain oracle and runs only "
                         "on the CPU")
    return bfs_multi_plain(nbr[None], src_mask[None].int(), width)[0]


@dataclasses.dataclass
class BFSWork:
    """One band-distance request (unpadded host arrays)."""
    nbr: np.ndarray                     # (n, d) int32 ELL ids, -1 pad
    src: np.ndarray                     # (n,) bool separator mask
    width: int

    def bucket_key(self) -> Tuple[int, int, int]:
        n, d = self.nbr.shape
        return (pow2(n), pow2(max(d, 1), 8), self.width)


def bfs_parts(buf, L: int, n_pad: int, d_pad: int):
    """The parts of one bucket's staging buffer (``pack_bfs_bucket``), a
    host numpy array or its tensor on the card: nbr (L, n_pad, d_pad) and
    the source masks (L, n_pad), int32."""
    N = L * n_pad * d_pad
    return buf[:N].reshape(L, n_pad, d_pad), buf[N:].reshape(L, n_pad)


@obs.traced("bfs:pack")
def pack_bfs_bucket(works: Sequence[BFSWork], n_pad: int, d_pad: int,
                    device: torch.device) -> torch.Tensor:
    """One bucket's lanes padded to (L, n_pad, d_pad), with their source
    masks, in one host buffer (``bfs_parts``), pinned when ``device`` is
    the card."""
    L = len(works)
    buf = host_tensor(L * n_pad * (d_pad + 1), device)
    nbr_b, src_b = bfs_parts(buf.numpy(), L, n_pad, d_pad)
    nbr_b.fill(-1)
    src_b.fill(0)
    for j, w in enumerate(works):
        n, d = w.nbr.shape
        nbr_b[j, :n, :d] = w.nbr
        src_b[j, :n] = w.src
    return buf


def execute_bfs_works(works: Sequence[BFSWork],
                      device=None) -> List[np.ndarray]:
    """Run BFS works, one ``bfs_multi`` call per (n_pad, d_pad, width).

    Each bucket's upload, kernel and download is one
    ``obs.timed_dispatch`` and one launch record (``obs.instrument``);
    the ``bfs`` stage is billed from the start of the bucket's packing.
    """
    dev = resolve_device(device)
    results: List[Optional[np.ndarray]] = [None] * len(works)
    groups = defaultdict(list)
    for i, w in enumerate(works):
        groups[w.bucket_key()].append(i)
    for (n_pad, d_pad, width), idxs in groups.items():
        L = len(idxs)
        t0 = time.perf_counter()
        host = pack_bfs_bucket([works[i] for i in idxs], n_pad, d_pad, dev)

        def dispatch(host=host, L=L, n_pad=n_pad, d_pad=d_pad, width=width):
            buf = upload(host, dev)
            return download(bfs_multi(*bfs_parts(buf, L, n_pad, d_pad),
                                      width))

        dist = obs.timed_dispatch(
            "bfs", "bfs", ("bfs", dev.type), dispatch, since=t0, lanes=L,
            lanes_pad=L, bucket=(n_pad, d_pad), width=width)
        _note_launch("bfs", 0, L, L, (n_pad, d_pad), width, 0)
        for j, i in enumerate(idxs):
            results[i] = dist[j, :works[i].nbr.shape[0]]
    return results                                           # type: ignore


def band_graph_with_anchors(sub: Graph, band_part: np.ndarray,
                            band_dist: np.ndarray, width: int,
                            w_out0: int, w_out1: int
                            ) -> Tuple[Graph, np.ndarray, np.ndarray]:
    """Attach the two side anchors to an extracted band subgraph.

    ``sub`` is the induced band graph (n_band vertices), ``band_part`` /
    ``band_dist`` its per-vertex part and separator distance, and
    ``w_out0`` / ``w_out1`` the total vertex weight that fell *outside*
    the band on each side.  Appends one anchor per side carrying that
    weight, wired to the last band layer of its side (dist == width), so
    FM cannot move a last-layer vertex across without pulling the whole
    out-of-band weight into the separator (paper §3.3 balance guard).
    Returns (band, part_full, locked) with the two anchors appended
    (parts 0/1, locked).
    """
    nb = sub.n
    last = band_dist == width
    last0 = np.nonzero(last & (band_part == 0))[0]
    last1 = np.nonzero(last & (band_part == 1))[0]
    a0, a1 = nb, nb + 1
    extra = []
    if len(last0):
        extra.append(np.stack([np.full(len(last0), a0), last0], 1))
    if len(last1):
        extra.append(np.stack([np.full(len(last1), a1), last1], 1))
    src = np.repeat(np.arange(nb), sub.degrees())
    edges = np.stack([src, sub.adjncy.astype(np.int64)], 1)
    if extra:
        edges = np.concatenate([edges[edges[:, 0] < edges[:, 1]]] + extra)
    else:
        edges = edges[edges[:, 0] < edges[:, 1]]
    vwgt = np.concatenate([sub.vwgt, [max(w_out0, 0), max(w_out1, 0)]])
    ewgt = np.ones(len(edges), dtype=np.int64)
    band = Graph.from_edges(nb + 2, edges, vwgt=vwgt, ewgt=ewgt)
    band_part_full = np.concatenate([band_part, np.int8([0, 1])])
    locked = np.zeros(nb + 2, bool)
    locked[a0:] = True
    return band, band_part_full, locked


@obs.traced("band:extract")
def extract_band(g: Graph, part: np.ndarray, width: int = 3,
                 dist: Optional[np.ndarray] = None, device=None
                 ) -> Tuple[Graph, np.ndarray, np.ndarray, np.ndarray]:
    """Build the band graph around the separator.

    ``dist`` optionally supplies a precomputed distance sweep (the
    pipeline runs it as a ``BFSWork``); when absent it is computed here on
    ``device``.

    Returns (band_graph, band_part, locked, old_ids):
      * band_graph has n_band + 2 vertices; the last two are the anchors
        (side 0, side 1), weighted with the out-of-band part weights;
      * band_part / locked are the FM initial state (anchors locked);
      * old_ids maps band vertex -> original vertex (-1 for anchors).
    """
    if dist is None:
        nbr, _ = g.to_ell()
        dist = execute_bfs_works(
            [BFSWork(nbr=nbr, src=part == 2, width=width)], device)[0]
    dist = np.asarray(dist)[:g.n]
    in_band = dist <= width
    sub, old_ids = g.induced_subgraph(in_band)
    band_part = part[old_ids].astype(np.int8)

    # anchors: out-of-band weight per side, wired to the last layer
    out_mask = ~in_band
    w_out0 = int(g.vwgt[out_mask & (part == 0)].sum())
    w_out1 = int(g.vwgt[out_mask & (part == 1)].sum())
    band, band_part_full, locked = band_graph_with_anchors(
        sub, band_part, dist[old_ids], width, w_out0, w_out1)
    old_full = np.concatenate([old_ids, [-1, -1]])
    return band, band_part_full, locked, old_full


@obs.traced("band:project")
def project_band(part: np.ndarray, band_part: np.ndarray,
                 old_ids: np.ndarray) -> np.ndarray:
    """Write the refined band partition back into the full part vector."""
    out = part.copy()
    real = old_ids >= 0
    out[old_ids[real]] = band_part[real]
    return out

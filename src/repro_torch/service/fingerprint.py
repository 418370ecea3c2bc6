"""Content fingerprints for ordering requests.

The port of the reference's ``service/fingerprint.py``, over the port's
own ``Graph`` and ``NDConfig`` with the same blake2b encoding, so that a
request fingerprints to the same key in both packages.  A request is
fully determined by (CSR graph content, seed, nproc, NDConfig), so a
collision-resistant hash of exactly those bytes is a sound cache key:
two requests with equal fingerprints produce identical orderings (the
whole pipeline is deterministic given the seed).  The reference's
``dgraph_*`` fingerprints wait for the distributed slice.
"""
from __future__ import annotations

import dataclasses
import hashlib

from repro_torch.core.graph import Graph
from repro_torch.core.nd import NDConfig


def _update(h, *arrays) -> None:
    for arr in arrays:
        # dtype + shape delimiters make the encoding injective: without
        # them, two different boundary splits of the same byte stream
        # could collide and the cache would serve a wrong ordering.
        h.update(f"{arr.dtype}:{arr.shape}|".encode())
        h.update(arr.tobytes())


def graph_fingerprint(g: Graph) -> str:
    """Hash of the CSR content (structure + vertex/edge weights)."""
    h = hashlib.blake2b(digest_size=16)
    _update(h, g.xadj, g.adjncy, g.vwgt, g.adjwgt)
    return h.hexdigest()


def structural_fingerprint(g: Graph) -> str:
    """Hash of the topology only (CSR structure *modulo weights*).

    Two graphs share this fingerprint iff they have identical vertex
    numbering and adjacency but possibly different vertex/edge weights
    — the "isomorphic modulo weights" neighbours of the warm-start index
    (``cache.WarmStartIndex``): their separator splits are mutually
    valid, so one's finished ordering tree can seed the other's
    recursion.  NOT a sound key for exact results (weights change the
    ordering); exact serving always goes through ``request_fingerprint``.
    """
    h = hashlib.blake2b(digest_size=16)
    _update(h, g.xadj, g.adjncy)
    return h.hexdigest()


def request_fingerprint(g: Graph, seed: int, nproc: int,
                        cfg: NDConfig) -> str:
    """Cache key for a full ordering request."""
    h = hashlib.blake2b(digest_size=16)
    h.update(graph_fingerprint(g).encode())
    h.update(f"|seed={seed}|nproc={nproc}|".encode())
    h.update(repr(dataclasses.astuple(cfg)).encode())
    return h.hexdigest()

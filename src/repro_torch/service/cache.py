"""LRU caches of finished work: exact orderings and warm-start trees.

A copy of the reference's ``service/cache.py``: host bookkeeping, no
device work.

``FingerprintCache`` maps *exact* request fingerprints (content + seed
+ nproc + cfg) to permutations — equal keys imply identical orderings,
so a hit is the answer.  ``WarmStartIndex`` is the second, structural
index (DESIGN.md §7): it maps topology-modulo-weights fingerprints to
the *separator splits* of a completed ordering tree, so a near-hit —
same adjacency, different weights (or seed) — can seed a new recursion
from the cached splits instead of running full multilevel per node.  A
warm entry is a hint, never an answer: every split is re-validated on
the new graph and the warm result is OPC-guarded against the entry's
recorded quality (``service.api``), falling back to the exact cold
path when it degrades.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np


class FingerprintCache:
    """Bounded LRU mapping request fingerprints to permutations.

    Values are stored read-only (the same ordering may be handed to many
    requesters); hit/miss/eviction counters feed the service stats.
    """

    def __init__(self, capacity: int = 1024):
        assert capacity > 0
        self.capacity = capacity
        self._d: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: str) -> bool:
        return key in self._d

    def get(self, key: str) -> Optional[np.ndarray]:
        val = self._d.get(key)
        if val is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return val

    def put(self, key: str, perm: np.ndarray) -> None:
        # Freeze a private copy: np.asarray aliases an existing ndarray, so
        # setflags on it would freeze the *caller's* array in place.
        perm = np.array(perm, copy=True)
        # Never-cache-corrupt invariant (DESIGN.md §8): the service
        # validates before calling, but a cache serves every future
        # duplicate — re-check here so no caller can poison it.
        n = perm.shape[0] if perm.ndim == 1 else -1
        if (perm.ndim != 1 or not np.issubdtype(perm.dtype, np.integer)
                or (n and not (np.bincount(
                    perm.clip(0, max(n - 1, 0)), minlength=n) == 1).all())
                or (n and (perm.min() < 0 or perm.max() >= n))):
            raise ValueError(
                f"refusing to cache a non-permutation for {key[:16]}")
        perm.setflags(write=False)
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = perm
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


# ------------------------------------------------------------------ #
# structural warm-start index
# ------------------------------------------------------------------ #
@dataclasses.dataclass
class WarmTree:
    """Separator splits of one completed ordering tree.

    ``parts`` maps ND-tree node paths (root ``""``, children ``.0`` /
    ``.1``, components ``.c<k>``, distributed-endgame subtrees prefixed
    ``n<node>``) to the resolved part vector (0/1/2 per vertex, local
    indices) actually used at that node.  ``opc`` is the recorded
    operation count of the source ordering — OPC is a function of
    topology + permutation only, so it is directly comparable with a
    warm-started result on any same-structure graph (the fallback
    guard).  ``source_fp`` names the exact request that produced the
    tree (observability only).
    """
    parts: Dict[str, np.ndarray]
    opc: float
    n: int
    source_fp: str


class WarmStartIndex:
    """Bounded LRU: structural fingerprint → ``WarmTree``.

    Same LRU/counter discipline as ``FingerprintCache``; part vectors
    are frozen private copies (one tree may seed many requests).
    ``put`` keeps the *first* tree per structure unless ``replace`` —
    later re-records of the same topology would otherwise churn the
    entry without improving it (OPC is structure-determined to within
    seed noise).
    """

    def __init__(self, capacity: int = 256):
        assert capacity > 0
        self.capacity = capacity
        self._d: "OrderedDict[str, WarmTree]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: str) -> bool:
        return key in self._d

    def get(self, key: str) -> Optional[WarmTree]:
        tree = self._d.get(key)
        if tree is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return tree

    def put(self, key: str, parts: Dict[str, np.ndarray], opc: float,
            n: int, source_fp: str, replace: bool = False) -> None:
        if key in self._d and not replace:
            self._d.move_to_end(key)
            return
        frozen = {}
        for path, part in parts.items():
            part = np.array(part, copy=True)
            part.setflags(write=False)
            frozen[path] = part
        self._d[key] = WarmTree(frozen, float(opc), int(n), source_fp)
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

"""Centralized ordering structure (paper §2.2, one-process form).

A tree whose leaves are fragments of the *inverse permutation*: each ND
node receives a global start index in the inverse permutation array;
leaves are filled with original global indices of reordered subgraph
vertices; assembly by ascending start index yields the complete inverse
permutation.

This is the host-recursion form used by the sequential driver
(``core.nd``) and the service scheduler (``service.scheduler``), where
one process holds every fragment.  The *distributed* form of the same
§2.2 structure — per-shard fragments with prefix-sum offsets and
column-block ranges per node — is ``core.dnd.DistOrdering``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch import obs


@dataclasses.dataclass
class OrderNode:
    """One node of the ordering tree.

    ``start`` / ``size`` delimit the node's column block — the global
    index range [start, start + size) of the inverse permutation its
    subtree orders.  ``fragment`` (leaves only) holds original global
    vertex ids in elimination order.
    """
    start: int                      # global start index of this sub-ordering
    size: int
    kind: str                       # "nd" | "leaf" | "sep"
    children: List["OrderNode"] = dataclasses.field(default_factory=list)
    fragment: Optional[np.ndarray] = None   # leaf: original ids, local order


class Ordering:
    """Ordering tree under construction during an ND recursion.

    Usage contract (shared by ``core.nd`` and ``service.scheduler``):
    internal nodes are registered with their column block as soon as the
    separator fixes the child sizes; leaves attach their fragment when
    the subgraph is ordered; ``assemble`` concatenates once every index
    of [0, n) is covered.
    """

    def __init__(self, n: int):
        self.n = n
        self.root = OrderNode(0, n, "nd")
        self._frags: List[OrderNode] = []

    def add_leaf(self, parent: OrderNode, start: int, original_ids: np.ndarray,
                 kind: str = "leaf") -> OrderNode:
        """Attach a leaf covering [start, start + len(original_ids)).

        ``original_ids`` are global vertex ids in elimination order (the
        fragment content of the paper's inverse-permutation tree).
        """
        node = OrderNode(start, len(original_ids), kind, fragment=original_ids)
        parent.children.append(node)
        self._frags.append(node)
        return node

    def add_internal(self, parent: OrderNode, start: int, size: int
                     ) -> OrderNode:
        """Attach an internal ND node covering [start, start + size)."""
        node = OrderNode(start, size, "nd")
        parent.children.append(node)
        return node

    @obs.traced("nd:assemble")
    def assemble(self) -> np.ndarray:
        """Concatenate fragments by ascending start index -> perm.

        perm[k] = original vertex eliminated k-th (inverse permutation in the
        paper's sense: fragment content is original global indices).
        Asserts the fragments tile [0, n) exactly (no overlap, no gap).
        """
        perm = np.empty(self.n, dtype=np.int64)
        seen = 0
        for node in sorted(self._frags, key=lambda f: f.start):
            assert node.start == seen, (
                f"fragment at {node.start} overlaps/gaps previous end {seen}")
            perm[node.start:node.start + node.size] = node.fragment
            seen += node.size
        assert seen == self.n, f"fragments cover {seen} of {self.n}"
        return perm

    def depth(self) -> int:
        """Height of the ordering tree (root counts as 1)."""
        def d(node):
            return 1 + max((d(c) for c in node.children), default=0)
        return d(self.root)

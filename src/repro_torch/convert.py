"""The state carried across from the reference package.

The ordering has no weights; what crosses between the two packages is a
graph (host or distributed) and a PRNG key.  Each arrives as plain numpy
arrays, so a test can build its inputs once and hand the same values to
each side.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dgraph import DGraph
from repro_torch.core.graph import Graph


def graph_from_arrays(xadj, adjncy, vwgt, adjwgt) -> Graph:
    """A port ``Graph`` from the CSR arrays of a reference ``Graph``."""
    return Graph(np.asarray(xadj, np.int64).copy(),
                 np.asarray(adjncy, np.int32).copy(),
                 np.asarray(vwgt, np.int64).copy(),
                 np.asarray(adjwgt, np.int64).copy())


def dgraph_from_arrays(vtxdist, nbr_gst, ewgt_gst, ghost_gid, n_loc,
                       n_ghost, vwgt) -> DGraph:
    """A port ``DGraph`` from the seven fields of a reference ``DGraph``,
    each copied with the reference's dtype."""
    return DGraph(*(np.array(a, copy=True) for a in (
        vtxdist, nbr_gst, ewgt_gst, ghost_gid, n_loc, n_ghost, vwgt)))


def key_from_array(u32_pair, device=None) -> torch.Tensor:
    """A port PRNG key from a reference key given as ``uint32[..., 2]``."""
    arr = np.asarray(u32_pair, dtype=np.uint32)
    if arr.shape[-1:] != (2,):
        raise ValueError(f"a key has two 32-bit words, got shape {arr.shape}")
    return torch.from_numpy(arr.astype(np.int64)).to(device)

"""The state carried across from the reference package.

The ordering has no weights; what crosses between the two packages is a
graph (host or distributed) and a PRNG key.  The LM's state is its
parameter tree and, in training, its optimizer state.  Each arrives as
plain numpy arrays, so a test can build its inputs once and hand the
same values to each side.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core.dgraph import DGraph
from repro_torch.core.graph import Graph
from repro_torch.models.lm import group_descs, layer_descs
from repro_torch.optim.adamw import OptState
from repro_torch.util import resolve_device


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


def _tensor(a, device) -> torch.Tensor:
    """One leaf: bfloat16 from its raw ``uint16`` bits (or numpy's
    ``bfloat16``), any other dtype as it is."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _check_groups(cfg: ArchConfig, tree) -> None:
    """``tree``'s groups are ``cfg``'s: as many, each super-block's
    layers, each repeated group stacked on its ``count`` axis."""
    groups = group_descs(layer_descs(cfg))
    if len(tree["groups"]) != len(groups):
        raise ValueError(f"{len(tree['groups'])} groups given, {cfg.name} "
                         f"has {len(groups)}")
    for (count, block), gp in zip(groups, tree["groups"]):
        if sorted(gp) != sorted(f"p{i}" for i in range(len(block))):
            raise ValueError(f"group keys {sorted(gp)} for a super-block "
                             f"of {len(block)} layers")
        lead = np.asarray(gp["p0"]["norm1"]["scale"]).shape[:-1]
        if lead != (() if count == 1 else (count,)):
            raise ValueError(f"a group of {count} layers stacked as {lead}")


def lm_params_from_arrays(cfg: ArchConfig, tree, device=None):
    """The port's LM parameters from the reference's parameter tree given
    as numpy arrays: bfloat16 leaves as raw ``uint16`` bits (exact) or as
    float32 (a float32 model), float32 leaves as they are.  The port holds
    the reference's tree (a repeated group stacked on its ``count``
    axis); the groups are checked against ``cfg``.  On the card unless
    ``device`` names the CPU."""
    dev = resolve_device(device)
    _check_groups(cfg, tree)
    return T.map(lambda a: _tensor(a, dev), tree)


def opt_state_from_arrays(cfg: ArchConfig, master, m, v, count,
                          device=None) -> OptState:
    """The port's AdamW state from the reference's ``OptState`` given as
    numpy arrays: the float32 master weights and moments (each a tree of
    the parameters' structure, its groups checked against ``cfg``) and
    the int32 step count.  On the card unless ``device`` names the
    CPU."""
    dev = resolve_device(device)
    for t in (master, m, v):
        _check_groups(cfg, t)
    count = np.asarray(count)
    if count.shape != () or count.dtype != np.int32:
        raise ValueError(f"count is a 0-d int32, got {count.dtype} "
                         f"{count.shape}")
    return OptState(*(T.map(lambda a: _tensor(a, dev), t)
                      for t in (master, m, v)),
                    torch.from_numpy(count.copy()).to(dev))

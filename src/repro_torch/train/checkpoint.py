"""Topology-independent checkpoints with atomic manifests.

The port of the reference's ``train.checkpoint``, in the same file
format, so a checkpoint written by one package restores in the other:
``ckpt_XXXXXXXX.npz`` holds ``leaf_i`` entries in the reference's leaf
order (``repro_torch.tree``), bfloat16 stored as a ``uint16`` view
tagged ``"bfloat16"``; ``manifest.json`` records the step, the leaf
count, the structure, the file, the dtype tags and ``extra``.  Writes
are atomic (a temporary file, then a rename), so a preempted run never
leaves a corrupt latest checkpoint.

A restore loads onto the card unless the caller names the CPU.  A save
writes one leaf at a time.  Over a mesh a tree of DTensors is saved
whole: every card gathers each leaf in turn (``full_tensor``), the card
at the mesh's origin alone writes it, and a barrier follows.  ``restore``'s ``shardings`` places each leaf on a mesh
(``distribute_tensor``), the reference's elastic re-shard: a checkpoint
written under one mesh restores onto any other, or onto one card.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Placement, distribute_tensor

from repro_torch import tree
from repro_torch.models.sharding import NamedSharding, mesh_of
from repro_torch.util import resolve_device

PyTree = Any


def _np_safe(x) -> Tuple[np.ndarray, str]:
    """A leaf as numpy on the host: bfloat16 as its ``uint16`` bits and
    the tag ``"bfloat16"``, any other dtype as it is with its name."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy().view(np.uint16), \
                "bfloat16"
        x = x.cpu().numpy()
    x = np.asarray(x)
    return x, x.dtype.name


def save(path: str, step: int, tree_: PyTree, extra: Optional[dict] = None
         ) -> str:
    """Write ``tree_`` as the checkpoint of ``step`` under ``path`` and
    return the file's name.  Leaves are written one at a time, so at most
    one whole leaf sits on the card or the host.  DTensor leaves are
    gathered whole on every card, one after another (a collective: every
    card calls ``save``), written by the card at the mesh's origin and
    dropped by the others; the cards meet at a barrier after."""
    leaves = tree.leaves(tree_)
    mesh = mesh_of(*leaves)
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    if mesh is None:
        return _write(path, step, tree_, leaves, extra, fname)
    whole = (x.full_tensor() if isinstance(x, DTensor) else x
             for x in leaves)
    if all(mesh.get_local_rank(i) == 0 for i in range(mesh.ndim)):
        _write(path, step, tree_, whole, extra, fname)
    else:
        for _ in whole:
            pass
    dist.barrier()
    return fname


def _write(path, step, tree_, leaves, extra, fname) -> str:
    """The checkpoint file (``np.savez``'s layout: a stored zip of
    ``leaf_i.npy``), each of ``leaves`` (an iterable) moved to the host
    and written before the next is taken, then the manifest."""
    os.makedirs(path, exist_ok=True)
    dtypes = []
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp.npz")
    os.close(fd)
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, x in enumerate(leaves):
            arr, tag = _np_safe(x)
            del x
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
            dtypes.append(tag)
            del arr
    os.replace(tmp, fname)
    manifest = {
        "step": step,
        "n_leaves": len(dtypes),
        "treedef": tree.structure(tree_),
        "file": os.path.basename(fname),
        "dtypes": dtypes,
        "extra": extra or {},
    }
    mtmp = fname + ".manifest.tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(path, "manifest.json"))
    return fname


def latest_step(path: str) -> Optional[int]:
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        return None
    with open(mf) as f:
        return json.load(f)["step"]


def _leaf(arr: np.ndarray, tag, like, device) -> torch.Tensor:
    """One stored leaf as a tensor of ``like``'s dtype on ``device``
    (bfloat16 read through ``int16``: no ``ml_dtypes``)."""
    if tag == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if isinstance(like, torch.Tensor):
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"a leaf of shape {tuple(t.shape)} for one of "
                             f"{tuple(like.shape)}")
        t = t.to(like.dtype)
    return t.to(device)


def restore(path: str, tree_like: PyTree, device=None,
            shardings: Optional[PyTree] = None, mesh=None
            ) -> Tuple[int, PyTree]:
    """(step, tree): the latest checkpoint under ``path`` in the
    structure of ``tree_like`` (shapes must match), on the card unless
    ``device`` names the CPU.

    ``shardings``, a tree of ``tree_like``'s structure, places each leaf
    on a mesh (the reference's elastic re-shard): a ``NamedSharding``, or
    a tuple of DTensor placements on ``mesh``; the leaf becomes a DTensor
    of those placements on the mesh's devices, each card keeping its own
    shard of what it read (every card reads the file).  A ``None`` entry
    keeps its leaf plain on ``device``."""
    with open(os.path.join(path, "manifest.json")) as f:
        mf = json.load(f)
    like = tree.leaves(tree_like)
    if len(like) != mf["n_leaves"]:
        raise ValueError(f"checkpoint has {mf['n_leaves']} leaves, model "
                         f"has {len(like)}")
    where = [None] * len(like) if shardings is None else \
        sharding_leaves(tree_like, shardings, mesh)
    dtypes = mf.get("dtypes", [])
    new = []
    with np.load(os.path.join(path, mf["file"])) as data:
        for i, (x, sh) in enumerate(zip(like, where)):
            tag = dtypes[i] if i < len(dtypes) else None
            if sh is None:
                new.append(_leaf(data[f"leaf_{i}"], tag, x,
                                 resolve_device(device)))
                continue
            t = _leaf(data[f"leaf_{i}"], tag, x, "cpu")
            new.append(distribute_tensor(
                t.to(sh.mesh.device_type), sh.mesh, tuple(sh.placements),
                src_data_rank=None))
    return mf["step"], tree.unflatten(tree_like, new)


def _is_placements(s) -> bool:
    return isinstance(s, tuple) and bool(s) and \
        all(isinstance(p, Placement) for p in s)


def sharding_leaves(tree_like: PyTree, shardings: PyTree, mesh=None
                    ) -> list:
    """The entry of ``shardings`` (a tree of ``tree_like``'s structure)
    at each leaf of ``tree_like``, in ``tree.leaves``' order: a
    ``NamedSharding`` (placements given as a tuple are taken on
    ``mesh``) or None."""
    out = []

    def walk(t, s):
        if s is None or isinstance(s, NamedSharding) or _is_placements(s):
            if tree.is_node(t):
                raise ValueError("a sharding where the tree has a node")
            if _is_placements(s):
                if mesh is None:
                    raise ValueError("placements without a mesh")
                s = NamedSharding(mesh, s)
            out.append(s)
        elif isinstance(t, dict):
            if set(t) != set(s):
                raise ValueError("shardings do not match the tree's keys")
            for k in sorted(t):
                walk(t[k], s[k])
        elif tree.is_node(t) and len(t) == len(s):
            for a, b in zip(t, s):
                walk(a, b)
        else:
            raise ValueError("shardings do not match the tree's structure")
    walk(tree_like, shardings)
    return out

"""Topology-independent checkpoints with atomic manifests.

The port of the reference's ``train.checkpoint``, in the same file
format, so a checkpoint written by one package restores in the other:
``ckpt_XXXXXXXX.npz`` holds ``leaf_i`` entries in the reference's leaf
order (``repro_torch.tree``), bfloat16 stored as a ``uint16`` view
tagged ``"bfloat16"``; ``manifest.json`` records the step, the leaf
count, the structure, the file, the dtype tags and ``extra``.  Writes
are atomic (a temporary file, then a rename), so a preempted run never
leaves a corrupt latest checkpoint.

A restore loads onto the card unless the caller names the CPU.  The
reference's ``shardings`` (a re-shard onto a new mesh) has no meaning on
one card and is refused.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
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
    os.makedirs(path, exist_ok=True)
    leaves = tree.leaves(tree_)
    arrays, dtypes = {}, []
    for i, x in enumerate(leaves):
        arr, tag = _np_safe(x)
        arrays[f"leaf_{i}"] = arr
        dtypes.append(tag)
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp.npz")
    os.close(fd)
    np.savez(tmp[:-4], **arrays)        # np.savez appends .npz
    os.replace(tmp, fname)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
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
            shardings: Optional[PyTree] = None) -> Tuple[int, PyTree]:
    """(step, tree): the latest checkpoint under ``path`` in the
    structure of ``tree_like`` (shapes must match), on the card unless
    ``device`` names the CPU."""
    if shardings is not None:
        raise NotImplementedError(
            "the port trains on one card: restore takes no shardings")
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        mf = json.load(f)
    like = tree.leaves(tree_like)
    if len(like) != mf["n_leaves"]:
        raise ValueError(f"checkpoint has {mf['n_leaves']} leaves, model "
                         f"has {len(like)}")
    dtypes = mf.get("dtypes", [])
    with np.load(os.path.join(path, mf["file"])) as data:
        new = [_leaf(data[f"leaf_{i}"], dtypes[i] if i < len(dtypes)
                     else None, x, dev) for i, x in enumerate(like)]
    return mf["step"], tree.unflatten(tree_like, new)

"""Fake-tensor input stand-ins for every (arch × shape) dry-run cell.

The port of the reference's ``launch.specs``, whose ``jax.eval_shape``
stand-ins become fake tensors (``torch._subclasses.fake_tensor``): the
real init functions (``lm.init_params``, ``adamw.init``,
``lm.init_caches``) run under a ``FakeTensorMode`` and give tensors with
the reference's shapes and dtypes, on the device asked for, that hold no
memory.  All the stand-ins of one cell must come from one mode.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree
from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.models import lm
from repro_torch.optim import adamw

PyTree = Any


def shape_of(shape) -> dict:
    """A cell's shape: a name of ``SHAPES`` or such a dict itself
    (``kind``, ``seq_len``, ``global_batch``)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def _mode(mode: Optional[FakeTensorMode]) -> FakeTensorMode:
    return mode if mode is not None else FakeTensorMode()


def batch_specs_for(cfg: ArchConfig, shape_name, mode=None,
                    device="cuda") -> Dict[str, torch.Tensor]:
    sh = shape_of(shape_name)
    B, S = sh["global_batch"], sh["seq_len"]
    kind = sh["kind"]
    with _mode(mode):
        def sds(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=device)
        if kind == "decode":
            batch = {"tokens": sds((B, 1), torch.int32)}
        else:
            batch = {"tokens": sds((B, S), torch.int32)}
            if kind == "train":
                batch["labels"] = sds((B, S), torch.int32)
        if cfg.enc_dec and kind != "decode":
            batch["frames"] = sds((B, cfg.enc_len, cfg.d_model),
                                  torch.bfloat16)
        if cfg.frontend == "patches" and kind != "decode":
            batch["patches"] = sds((B, cfg.n_patches, cfg.d_model),
                                   torch.bfloat16)
    return batch


def param_structs(cfg: ArchConfig, mode=None, device="cuda") -> PyTree:
    with _mode(mode):
        return lm.init_params(lm.generator(0, device), cfg)


def opt_structs(params: PyTree, mode=None) -> PyTree:
    """AdamW's state of ``params`` under their own fake mode."""
    if mode is None:
        mode = getattr(tree.leaves(params)[0], "fake_mode", None)
    with _mode(mode):
        return adamw.init(params)


def cache_structs(cfg: ArchConfig, B: int, S_max: int, mode=None,
                  device="cuda") -> PyTree:
    with _mode(mode):
        return lm.init_caches(cfg, B, S_max, device=device)


def input_specs(cfg: ArchConfig, shape_name, mode=None,
                device="cuda") -> Dict[str, PyTree]:
    """Everything the step function of this cell consumes.  ``pos``, the
    decode position, is a Python int (the port's ``decode_step`` writes
    the caches in place there): the last position of the cache."""
    sh = shape_of(shape_name)
    mode = _mode(mode)
    out: Dict[str, PyTree] = {
        "params": param_structs(cfg, mode, device),
        "batch": batch_specs_for(cfg, sh, mode, device),
    }
    if sh["kind"] == "train":
        out["opt"] = opt_structs(out["params"], mode)
    if sh["kind"] == "decode":
        out["caches"] = cache_structs(cfg, sh["global_batch"],
                                      sh["seq_len"], mode, device)
        out["pos"] = sh["seq_len"] - 1
    return out

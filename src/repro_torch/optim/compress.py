"""Gradient compression for the slow all-reduce axis.

The port of the reference's ``optim.compress``: int8 quantization with
error feedback (the residual of each step's rounding is carried into the
next), so that only int8 crosses the slow hop, its bias corrected over
steps.  Rounding is half to even on both sides (``torch.round`` as
``jnp.round``).

The reference's ``compressed_psum`` reduces over a mesh axis inside
``shard_map``.  On one card that axis is a leading tensor dim:
``compressed_psum(x_stacked)`` takes every member's tensor stacked on
dim 0 and returns what each member of the axis receives.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree

PyTree = Any


def _scale_of(x: torch.Tensor) -> torch.Tensor:
    """max(|x|, 1e-8) / 127 as a float32 tensor on ``x``'s device."""
    top = torch.clamp(torch.max(torch.abs(x)), min=1e-8)
    return top / torch.tensor(127.0, dtype=torch.float32, device=x.device)


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to [-127, 127] (float32)."""
    return torch.clamp(torch.round(x / scale), -127, 127)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = _scale_of(x)
    return _codes(x, scale).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(grads: PyTree, residual: PyTree
                ) -> Tuple[PyTree, PyTree, PyTree]:
    """Error-feedback compress: returns (q, scales, new_residual)."""
    def one(g, r):
        g32 = g.float() + r
        q, s = quantize_int8(g32)
        return q, s, g32 - dequantize_int8(q, s)
    out = [one(g, r) for g, r in zip(tree.leaves(grads),
                                     tree.leaves(residual))]
    return tuple(tree.unflatten(grads, [o[i] for o in out])
                 for i in range(3))


def ef_init(grads_like: PyTree) -> PyTree:
    return tree.map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compressed_psum(x_stacked: torch.Tensor) -> torch.Tensor:
    """int8-on-the-wire sum over the axis stacked on dim 0: each member
    quantizes against the largest member's scale (the shared-scale
    variant), the integer codes are summed in int32 and rescaled.
    Returns the sum every member receives, of a member's shape."""
    x = x_stacked.float()
    s_max = torch.stack([_scale_of(xi) for xi in x]).max()
    total = _codes(x, s_max).to(torch.int32).sum(0, dtype=torch.int32)
    return total.float() * s_max

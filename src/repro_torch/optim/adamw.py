"""AdamW with float32 master weights.

The port of the reference's ``optim.adamw``.  Parameters live in their
own dtype (bfloat16 for the LM); the optimizer holds float32 master
weights and first and second moments, in trees of the parameters'
structure, and a step count.  The update is written out by hand in the
reference's order of operations (clip by the global norm, warm-up, bias
correction, then ``p - lr * ((m/b1c)/(sqrt(v/b2c)+eps) + wd*p)`` on the
master), not ``torch.optim.AdamW``, which decays in another order.  On
one card there is no ZeRO-1 partition: the state lives on the
parameters' device.

Scalars are float32 tensors on the parameters' device, as the
reference's are: a Python double (``0.9 ** count``) would move the bias
correction by an ulp, and a Python number divided into a CUDA tensor is
a multiply by its reciprocal.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree

PyTree = Any


class OptState(NamedTuple):
    master: PyTree       # float32 copy of params
    m: PyTree            # float32
    v: PyTree            # float32
    count: torch.Tensor  # () int32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100


def init(params: PyTree) -> OptState:
    """Master weights (float32 copies), zero moments, count 0, on the
    parameters' device."""
    leaves = tree.leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return OptState(
        master=tree.map(lambda x: x.detach().float().clone(), params),
        m=tree.map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device), params),
        v=tree.map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device), params),
        count=torch.zeros((), dtype=torch.int32, device=dev))


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr`` over ``cfg.warmup`` steps (float32)."""
    dev = step.device
    warm = torch.minimum(step.float() / _f32(max(cfg.warmup, 1), dev),
                         _f32(1.0, dev))
    return _f32(cfg.lr, dev) * warm


def global_norm(grads: PyTree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in order, of each leaf's sum of
    squares in float32."""
    total = None
    for x in tree.leaves(grads):
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def update(grads: PyTree, state: OptState, params: PyTree,
           cfg: AdamWConfig) -> Tuple[PyTree, OptState, torch.Tensor]:
    """Returns (new params [original dtypes], new state, grad_norm)."""
    gnorm = global_norm(grads)
    dev = gnorm.device
    one = _f32(1.0, dev)
    scale = torch.minimum(one, _f32(cfg.clip_norm, dev) / (gnorm + 1e-9))
    count = state.count + 1
    lr = _schedule(cfg, count)
    cf = count.float()
    b1c = one - torch.pow(_f32(cfg.b1, dev), cf)
    b2c = one - torch.pow(_f32(cfg.b2, dev), cf)
    gs = tree.map(lambda g: g.float() * scale, grads)
    m = tree.map(lambda m_, g: cfg.b1 * m_ + (1 - cfg.b1) * g, state.m, gs)
    v = tree.map(lambda v_, g: cfg.b2 * v_ + (1 - cfg.b2) * g * g,
                 state.v, gs)
    master = tree.map(
        lambda p, m_, v_: p - lr * ((m_ / b1c) / (torch.sqrt(v_ / b2c)
                                                  + cfg.eps)
                                    + cfg.weight_decay * p),
        state.master, m, v)
    new_params = tree.map(lambda mp, old: mp.to(old.dtype), master, params)
    return new_params, OptState(master, m, v, count), gnorm

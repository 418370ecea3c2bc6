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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import tree
from repro_torch.models import sharding as shd

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
    squares in float32.  Over DTensors (placed without ``Partial``) each
    card sums its own shard of each leaf, the sums of the leaves it holds
    a copy of only on the first card of that copy, and one reduction
    over the mesh adds them up (``Partial`` reduced once): the result is
    the same plain 0-d tensor on every card."""
    leaves = tree.leaves(grads)
    mesh = shd.mesh_of(*leaves)
    sums = []
    for x in leaves:
        if mesh is None:
            sums.append(torch.sum(torch.square(x.float())))
            continue
        x, pl = _local(x, mesh)
        s = torch.sum(torch.square(x.float()))
        first = all(mesh.get_local_rank(i) == 0
                    for i, p in enumerate(pl) if not isinstance(p, Shard))
        sums.append(s if first else torch.zeros_like(s))
    if mesh is not None:
        sums = _summed(torch.stack(sums), mesh).unbind()
    total = None
    for s in sums:
        total = s if total is None else total + s
    return torch.sqrt(total)


def _local(x, mesh) -> Tuple[torch.Tensor, tuple]:
    """A leaf's local shard and its placements (a plain tensor is
    replicated)."""
    if isinstance(x, DTensor):
        if any(p.is_partial() for p in x.placements):
            raise ValueError("a Partial leaf: reduce it first")
        return x.to_local(), tuple(x.placements)
    return x, shd.replicated(mesh)


def _summed(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t``, a part on each card, summed over every card of ``mesh`` (an
    all-reduce a mesh dim)."""
    pl = [Partial()] * mesh.ndim
    d = shd.from_local(t, mesh, tuple(pl))
    for i in range(mesh.ndim):
        pl[i] = Replicate()
        d = d.redistribute(mesh, tuple(pl))
    return d.to_local()


def update(grads: PyTree, state: OptState, params: PyTree,
           cfg: AdamWConfig) -> Tuple[PyTree, OptState, torch.Tensor]:
    """Returns (new params [original dtypes], new state, grad_norm).

    Over DTensors each gradient is first placed as its master (its
    pending sums reduced, then the card's ZeRO-1 part taken), the update
    runs on each card's shards, and each new parameter is gathered back
    to its own placements; ``count`` keeps its own."""
    mesh = shd.mesh_of(*tree.leaves(params))
    if mesh is not None:
        grads = tree.map(lambda g, p, mp: _placed(_placed(g, p), mp),
                         grads, params, state.master)
    gnorm = global_norm(grads)
    dev = gnorm.device
    one = _f32(1.0, dev)
    scale = torch.minimum(one, _f32(cfg.clip_norm, dev) / (gnorm + 1e-9))
    count = _plain(state.count) + 1
    lr = _schedule(cfg, count)
    cf = count.float()
    b1c = one - torch.pow(_f32(cfg.b1, dev), cf)
    b2c = one - torch.pow(_f32(cfg.b2, dev), cf)
    gs = tree.map(lambda g: _plain(g).float() * scale, grads)
    m = tree.map(lambda m_, g: cfg.b1 * _plain(m_) + (1 - cfg.b1) * g,
                 state.m, gs)
    v = tree.map(lambda v_, g: cfg.b2 * _plain(v_) + (1 - cfg.b2) * g * g,
                 state.v, gs)
    master = tree.map(
        lambda p, m_, v_: _plain(p) - lr * ((m_ / b1c) / (torch.sqrt(v_ / b2c)
                                                          + cfg.eps)
                                            + cfg.weight_decay * _plain(p)),
        state.master, m, v)
    new_params = tree.map(lambda mp, old: mp.to(old.dtype), master, params)
    if mesh is not None:
        master, m, v, new_params = (tree.map(_as, x, state.master)
                                    for x in (master, m, v, new_params))
        new_params = tree.map(_placed, new_params, params)
        count = _as(count, state.count)
    return new_params, OptState(master, m, v, count), gnorm


def _plain(x) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _as(t: torch.Tensor, ref):
    """Local ``t`` as a DTensor placed as ``ref`` (plain if ``ref`` is)."""
    if not isinstance(ref, DTensor):
        return t
    return shd.from_local(t, ref.device_mesh, tuple(ref.placements))


def _placed(x, ref):
    """DTensor ``x`` redistributed to ``ref``'s placements, where they
    differ."""
    if not isinstance(x, DTensor) or not isinstance(ref, DTensor) or \
            tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, tuple(ref.placements))

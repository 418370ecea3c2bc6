"""Loss and train step.

The port of the reference's ``train.step``: cross-entropy by a float32
``logsumexp`` over the labels ``>= 0``, the MoE's aux loss and a z-loss;
gradients by ``torch.autograd.grad`` over the parameter tree's leaves,
then the AdamW update without grad.  On one card the batch is not
sharded, so there is no cross-replica reduction.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import forward
from repro_torch.models.sharding import NO_SHARD, ShardCfg
from repro_torch.optim import adamw

PyTree = Any


def loss_fn(params, cfg: ArchConfig, batch: Dict[str, Any],
            shard: ShardCfg = NO_SHARD, aux_weight: float = 0.01,
            z_weight: float = 1e-4) -> Tuple[torch.Tensor, Dict]:
    """(total loss, {"xent", "aux", "zloss"}), each a 0-d float32 tensor.
    ``batch["labels"]`` (B, S) int: positions with a negative label are
    masked out."""
    logits, aux = forward(params, cfg, batch, shard)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    # a masked label reads any column: its term is multiplied by 0
    gold = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    xent = torch.sum((lse - gold) * mask) / denom
    zloss = torch.sum(torch.square(lse) * mask) / denom
    total = xent + aux_weight * aux + z_weight * zloss
    return total, {"xent": xent, "aux": aux, "zloss": zloss}


def value_and_grad(params, cfg: ArchConfig, batch: Dict[str, Any],
                   shard: ShardCfg = NO_SHARD):
    """((loss, metrics), grads): ``loss_fn`` and its gradient with
    respect to every leaf of ``params`` (a tree of ``params``' structure
    and dtypes), all detached."""
    leaves = [x.detach().requires_grad_() for x in tree.leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree.unflatten(params, leaves), cfg, batch,
                                shard)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree.unflatten(params, grads))


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    shard: ShardCfg = NO_SHARD):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics), the metrics (``loss``, ``xent``, ``aux``, ``zloss``,
    ``grad_norm``) 0-d tensors on the parameters' device."""
    def train_step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(params, cfg, batch, shard)
        with torch.no_grad():
            new_params, new_opt, gnorm = adamw.update(grads, opt_state,
                                                      params, opt_cfg)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return new_params, new_opt, metrics

    return train_step

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
from repro_torch.models import sharding as shd
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
    lse, gold = _lse_gold(logits.float(), labels)
    mask = (labels >= 0).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    xent = torch.sum((lse - gold) * mask) / denom
    zloss = torch.sum(torch.square(lse) * mask) / denom
    total = xent + aux_weight * aux + z_weight * zloss
    return total, {"xent": xent, "aux": aux, "zloss": zloss}


def _lse_gold(lf: torch.Tensor, labels: torch.Tensor):
    """The float32 logits' ``logsumexp`` over the vocab and each label's
    logit (a masked label reads any column: its term is multiplied by 0).

    Over DTensors the vocab stays split on the model axis where it
    divides (a vocab-parallel cross-entropy): each card takes the max
    and the sum of ``exp`` over its own columns, reduced over that axis
    (all-reduces of (B, S)), and the label's logit from the card that
    holds its column, summed."""
    mesh = shd.mesh_of(lf)
    if mesh is None:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1,
                            labels.clamp(min=0).long()[..., None])[..., 0]
        return lse, gold
    bpl = shd.batch_heads(mesh, lf.shape[0], None)
    if not shd.vocab_split(mesh, lf.shape[-1]):
        return shd.local_map(_lse_gold, mesh, (lf, labels), (bpl, bpl),
                             (bpl, bpl))
    lpl = shd.batch_heads(mesh, lf.shape[0], 2)
    lfl = shd.to_local(lf, mesh, lpl)
    lab = shd.to_local(labels, mesh, bpl)
    V = lfl.shape[-1]

    def across(t, op):                  # reduce (B, S) over the model axis
        pl = shd.model_sum(mesh, bpl, op)
        return shd.to_local(shd.from_local(t, mesh, pl), mesh, bpl)
    m = across(lfl.detach().amax(-1), "max")
    lse = m + torch.log(across(torch.exp(lfl - m[..., None]).sum(-1),
                               "sum"))
    i = lab.clamp(min=0).long() - mesh.get_local_rank(shd.TP_AXIS) * V
    inside = (i >= 0) & (i < V)
    gold = torch.gather(lfl, -1, i.clamp(0, V - 1)[..., None])[..., 0]
    gold = across(gold * inside.to(gold.dtype), "sum")
    return shd.from_local(lse, mesh, bpl), shd.from_local(gold, mesh, bpl)


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

"""Loss and train step.

The port of the reference's ``train.step``: cross-entropy by a float32
``logsumexp`` over the labels ``>= 0``, the MoE's aux loss and a z-loss;
gradients by ``torch.autograd.grad`` over the parameter tree's leaves,
then the AdamW update without grad.

Over a mesh (a ``ShardCfg`` with one) the parameters and the optimizer
state are DTensors; the step places a plain batch by
``sharding.batch_specs`` (``place_batch``: each card takes its rows of
the global batch, which every card holds, or wraps the rows it was
given), runs the model with the plain tensors it makes
(RoPE tables, masks) taken as replicated, and returns each metric as
the replicated value, a plain 0-d tensor equal on every card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

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
    with torch.enable_grad(), shd.replicating(shard):
        loss, metrics = loss_fn(tree.unflatten(params, leaves), cfg, batch,
                                shard)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree.unflatten(params, grads))


def _batch_placements(shape, shard: ShardCfg) -> tuple:
    """The placements of a batch leaf of global ``shape`` over
    ``shard.mesh`` (``sharding.batch_specs``, split only where even)."""
    spec = shd.batch_specs(torch.empty(shape, device="meta"), shard)
    return shd.even(shd.placements(spec, shard.mesh), shape, shard.mesh)


def batch_rows(rows: int, shard: ShardCfg) -> Tuple[int, int]:
    """(blocks, block): the row blocks that ``batch_specs`` cuts a global
    batch of ``rows`` rows into (the data axes' size where it divides
    ``rows``, else 1) and the one this rank holds, its data coordinate
    (0 where the batch stays whole).  Ranks on one data coordinate hold
    the same rows; without a mesh, (1, 0)."""
    if shard.mesh is None or not any(
            isinstance(p, Shard) for p in _batch_placements((rows,), shard)):
        return 1, 0
    mesh, block = shard.mesh, 0
    for a in shard.dp:
        i = mesh.mesh_dim_names.index(a)
        block = block * mesh.shape[i] + mesh.get_local_rank(i)
    return shard.dp_size, block


def place_batch(batch: Dict[str, Any], shard: ShardCfg,
                rows: Optional[int] = None) -> Dict[str, Any]:
    """``batch`` placed by ``sharding.batch_specs`` over ``shard.mesh``,
    with no communication; a DTensor leaf is kept, and without a mesh the
    batch is returned as it is.  Each plain leaf is the global batch,
    alike on every card, of which each card keeps its rows; or, given the
    global batch's ``rows``, this rank's block of them already (the
    ``batch_rows`` block), which becomes its shard."""
    if shard.mesh is None:
        return batch
    mesh = shard.mesh

    def one(x):
        if isinstance(x, DTensor):
            return x
        x = torch.as_tensor(x).to(mesh.device_type)
        if rows is None:
            return distribute_tensor(x, mesh, _batch_placements(x.shape,
                                                                 shard),
                                     src_data_rank=None)
        return shd.from_local(x, mesh, _batch_placements(
            (rows, *x.shape[1:]), shard))
    return tree.map(one, batch)


def replicated_value(x) -> torch.Tensor:
    """A metric as a plain tensor: a DTensor's whole value (its pending
    sums reduced, a collective every card takes part in)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    shard: ShardCfg = NO_SHARD):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics), the metrics (``loss``, ``xent``, ``aux``, ``zloss``,
    ``grad_norm``) 0-d tensors on the parameters' device (over a mesh,
    plain and equal on every card)."""
    def train_step(params, opt_state, batch):
        batch = place_batch(batch, shard)
        (loss, metrics), grads = value_and_grad(params, cfg, batch, shard)
        with torch.no_grad():
            new_params, new_opt, gnorm = adamw.update(grads, opt_state,
                                                      params, opt_cfg)
        metrics = {k: replicated_value(v)
                   for k, v in dict(metrics, loss=loss,
                                    grad_norm=gnorm).items()}
        return new_params, new_opt, metrics

    return train_step

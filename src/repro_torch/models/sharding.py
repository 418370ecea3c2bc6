"""Sharding rules: parameter specs, activation constraints, batch specs.

The port of the reference's ``models.sharding`` over a
``torch.distributed.device_mesh.DeviceMesh``.  Mesh axes: ``("data",
"model")`` per pod, ``("pod", "data", "model")`` multi-pod.
  * TP ("model"): attention heads, FFN hidden, vocab, experts (EP).
  * DP ("pod", "data"): batch; ZeRO-1 shards optimizer state further.
  * SP: the residual stream is sequence-sharded on "model" between blocks
    (Megatron-SP style).
Rules degrade gracefully: any dim not divisible by its axis size falls back
to replication (so reduced smoke configs run on 1 device with no mesh).

A spec is the reference's ``PartitionSpec`` form, one entry a tensor dim:
``None``, one axis name, or a tuple of axis names (``P``, a tuple that
the port's ``tree`` walks as a leaf).  ``placements`` turns it into
DTensor placements over the mesh; ``constrain`` and the activation hooks
``redistribute`` a DTensor to them (where the reference calls
``with_sharding_constraint``) and return a plain tensor untouched, so
``NO_SHARD`` and every unsharded path run exactly the plain code.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import tree

PyTree = Any


class P(tuple):
    """A partition spec: one entry a tensor dim, ``None`` (replicated),
    an axis name or a tuple of axis names (split over them, major to
    minor).  A one-name tuple is stored as the name, as the reference's
    ``PartitionSpec`` stores it."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    """A mesh and the DTensor placements of one spec over it."""
    mesh: Any
    placements: Tuple[Any, ...]


def placements(spec: P, mesh) -> Tuple[Any, ...]:
    """The DTensor placements of ``spec`` over ``mesh``: ``Shard(d)`` on
    every mesh dim that names tensor dim ``d``, ``Replicate()`` on the
    others.  A dim split over several axes must name them in the mesh's
    order (major to minor, as JAX splits it)."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r} splits dim {d} over {axes}, "
                             f"not in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec!r} names axis {names[i]!r} "
                                 "twice")
            out[i] = Shard(d)
    return tuple(out)


def even(pl: tuple, shape, mesh) -> tuple:
    """``pl`` with each ``Shard`` of a dim that its mesh dims do not split
    evenly made ``Replicate`` (the rules' graceful fallback, where XLA
    would pad)."""
    split = {}
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            split[p.dim] = split.get(p.dim, 1) * mesh.shape[i]
    return tuple(Replicate() if isinstance(p, Shard)
                 and shape[p.dim] % split[p.dim] else p for p in pl)


def with_sharding_constraint(x, named: NamedSharding):
    """``x`` redistributed to ``named``'s placements (where its dims split
    evenly) if it is a DTensor; a plain tensor is returned untouched."""
    if not isinstance(x, DTensor):
        return x
    pl = even(named.placements, x.shape, named.mesh)
    return x if tuple(x.placements) == pl else x.redistribute(named.mesh, pl)


def replicate_dims(x, dims: Tuple[int, ...]):
    """``x`` with no mesh dim sharding any of tensor dims ``dims`` (an
    all-gather over those mesh dims), for a view that cannot split a
    sharded dim (a head reshape whose heads do not divide the axis).  A
    plain tensor is returned untouched."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p
               for p in x.placements)
    if pl == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def heads_ready(x, n_heads: int):
    """``x`` (..., n_heads * hd) ready to be viewed as (..., n_heads, hd):
    a DTensor whose last dim is split over mesh dims that do not divide
    ``n_heads`` is gathered on that dim (a view cannot split a head).  A
    plain tensor, or one split by whole heads, is returned untouched."""
    if not isinstance(x, DTensor):
        return x
    d = x.ndim - 1
    split = math.prod(x.device_mesh.shape[i]
                      for i, p in enumerate(x.placements)
                      if isinstance(p, Shard) and p.dim == d)
    return x if n_heads % split == 0 else replicate_dims(x, (d,))


class _HeadsGrad(torch.autograd.Function):
    """Identity whose backward applies ``heads_ready`` to the gradient."""

    @staticmethod
    def forward(ctx, x, n_heads):
        ctx.n_heads = n_heads
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return heads_ready(g, ctx.n_heads), None


class _PinGrad(torch.autograd.Function):
    """Identity whose backward redistributes the gradient to the forward
    value's placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.pl = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.pl:
            g = g.redistribute(g.device_mesh, ctx.pl)
        return g


def pinned(x):
    """``x`` itself, its gradient brought back to ``x``'s placements (a
    reduction's backward may hand it over split on the sequence, which a
    product's backward cannot view).  A plain tensor is returned
    untouched."""
    if not isinstance(x, DTensor):
        return x
    return _PinGrad.apply(x)


def heads_merged(x, n_heads: int):
    """``x`` (..., n_heads * hd), just merged from heads: itself, its
    gradient made ready to be viewed as heads again (a product's gradient
    may come back split where the heads do not divide).  A plain tensor
    is returned untouched."""
    if not isinstance(x, DTensor):
        return x
    return _HeadsGrad.apply(x, n_heads)


def reduce_partial(x):
    """``x`` with its pending partial sums reduced (each ``Partial``
    placement made ``Replicate``), before a view that would lose track of
    them (a vocab-parallel gather's mask).  A plain tensor is returned
    untouched."""
    if not isinstance(x, DTensor) or \
            not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[tuple(mesh.mesh_dim_names).index(name)]


#: the mesh's axis names by role, as ``launch.mesh`` names them
DP_AXES, TP_AXIS = ("pod", "data"), "model"


def mesh_of(*xs):
    """The device mesh of the first DTensor among ``xs`` (None if none)."""
    for x in xs:
        if isinstance(x, DTensor):
            return x.device_mesh
    return None


def batch_heads(mesh, batch: int, heads_dim: Optional[int]) -> tuple:
    """Placements with dim 0 (the batch) on the data axes where it
    divides, ``heads_dim`` (if any) on the model axis, the rest whole."""
    names = tuple(mesh.mesh_dim_names)
    dp = [i for i, a in enumerate(names) if a in DP_AXES]
    out = [Replicate()] * len(names)
    if dp and batch % math.prod(mesh.shape[i] for i in dp) == 0:
        for i in dp:
            out[i] = Shard(0)
    if heads_dim is not None:
        out[names.index(TP_AXIS)] = Shard(heads_dim)
    return tuple(out)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a DTensor
    takes its local gradient's layout for granted (its global view is
    contiguous), and a permuted one would fail the next view."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def to_local(x, mesh, pl: tuple, grad_pl: Optional[tuple] = None
             ) -> torch.Tensor:
    """The card's shard of ``x`` redistributed to ``pl`` (a plain tensor
    is taken as replicated); its gradient comes back placed by
    ``grad_pl`` (``pl`` if None)."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) != pl:
        x = x.redistribute(mesh, pl)
    return _ContiguousGrad.apply(x.to_local(grad_placements=grad_pl))


def summed_grad(pl: tuple, work: tuple) -> tuple:
    """The placements of the gradient of an input placed by ``pl`` that a
    computation split by ``work`` reads: ``Partial`` on each mesh dim
    where the work is split and the input whole (each card's part of
    the gradient is summed over those cards), else ``pl``'s."""
    return tuple(Partial() if isinstance(p, Replicate)
                 and isinstance(w, Shard) else p for p, w in zip(pl, work))


class _GradScale(torch.autograd.Function):
    """Identity whose backward multiplies the gradient by ``w`` (a Python
    number; 1 passes it through untouched)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.w = w
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.w == 1 else g * ctx.w), None


def counted_once(t: torch.Tensor, mesh, work: tuple) -> torch.Tensor:
    """``t``, a local value every card computes alike from inputs whose
    gradients are summed over the mesh dims that split ``work``
    (``summed_grad``): its gradient kept on the card at coordinate 0 of
    each such dim and zero on the others, so the sum counts it once."""
    lead = all(mesh.get_local_rank(i) == 0
               for i, w in enumerate(work) if isinstance(w, Shard))
    return _GradScale.apply(t, 1 if lead else 0)


def replicated(mesh) -> tuple:
    """Placements replicated on every mesh dim."""
    return (Replicate(),) * mesh.ndim


def replicated_local(x, work: tuple) -> torch.Tensor:
    """The whole of DTensor ``x`` on this card (an all-gather of its
    shards, partial sums reduced), for a computation split by ``work``
    (its gradient summed over the cards that split it)."""
    full = replicated(x.device_mesh)
    return to_local(x, x.device_mesh, full, summed_grad(full, work))


def local_slices(shape, mesh, pl: tuple) -> tuple:
    """The slices of a ``shape`` tensor that this card holds under
    placements ``pl`` (even splits; mesh dims split major to minor)."""
    start, size = [0] * len(shape), list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            size[p.dim] //= mesh.shape[i]
            start[p.dim] += mesh.get_local_rank(i) * size[p.dim]
    return tuple(slice(a, a + n) for a, n in zip(start, size))


def write_at(cache, dim: int, pos: int, value) -> None:
    """``cache[:, pos] = value`` along tensor dim ``dim`` (1: the caches'
    sequence), in place.  A plain tensor takes that very assignment.  On
    a DTensor, ``value`` is first redistributed to the cache's placements
    on the other dims (``dim`` itself whole), then each card whose block
    along ``dim`` holds ``pos`` writes it into its local shard at ``pos``
    minus the block's start; no other card writes.  (DTensor's own
    ``__setitem__`` drops the write on a dim split over several cards.)
    Blocks follow DTensor's split: mesh dims major to minor, each a
    ``ceil`` chunk, the last ones short or empty."""
    at = (slice(None),) * dim
    if not isinstance(cache, DTensor):
        cache[at + (pos,)] = value
        return
    mesh, pl = cache.device_mesh, tuple(cache.placements)
    vpl = tuple(p if not isinstance(p, Shard) else
                Replicate() if p.dim == dim else Shard(p.dim - (p.dim > dim))
                for p in pl)
    local = to_local(value, mesh, vpl)
    start, size = 0, cache.shape[dim]
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            block = -(-size // mesh.shape[i])
            skip = mesh.get_local_rank(i) * block
            start, size = start + skip, max(0, min(block, size - skip))
    if start <= pos < start + size:
        cache.to_local()[at + (pos - start,)] = local


def pending_sum(pl: tuple) -> tuple:
    """``Partial`` on each mesh dim that ``pl`` shards, else
    ``Replicate``: the placements of a sum each card made over its own
    shard."""
    return tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in pl)


def from_local(t: torch.Tensor, mesh, pl: tuple):
    """A DTensor of the card's shard ``t`` placed by ``pl`` (even
    splits)."""
    return DTensor.from_local(t, mesh, pl, run_check=False)


def heads_only(mesh, heads_dim: Optional[int]) -> tuple:
    """Placements with ``heads_dim`` (if any) on the model axis, whole on
    every other mesh dim (a weight or a per-head vector)."""
    out = [Replicate()] * mesh.ndim
    if heads_dim is not None:
        out[tuple(mesh.mesh_dim_names).index(TP_AXIS)] = Shard(heads_dim)
    return tuple(out)


def model_sum(mesh, pl: tuple, op: str = "sum") -> tuple:
    """``pl`` with the model axis's entry ``Partial(op)``: each card holds
    a part of a reduction (a sum, a max) over that axis."""
    out = list(pl)
    out[tuple(mesh.mesh_dim_names).index(TP_AXIS)] = Partial(op)
    return tuple(out)


def heads_split(mesh, n_heads: int) -> bool:
    """Whether ``n_heads`` heads split evenly over the model axis."""
    return n_heads % _axis_size(mesh, TP_AXIS) == 0


def vocab_split(mesh, vocab: int) -> bool:
    """Whether the vocab splits evenly over a model axis of more than one
    card (the vocab-parallel paths' masks and reductions are needed)."""
    return _axis_size(mesh, TP_AXIS) > 1 and heads_split(mesh, vocab)


def local_map(fn, mesh, args, in_pl, out_pl):
    """``fn`` run on this card's shards: each tensor of ``args`` is
    redistributed to its placements in ``in_pl`` and taken local (an
    entry ``None`` passes its argument as is), and each output is wrapped
    as a DTensor placed by ``out_pl`` (a tuple of placements, or one
    such tuple an output).  An input whole on a mesh dim that splits the
    (first) output gets its gradient summed over that dim."""
    many = isinstance(out_pl[0], tuple)
    work = out_pl[0] if many else out_pl
    local = [a if pl is None else to_local(a, mesh, pl,
                                           summed_grad(pl, work))
             for a, pl in zip(args, in_pl)]
    out = fn(*local)
    if many:
        return tuple(from_local(o, mesh, pl) for o, pl in zip(out, out_pl))
    return from_local(out, mesh, out_pl)


@dataclasses.dataclass(frozen=True)
class ShardCfg:
    mesh: Optional[Any]
    dp: Tuple[str, ...] = ("data",)
    tp: str = "model"
    seq_shard: bool = True          # Megatron-SP on the residual stream

    @property
    def tp_size(self) -> int:
        return _axis_size(self.mesh, self.tp) if self.mesh else 1

    @property
    def dp_size(self) -> int:
        if not self.mesh:
            return 1
        return math.prod(_axis_size(self.mesh, a) for a in self.dp)

    def named(self, spec: P) -> NamedSharding:
        return NamedSharding(self.mesh, placements(spec, self.mesh))

    # -------------------------------------------------------------- #
    def constrain(self, x, spec: P):
        if self.mesh is None:
            return x
        return with_sharding_constraint(x, self.named(spec))

    def act_residual(self, x):
        """(B,S,d) residual stream: batch on dp, seq on tp (SP)."""
        if self.mesh is None:
            return x
        B, S = x.shape[0], x.shape[1]
        bspec = self.dp if B % self.dp_size == 0 else None
        sspec = self.tp if (self.seq_shard and S % self.tp_size == 0
                            and S > 1) else None
        return self.constrain(x, P(bspec, sspec, None))

    def act_gathered(self, x):
        """(B,S,d) input of a block's products: batch on dp, the sequence
        whole (Megatron-SP's all-gather after the norm)."""
        if self.mesh is None:
            return x
        bspec = self.dp if x.shape[0] % self.dp_size == 0 else None
        return self.constrain(x, P(bspec, None, None))

    def act_logits(self, x):
        if self.mesh is None:
            return x
        B = x.shape[0]
        bspec = self.dp if B % self.dp_size == 0 else None
        return self.constrain(x, P(bspec, None, self.tp))


NO_SHARD = ShardCfg(mesh=None)


def replicating(shard: ShardCfg):
    """A context in which, under ``shard``'s mesh, a plain tensor that
    meets a DTensor (a RoPE table, a mask, a position) is taken as
    replicated; with no mesh, a context that does nothing."""
    return implicit_replication() if shard.mesh is not None else \
        contextlib.nullcontext()


# ------------------------------------------------------------------ #
# parameter specs by path rules
# ------------------------------------------------------------------ #
def _param_spec(path: str, shape: Tuple[int, ...], tp: str, tp_size: int
                ) -> P:
    """Rule table.  ``shape`` may have a leading scan/stack dim — rules match
    on the trailing dims; leading dims get None."""
    lead = (None,) * (len(shape) - 2)

    def ok(dim_idx_from_end: int) -> bool:
        return shape[len(shape) - dim_idx_from_end] % tp_size == 0

    name = path.rsplit("/", 1)[-1]
    expert = "/moe/" in path and "/shared/" not in path
    if name in ("embed",):                       # (V, d)
        return P(tp if shape[0] % tp_size == 0 else None, None)
    if name in ("unembed",):                     # (d, V)
        return P(None, tp if shape[-1] % tp_size == 0 else None)
    if name in ("w1", "w3", "w2") and expert:    # (.., E, d, f): EP on E
        lead3 = (None,) * (len(shape) - 3)
        return P(*lead3, tp if ok(3) else None, None, None)
    if name in ("w1", "w3"):                     # (.., d, f)
        return P(*lead, None, tp if ok(1) else None)
    if name == "w2":                             # (.., f, d)
        return P(*lead, tp if ok(2) else None, None)
    if name in ("wq", "wk", "wv", "wz", "wx", "wuk", "wuv"):
        return P(*lead, None, tp if ok(1) else None)
    if name in ("wo",):
        return P(*lead, tp if ok(2) else None, None)
    if name in ("router", "wdkv", "wkr", "wB", "wC", "wdt", "patch_proj",
                "pos_emb"):
        return P(*lead, None, None)
    # 1-D / small leftovers (norms, A_log, D, dt_bias, conv) -> replicate
    return P(*((None,) * len(shape)))


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def param_specs(params: PyTree, shard: ShardCfg) -> PyTree:
    """Spec tree matching ``params``.

    Stacked (repeated) groups carry leading stack dims; rules apply to the
    trailing two dims.  Expert stacks (E, d, f) are detected by rule name.
    """
    return tree.unflatten(params, [
        _param_spec(path, _shape(leaf), shard.tp, shard.tp_size)
        for path, leaf in tree.leaves_with_paths(params)])


def zero1_specs(params: PyTree, pspecs: PyTree, shard: ShardCfg) -> PyTree:
    """Optimizer-state specs: param spec + shard the largest replicated dim
    over the data axes (ZeRO-1)."""
    dp_size = shard.dp_size

    def has_dp(parts) -> bool:
        for ps in parts:
            if ps is None:
                continue
            axes = ps if isinstance(ps, tuple) else (ps,)
            if set(axes) & set(shard.dp):
                return True
        return False

    def upgrade(leaf, spec):
        shape = _shape(leaf)
        parts = list(spec)
        if len(shape) != len(parts):
            parts = [None] * len(shape)
        if has_dp(parts):              # already dp-sharded (e.g. fsdp)
            return P(*parts)
        for i, (dim, ps) in enumerate(zip(shape, parts)):
            if ps is None and dim % dp_size == 0 and dim >= dp_size > 1:
                parts[i] = shard.dp
                break
        return P(*parts)
    return tree.map(upgrade, params, pspecs)


def batch_specs(batch: PyTree, shard: ShardCfg) -> PyTree:
    def spec_of(leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        b = shard.dp if shape[0] % shard.dp_size == 0 else None
        return P(b, *([None] * (len(shape) - 1)))
    return tree.map(spec_of, batch)


def cache_specs(cache: PyTree, shard: ShardCfg) -> PyTree:
    """KV caches: (B, S, Hkv, hd) -> heads on tp when divisible, else the
    sequence dim (MQA long-context: cache sequence-sharded)."""
    tp, tps = shard.tp, shard.tp_size

    def spec_of(path, leaf):
        shape = _shape(leaf)
        name = path.rsplit("/", 1)[-1]

        def bspec(idx_from_end):
            dim = shape[len(shape) - idx_from_end]
            return shard.dp if dim % shard.dp_size == 0 else None

        if name in ("k", "v"):                   # (B,S,Hkv,hd) [+lead scan]
            lead = (None,) * (len(shape) - 4)
            if shape[-2] % tps == 0:
                return P(*lead, bspec(4), None, tp, None)
            return P(*lead, bspec(4), tp if shape[-3] % tps == 0 else None,
                     None, None)
        if name in ("c", "kr", "enc_out", "xk", "xv"):   # (B,S,*)
            lead = (None,) * (len(shape) - 3)
            return P(*lead, bspec(3),
                     tp if shape[-2] % tps == 0 else None, None)
        if name == "state":                      # (B,H,N,P) [+lead]
            lead = (None,) * (len(shape) - 4)
            return P(*lead, bspec(4), tp if shape[-3] % tps == 0 else None,
                     None, None)
        if name == "conv":                       # (B,W,ch)
            lead = (None,) * (len(shape) - 3)
            return P(*lead, bspec(3), None,
                     tp if shape[-1] % tps == 0 else None)
        return P(*([None] * len(shape)))
    return tree.unflatten(cache, [spec_of(path, leaf) for path, leaf
                                  in tree.leaves_with_paths(cache)])

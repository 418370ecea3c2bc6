"""Three-term roofline of the port's own eager program, per card.

    compute    = FLOPs_per_card / peak_FLOP/s
    memory     = bytes_per_card / HBM_bw
    collective = Σ per-collective ring-model bytes / its link's bw

The port of the reference's ``roofline``.  The reference reads XLA's
compiled program (``cost_analysis``, ``memory_analysis`` and the HLO's
collectives); an eager PyTorch program has none of these, so ``analyze``
runs the program under a dispatch-level counter and counts what it
executes, op by op:

  * FLOPs by ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
    registry), on each op's local shapes: over DTensors the counter sees
    the card's shard of every op, not the global op;
  * bytes as each op's tensor inputs read once plus its outputs written
    once.  Eager PyTorch fuses nothing, so this is what the program moves
    through device memory (views and metadata ops move nothing; an op
    that only overwrites its destination does not read it; a gather reads
    the rows it returns, not the whole table).  Caches are not modelled:
    an input small enough to stay in the 50 MB L2 is counted again at
    every read;
  * each functional collective (``_c10d_functional``'s all-gather,
    reduce-scatter, all-reduce, all-to-all) with its group, under the
    ring model of the bytes one card pushes through its links:

        all-gather      result_bytes · (G−1)/G
        reduce-scatter  operand_bytes · (G−1)/G
        all-reduce      2 · operand_bytes · (G−1)/G   (RS + AG)
        all-to-all      operand_bytes · (G−1)/G

    at the rate of the slowest link its group crosses;
  * memory: argument, output, temp and alias bytes per card from a
    live-bytes tracker over the storages the program allocates and frees
    (fake or real tensors alike).

Hardware constants: one NVIDIA H100 SXM (NVIDIA's data sheet and DGX H100
system; the card at its full 700 W): 989 TFLOP/s dense bfloat16 tensor
cores, 3.35 TB/s HBM3, NVLink 900 GB/s a card to the other cards of its
host, 450 GB/s each way (a group inside one host of 8, the "model"
axis), and one 400 Gb/s NIC a card, 50 GB/s (a group across hosts).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import tree

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
#: NVLink, each way, for a group inside one host
NVLINK_BW = 450e9
#: a card's network link, for a group that crosses hosts
LINK_BW = 50e9

#: cards a host holds (an H100 HGX board)
CARDS_PER_HOST = 8

_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def shape_bytes(shape: Sequence[int], dtype: torch.dtype) -> int:
    """Bytes of a dense tensor of ``shape`` and ``dtype``."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective as a card sees it: its kind, operand and result
    bytes, group size, the mesh axes of its group (empty when unknown)
    and whether the group crosses hosts."""
    kind: str
    operand_bytes: int
    result_bytes: int
    group_size: int
    axes: tuple = ()
    crosses_hosts: bool = True

    @property
    def ring_bytes(self) -> float:
        """Bytes this card pushes through its links (the ring model)."""
        g = max(self.group_size, 2)
        factor = (g - 1) / g
        if self.kind == "all-gather":
            return self.result_bytes * factor
        if self.kind == "all-reduce":
            return 2 * self.operand_bytes * factor
        if self.kind in ("reduce-scatter", "all-to-all"):
            return self.operand_bytes * factor
        return float(self.operand_bytes)          # collective-permute


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_moved: Dict[str, float]       # ring-model per-card bytes
    host_bytes: float = 0.0             # of which inside one host

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_moved.values())


def collective_stats(records: Sequence[Collective]) -> CollectiveStats:
    """The ring model over recorded collectives: counts and per-card bytes
    by kind, and the bytes that stay inside one host (NVLink)."""
    counts: Dict[str, int] = {}
    moved: Dict[str, float] = {}
    host = 0.0
    for c in records:
        counts[c.kind] = counts.get(c.kind, 0) + 1
        moved[c.kind] = moved.get(c.kind, 0.0) + c.ring_bytes
        if not c.crosses_hosts:
            host += c.ring_bytes
    return CollectiveStats(counts, moved, host)


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_detail: Dict[str, float]
    coll_counts: Dict[str, int]
    peak_mem_bytes: float
    #: of ``coll_bytes_per_chip``, the bytes over NVLink (inside a host)
    coll_host_bytes_per_chip: float = 0.0
    #: argument / output / temp / alias bytes per card (XLA's names)
    memory: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        host = min(self.coll_host_bytes_per_chip, self.coll_bytes_per_chip)
        return host / NVLINK_BW + (self.coll_bytes_per_chip - host) / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_host_bytes_per_chip": self.coll_host_bytes_per_chip,
            "coll_detail": self.coll_detail,
            "coll_counts": self.coll_counts,
            "peak_mem_bytes": self.peak_mem_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
        }


# ------------------------------------------------------------------ #
# the dispatch-level counter
# ------------------------------------------------------------------ #
_aten = torch.ops.aten
#: ops that overwrite their destination without reading it
_WRITE_ONLY = {
    _aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
    _aten.zero_.default, _aten.normal_.default, _aten.uniform_.default,
    _aten.index_put_.default, _aten._index_put_impl_.default,
}
#: gathers: read the indices and the rows they return
_GATHERS = {
    _aten.index.Tensor, _aten.embedding.default, _aten.index_select.default,
    _aten.gather.default,
}
#: scatters: read the values and indices, write the values' size
_SCATTERS = {
    _aten.index_put_.default, _aten._index_put_impl_.default,
    _aten.index_put.default, _aten.index_add_.default,
    _aten.index_add.default, _aten.scatter_add_.default,
    _aten.scatter_add.default, _aten.scatter_.src, _aten.scatter.src,
}


def _tensors(xs) -> List[torch.Tensor]:
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
    return out


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


class _ShardPropGuard:
    """While entered, DTensor's global-shape metadata propagation (it runs
    each new op once on fake tensors of the global shapes) is flagged on
    ``counter``, which then counts nothing: only the card's local ops
    are the program."""

    def __init__(self, counter: "Counter"):
        self.counter = counter

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        self.cls, self.orig = ShardingPropagator, \
            ShardingPropagator._propagate_tensor_meta_non_cached
        orig, counter = self.orig, self.counter

        def guarded(prop, op_schema):
            counter.meta_depth += 1
            try:
                return orig(prop, op_schema)
            finally:
                counter.meta_depth -= 1
        self.cls._propagate_tensor_meta_non_cached = guarded
        return self

    def __exit__(self, *exc):
        self.cls._propagate_tensor_meta_non_cached = self.orig


class Counter(TorchDispatchMode):
    """Counts, per card, the FLOPs, bytes and collectives of the ops run
    under it, and tracks the live bytes of the storages they allocate.
    Ops on DTensors are left to DTensor (``NotImplemented``), whose local
    ops on the card's shards then come through here."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: Dict[str, List[float]] = {}
        self.collectives: List[Collective] = []
        self.meta_depth = 0
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self._storages: Dict[int, int] = {}   # id(storage) -> bytes
        self._args: set = set()
        self._open = True
        self._groups = self._mesh_groups(mesh)

    @staticmethod
    def _mesh_groups(mesh) -> Dict[str, tuple]:
        """group name -> (axis names, size, crosses hosts) for each mesh
        dim's group holding this rank."""
        if mesh is None:
            return {}
        out = {}
        for i, name in enumerate(mesh.mesh_dim_names):
            g = mesh.get_group(i)
            ranks = dist.get_process_group_ranks(g)
            hosts = {r // CARDS_PER_HOST for r in ranks}
            out[g.group_name] = ((name,), len(ranks), len(hosts) > 1)
        return out

    # -------------------------------------------------------- memory
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        n = self._storages.pop(key, 0)
        if self._open:
            self.live -= n

    def arguments(self, args) -> None:
        """Take the arguments' storages (a DTensor's local shard) as live
        from the start."""
        for t in tree.leaves(args):
            if isinstance(t, torch.Tensor):
                st = _local(t).untyped_storage()
                if id(st) not in self._args:
                    self._args.add(id(st))
                    self._track(_local(t))
        self.argument_bytes = self.live

    def memory(self, out) -> Dict[str, int]:
        """XLA's memory analysis by the same names, from the outputs."""
        seen, new, alias = set(), 0, 0
        for t in tree.leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = _local(t).untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            if id(st) in self._args:
                alias += st.nbytes()
            else:
                new += st.nbytes()
        self._open = False
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": new + alias,
                "temp_size_in_bytes": max(
                    self.peak - self.argument_bytes - new, 0),
                "generated_code_size_in_bytes": 0,
                "alias_size_in_bytes": alias}

    # -------------------------------------------------------- counting
    def _collective(self, func, args, out) -> None:
        kind = _KINDS.get(func._overloadpacket.__name__)
        if kind is None:
            return
        name = args[-1]
        axes, size, crosses = self._groups.get(name, ((), None, True))
        if size is None:
            size = dist.get_world_size(
                dist.distributed_c10d._resolve_process_group(name))
        self.collectives.append(Collective(
            kind, _nbytes(args[0]), sum(map(_nbytes, _tensors([out]))),
            size, axes, crosses))

    def _op_bytes(self, func, args, kwargs, out) -> float:
        ins = _tensors(list(args) + list(kwargs.values()))
        outs = _tensors([out])
        in_st = {id(t.untyped_storage()) for t in ins}
        mutating = func._schema.is_mutable
        if not mutating and outs and all(
                id(t.untyped_storage()) in in_st for t in outs):
            return 0.0                               # a view
        if func in _GATHERS:
            idx = [t for t in ins if not t.is_floating_point()]
            return sum(map(_nbytes, idx)) + 2 * sum(map(_nbytes, outs))
        if func in _SCATTERS:
            vals = [t for t in ins[1:] if t.is_floating_point()]
            idx = [t for t in ins[1:] if not t.is_floating_point()]
            return sum(map(_nbytes, idx)) + 2 * sum(map(_nbytes, vals))
        if func in _WRITE_ONLY:
            ins = ins[1:]
        return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.meta_depth or not self._open:
            return out
        ns = func.namespace
        if ns == "_c10d_functional":
            self._collective(func, args, out)
        elif ns != "aten":
            return out
        packet = func._overloadpacket
        f = flop_registry[packet](*args, **kwargs, out_val=out) \
            if packet in flop_registry else 0
        b = self._op_bytes(func, args, kwargs, out)
        self.flops += f
        self.bytes += b
        if f or b:
            rec = self.by_op.setdefault(packet.__name__, [0, 0.0, 0.0])
            rec[0] += 1
            rec[1] += f
            rec[2] += b
        for t in _tensors([out]):
            self._track(t)
        return out

    def roofline(self, memory: Dict[str, int]) -> Roofline:
        st = collective_stats(self.collectives)
        return Roofline(self.flops, self.bytes, st.total_bytes,
                        st.bytes_moved, st.counts, float(self.peak),
                        st.host_bytes, memory)


def analyze(fn, *args, mesh=None, counter: Optional[Counter] = None,
            **kwargs) -> Roofline:
    """Run ``fn(*args, **kwargs)`` once under a ``Counter`` and return
    its per-card ``Roofline`` (``memory`` filled).  ``mesh`` names the
    axes of the collectives' groups; pass ``counter`` to read its
    per-op tallies after."""
    c = counter or Counter(mesh)
    c.arguments((args, kwargs))
    with _ShardPropGuard(c), c:
        out = fn(*args, **kwargs)
    mem = c.memory(out)
    return c.roofline(mem)


def model_flops(cfg, shape: dict) -> float:
    """6·N_active·tokens (train) or 2·N_active·tokens (single fwd/decode)."""
    n_active = cfg.active_param_count()
    if shape["kind"] == "train":
        toks = shape["global_batch"] * shape["seq_len"]
        return 6.0 * n_active * toks
    if shape["kind"] == "prefill":
        toks = shape["global_batch"] * shape["seq_len"]
        return 2.0 * n_active * toks
    return 2.0 * n_active * shape["global_batch"]       # decode: 1 tok/seq

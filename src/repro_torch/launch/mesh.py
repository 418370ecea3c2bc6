"""Production mesh construction.

The port of the reference's ``launch.mesh`` as ``DeviceMesh``es.  The
production meshes are H100 hosts of 8 cards: tensor parallelism
("model") stays inside a host's NVLink domain, data parallelism crosses
hosts.  256 cards are 32 hosts, ``(32, 8)`` over ``("data", "model")``;
two such pods are ``(2, 32, 8)`` over ``("pod", "data", "model")``.

A production mesh lives on a fake process group (``torch.distributed``'s
"fake" backend: rank 0 of 256 or 512, every collective a no-op that
gives the right shapes), so the dry run can place and run the programs
of those meshes in one process without the cards.  The host mesh
(``make_host_mesh``) lives on a real group (``init_host_group``: NCCL
between cards, gloo on the CPU), whose collectives move the data.  The
two never overlap in one process.  Nothing happens at import: a group is
made when asked, and ``release`` destroys a group this module made; a
process group made by someone else is never touched.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.util import resolve_device

_made: Optional[str] = None        # "fake" or "real": the group we made


def fake_mesh(shape: Sequence[int], names: Sequence[str],
              device: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over a fake process group of
    ``prod(shape)`` ranks, this process rank 0, its tensors on ``device``
    (``"cuda"`` or ``"cpu"``).  A fake group made earlier by this module
    is destroyed first; a real one is left alone and refused."""
    global _made
    # importing it registers the "fake" backend; a private module of
    # torch, so it is imported only here
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = math.prod(shape)
    if dist.is_initialized():
        if _made != "fake":
            raise RuntimeError("a process group is already initialised: the "
                               "dry run needs its own fake group")
        release()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    _made = "fake"
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(names))


def release() -> None:
    """Destroy the process group this module made (fake or real), if
    any."""
    global _made
    if _made is not None and dist.is_initialized():
        dist.destroy_process_group()
    _made = None


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """32×8 mesh (256 cards, 32 hosts of 8), or 2×32×8 across two pods,
    on a fake process group (``release`` destroys it)."""
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_mesh(shape, axes, device)


def init_host_group(device: str = "cuda", store: Optional[dist.Store] = None
                    ) -> torch.device:
    """This process's place in a real process group, and the device it
    owns (``cuda:{LOCAL_RANK}``, or the CPU).

    ``"cuda"`` gives NCCL bound to the rank's card (a host without one
    raises); ``"cpu"`` gives gloo.  A group already initialised by
    someone else is used as it is (its backend must serve ``device``).
    Otherwise, under ``torchrun`` (``WORLD_SIZE``, ``RANK`` and
    ``MASTER_ADDR`` set) the group is read from ``env://``; else it is a
    world of one over ``store`` (a new ``HashStore`` if None).  A group
    made here stays until ``release``."""
    global _made
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if _made == "fake":
            raise RuntimeError("the dry run's fake group is still "
                               "initialised: release it first")
        if backend not in dist.get_backend():
            raise RuntimeError(f"the process group's backend "
                               f"{dist.get_backend()!r} does not serve "
                               f"{dev.type}")
    else:
        kw = {}
        if dev.type == "cuda":
            kw["device_id"] = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", 0)))
        if all(k in os.environ for k in ("WORLD_SIZE", "RANK",
                                         "MASTER_ADDR")):
            dist.init_process_group(backend, init_method="env://", **kw)
        else:
            dist.init_process_group(
                backend, store=dist.HashStore() if store is None else store,
                rank=0, world_size=1, **kw)
        _made = "real"
    if dev.type == "cpu":
        return dev
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                  dist.get_rank())))
    torch.cuda.set_device(dev)
    return dev


def make_host_mesh(device: str = "cuda") -> DeviceMesh:
    """Every rank of the host's real process group (``init_host_group``,
    made here if there is none) as a (1, n) data×model mesh: n is the
    world size, each rank on its own card (the CPU is one device a
    rank)."""
    dev = init_host_group(device)
    return init_device_mesh(dev.type, (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))


def distinct_cards(mesh: DeviceMesh) -> bool:
    """Whether the mesh's ranks sit on distinct cards (each rank's card
    UUID, gathered over the whole group; the CPU is not a card)."""
    if mesh.device_type != "cuda":
        return False
    uuid = str(torch.cuda.get_device_properties(
        torch.cuda.current_device()).uuid)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, uuid)
    return len(set(out)) == len(out)


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))

"""Production mesh construction.

The port of the reference's ``launch.mesh`` as ``DeviceMesh``es.  The
production meshes are H100 hosts of 8 cards: tensor parallelism
("model") stays inside a host's NVLink domain, data parallelism crosses
hosts.  256 cards are 32 hosts, ``(32, 8)`` over ``("data", "model")``;
two such pods are ``(2, 32, 8)`` over ``("pod", "data", "model")``.

A production mesh lives on a fake process group (``torch.distributed``'s
"fake" backend: rank 0 of 256 or 512, every collective a no-op that
gives the right shapes), so the dry run can place and run the programs
of those meshes in one process without the cards.  Nothing happens at
import: ``fake_mesh`` creates the group and ``release`` destroys it.  A
process group made by someone else is never touched.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

_made: Optional[int] = None        # world size of the fake group we made


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
        if _made is None:
            raise RuntimeError("a process group is already initialised: the "
                               "dry run needs its own fake group")
        release()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    _made = world
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(names))


def release() -> None:
    """Destroy the fake process group this module made, if any."""
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


def make_host_mesh(device: str = "cuda") -> DeviceMesh:
    """The cards this process sees, as a (1, n) data×model mesh, on a fake
    group (n = 1 on a one-card machine; the CPU is one device)."""
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1
    return fake_mesh((1, n), ("data", "model"), device)


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))

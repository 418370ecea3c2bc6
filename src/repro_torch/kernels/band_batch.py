"""Batched band-distance sweep: the CUDA kernel, its plain version, a count.

``bfs_multi`` is the port of the reference's ``kernels/band_batch.py``
``bfs_multi`` (a Pallas TPU kernel).  For every lane it runs ``width``
Jacobi min-plus relaxations over an ELL tile from a source mask: a vertex
within ``width`` hops gets its exact distance, every other vertex keeps
``UNREACH``.  On a CUDA tensor the wrapper launches
``csrc/bfs_multi.cu``; on a CPU tensor it runs ``bfs_multi_plain``, the
same relaxation in torch.  ``launches`` counts CUDA kernel launches:
``width + 1`` per call (``bfs_init`` and one ``bfs_relax`` per step).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

UNREACH = 2 ** 30

#: number of CUDA kernels ``bfs_multi`` launched
launches = 0


def bfs_multi_plain(nbr: torch.Tensor, src: torch.Tensor,
                    width: int) -> torch.Tensor:
    """The relaxation in torch, on any device (the kernel's plain version)."""
    L, n, d = nbr.shape
    valid = nbr >= 0
    idx = torch.where(valid, nbr, 0).long().reshape(L, n * d)
    dist = torch.where(src != 0, 0, UNREACH).to(torch.int32)
    for _ in range(width):
        dn = dist.gather(1, idx).reshape(L, n, d)
        dn = torch.where(valid, dn, UNREACH)
        dist = torch.minimum(dist, dn.amin(dim=2) + 1)
    return dist


def _check(nbr: torch.Tensor, src: torch.Tensor) -> None:
    if nbr.dim() != 3 or src.shape != nbr.shape[:2]:
        raise ValueError(f"nbr (L, n, d) and src (L, n) expected, got "
                         f"{tuple(nbr.shape)} and {tuple(src.shape)}")
    if nbr.dtype != torch.int32 or src.dtype != torch.int32:
        raise TypeError("nbr and src must be int32")
    if nbr.device != src.device:
        raise ValueError("nbr and src must be on one device")


def bfs_multi_kernel(nbr: torch.Tensor, src: torch.Tensor,
                     width: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (CUDA tensors only)."""
    global launches
    _check(nbr, src)
    if nbr.device.type != "cuda":
        raise ValueError("bfs_multi_kernel takes CUDA tensors")
    nbr, src = nbr.contiguous(), src.contiguous()
    L, n, d = nbr.shape
    dist = torch.empty((L, n), dtype=torch.int32, device=nbr.device)
    scratch = torch.empty_like(dist)
    lib = build.load("bfs_multi")
    stream = torch.cuda.current_stream(nbr.device).cuda_stream
    err = lib.bfs_multi_launch(nbr.data_ptr(), src.data_ptr(),
                               dist.data_ptr(), scratch.data_ptr(),
                               L, n, d, int(width), stream)
    build.check(err, "bfs_multi")
    launches += int(width) + 1
    return dist


def bfs_multi(nbr: torch.Tensor, src: torch.Tensor,
              width: int) -> torch.Tensor:
    """dist[l, v] = distance in graph l from src_l if ≤ width, else UNREACH.

    nbr (L, n, d) int32 ELL ids (-1 pads), src (L, n) int32 (nonzero =
    source) → (L, n) int32.  CUDA tensors go to the kernel, CPU tensors
    to the plain version.
    """
    _check(nbr, src)
    if nbr.device.type == "cuda":
        return bfs_multi_kernel(nbr, src, width)
    return bfs_multi_plain(nbr, src, width)

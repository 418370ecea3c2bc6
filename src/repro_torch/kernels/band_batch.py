"""Batched band kernels: the band-distance sweep and the FM gains.

``bfs_multi`` is the port of the reference's ``kernels/band_batch.py``
``bfs_multi`` (a Pallas TPU kernel).  For every lane it runs ``width``
Jacobi min-plus relaxations over an ELL tile from a source mask: a vertex
within ``width`` hops gets its exact distance, every other vertex keeps
``UNREACH``.  On a CUDA tensor the wrapper launches
``csrc/bfs_multi.cu``; on a CPU tensor it runs ``bfs_multi_plain``, the
same relaxation in torch.  ``launches`` counts CUDA kernel launches:
``width + 1`` per call (``bfs_init`` and one ``bfs_relax`` per step).

``sep_gain_multi`` is the port of the reference's ``sep_gain_multi``: the
pulled weights of the hoisted FM path's per-pass gain recompute.  Like
``fm_fused_multi`` it takes one ELL tile per work and a lane→tile index
``lane_work``; the reference's (L, n, d) form is ``lane_work = arange(L)``.
CUDA tensors go to ``csrc/sep_gain.cu``, CPU tensors to
``sep_gain_multi_plain``.  ``gain_launches`` counts its kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

UNREACH = 2 ** 30

#: number of CUDA kernels ``bfs_multi`` launched
launches = 0
#: number of times ``sep_gain_multi`` launched its CUDA kernel
gain_launches = 0


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


def sep_gain_multi_plain(nbr: torch.Tensor, lane_work: torch.Tensor,
                         vwgt: torch.Tensor, part: torch.Tensor):
    """The pulled weights in torch, on any device (the plain version).

    nbr (W, n, d) int32 tiles, lane_work (L,) int32, vwgt (L, n) float32,
    part (L, n) integer states.  Returns (pulled0, pulled1), each (L, n)
    float32: pulled0[l, v] sums vwgt[l, u] over the slots of row v whose
    u has part 1, pulled1 over part 0; -1 slots add nothing.
    """
    L = lane_work.shape[0]
    n, d = nbr.shape[1:]
    nbr_l = nbr.index_select(0, lane_work.long())
    valid = nbr_l >= 0
    flat = torch.where(valid, nbr_l, 0).long().reshape(L, n * d)
    pn = part.gather(1, flat).reshape(L, n, d)
    wn = torch.where(valid, vwgt.gather(1, flat).reshape(L, n, d), 0.0)
    return (wn * (pn == 1)).sum(2), (wn * (pn == 0)).sum(2)


def check_tensors(nbr: torch.Tensor, want: dict) -> None:
    """Raise unless each ``name: (tensor, dtype, shape)`` of ``want`` has
    that dtype and shape and lies on ``nbr``'s device."""
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != nbr.device:
            raise ValueError(f"{name} is on {t.device}, nbr on {nbr.device}")


def check_tiles(nbr: torch.Tensor, lane_work: torch.Tensor) -> None:
    """Raise unless the tiles are on the card and ``lane_work`` names
    tiles that exist (the kernels index the tiles by it)."""
    if nbr.device.type != "cuda":
        raise ValueError("the kernel takes CUDA tensors")
    if lane_work.numel():
        lo, hi = int(lane_work.min()), int(lane_work.max())
        if lo < 0 or hi >= nbr.shape[0]:
            raise ValueError(f"lane_work spans [{lo}, {hi}], outside the "
                             f"{nbr.shape[0]} tiles")


def _check_gain(nbr, lane_work, vwgt, part) -> None:
    W, n, d = nbr.shape
    L = lane_work.shape[0]
    check_tensors(nbr, {"nbr": (nbr, torch.int32, (W, n, d)),
                        "lane_work": (lane_work, torch.int32, (L,)),
                        "vwgt": (vwgt, torch.float32, (L, n)),
                        "part": (part, torch.int8, (L, n))})


def sep_gain_multi_kernel(nbr, lane_work, vwgt, part):
    """Launch the CUDA kernel on the current stream (CUDA tensors only)."""
    global gain_launches
    _check_gain(nbr, lane_work, vwgt, part)
    check_tiles(nbr, lane_work)
    nbr, lane_work, vwgt, part = (t.contiguous() for t in
                                  (nbr, lane_work, vwgt, part))
    L = lane_work.shape[0]
    n, d = nbr.shape[1:]
    pulled0 = torch.empty((L, n), dtype=torch.float32, device=nbr.device)
    pulled1 = torch.empty_like(pulled0)
    lib = build.load("sep_gain")
    stream = torch.cuda.current_stream(nbr.device).cuda_stream
    err = lib.sep_gain_launch(nbr.data_ptr(), lane_work.data_ptr(),
                              vwgt.data_ptr(), part.data_ptr(),
                              pulled0.data_ptr(), pulled1.data_ptr(),
                              L, n, d, stream)
    build.check(err, "sep_gain")
    gain_launches += 1
    return pulled0, pulled1


def sep_gain_multi(nbr: torch.Tensor, lane_work: torch.Tensor,
                   vwgt: torch.Tensor, part: torch.Tensor):
    """Batched separator FM gains: (pulled0, pulled1), each (L, n) float32.

    nbr (W, n, d) int32 ELL tiles (-1 pads), lane_work (L,) int32 naming
    each lane's tile, vwgt (L, n) float32, part (L, n) int8.  The gain of
    moving v to side 0 is vwgt[v] − pulled0[v] (side 1 likewise).  CUDA
    tensors go to the kernel, CPU tensors to the plain version.
    """
    _check_gain(nbr, lane_work, vwgt, part)
    if nbr.device.type == "cuda":
        return sep_gain_multi_kernel(nbr, lane_work, vwgt, part)
    return sep_gain_multi_plain(nbr, lane_work, vwgt, part)

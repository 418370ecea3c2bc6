"""Batched band kernels: the band-distance sweep and the FM gains.

``bfs_multi`` is the port of the reference's ``kernels/band_batch.py``
``bfs_multi`` (a Pallas TPU kernel).  For every lane it runs ``width``
Jacobi min-plus relaxations over an ELL tile from a source mask: a vertex
within ``width`` hops gets its exact distance, every other vertex keeps
``UNREACH``.  On a CUDA tensor the wrapper launches
``csrc/bfs_multi.cu`` in the design ``lane_plan`` picks from the lanes'
size: one launch a call on a thread-block cluster per lane, or, for
lanes above ``CLUSTER_MAX_SLOTS`` slots, ``width + 1`` launches over the
whole card; on a CPU tensor it runs ``bfs_multi_plain``, the same
relaxation in torch.  ``launches`` counts the CUDA kernel launches.

``sep_gain_multi`` is the port of the reference's ``sep_gain_multi``: the
pulled weights of the hoisted FM path's per-pass gain recompute.  Like
``fm_fused_multi`` it takes one ELL tile per work and a lane→tile index
``lane_work``; the reference's (L, n, d) form is ``lane_work = arange(L)``.
CUDA tensors go to ``csrc/sep_gain.cu``, CPU tensors to
``sep_gain_multi_plain``.  ``gain_launches`` counts its kernel launches.
The kernel takes the tiles' ``RowExtents`` (``row_extents``: each row's
extent and the group width, made on the host once a bucket), so that it
reads a band tile's real ids and not the padding of its rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

UNREACH = 2 ** 30

#: number of CUDA kernels ``bfs_multi`` launched
launches = 0
#: number of times ``sep_gain_multi`` launched its CUDA kernel
gain_launches = 0


#: the most CTAs of a lane's cluster (16, a non-portable size on Hopper)
CLUSTER_MAX = 16
#: the slots (rows × width) a CTA of a lane's cluster takes until the
#: cluster is full: two passes of its 1,024 threads at 8 slots each
CTA_SLOTS = 2 ** 14
#: the largest lane (n × d slots) the cluster designs take.  On an H100
#: at 2^18 slots, one lane of the main path's buckets: the matching's
#: designs are within 3% (or the clusters ahead), the BFS is 2-20% faster
#: on clusters; with the service's 52-58 lanes the cluster designs are
#: 1.1-1.3× (BFS) and 1.7-2.3× (matching) faster.  Random lanes with no
#: locality are the exception: there one lane's BFS is 1.3-1.7× faster
#: on the grid design (the matching ties, or is 12% faster at d 32).  At
#: 2^20 the grid designs are 1.3-2.2× faster.  The two kernels agree at
#: every shape the ordering gives them, so they share this plan
#: (PERF.md §6, ``chip_smoke.py`` phases 3 and 8)
CLUSTER_MAX_SLOTS = 2 ** 18


def cluster_size(n: int, d: int) -> int:
    """CTAs of the cluster of a lane of (n, d): enough for ``CTA_SLOTS``
    slots each, at most ``CLUSTER_MAX``."""
    return min(CLUSTER_MAX, max(1, -(-(n * d) // CTA_SLOTS)))


def lane_plan(n: int, d: int) -> Tuple[str, Optional[int]]:
    """The design of the matching and BFS kernels for lanes of (n, d):
    ``("cluster", cluster_size(n, d))``, one launch a call, up to
    ``CLUSTER_MAX_SLOTS`` slots; ``("grid", None)``, a launch a phase over
    the whole card, above it."""
    if n * d > CLUSTER_MAX_SLOTS:
        return "grid", None
    return "cluster", cluster_size(n, d)


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
    """Launch the CUDA kernel on the current stream (CUDA tensors only), in
    the design ``lane_plan`` picks."""
    global launches
    _check(nbr, src)
    if nbr.device.type != "cuda":
        raise ValueError("bfs_multi_kernel takes CUDA tensors")
    nbr, src = nbr.contiguous(), src.contiguous()
    L, n, d = nbr.shape
    bufs = torch.empty((2, L, n), dtype=torch.int32, device=nbr.device)
    lib = build.load("bfs_multi")
    stream = torch.cuda.current_stream(nbr.device).cuda_stream
    args = (nbr.data_ptr(), src.data_ptr(), bufs[0].data_ptr(),
            bufs[1].data_ptr(), L, n, d, int(width))
    design, C = lane_plan(n, d)
    if design == "cluster":
        err, count = lib.bfs_cluster_launch(*args, C, stream), 1
    else:
        err, count = lib.bfs_multi_launch(*args, stream), int(width) + 1
    build.check(err, "bfs_multi")
    if L and n:
        launches += count
    return bufs[0]


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


class RowExtents(NamedTuple):
    """The row extents of a bucket's ELL tiles, which the gain kernel reads
    in place of the tiles' width: ``row_len`` (W, n) int32, 1 + the last
    slot of each row that holds an id (0 for an empty row), and ``group``,
    the threads the kernel gives a row (``extent_group`` of the non-empty
    rows' mean extent).  Made once a bucket by ``row_extents``."""
    row_len: torch.Tensor
    group: int

    def to(self, device) -> "RowExtents":
        return RowExtents(self.row_len.to(device), self.group)


def extent_group(mean_extent: float) -> int:
    """Threads that read one row of extents averaging ``mean_extent``: the
    power of two at or above it, at most 32 (longer rows loop)."""
    group = 1
    while group < 32 and group < mean_extent:
        group *= 2
    return group


def row_extents(nbr) -> RowExtents:
    """The extents of host tiles ``nbr`` (W, n, d) (numpy or a CPU tensor),
    computed with numpy where the tiles are made."""
    held = np.asarray(nbr) >= 0
    last = held.shape[-1] - np.argmax(held[..., ::-1], axis=-1)
    row_len = np.where(held.any(-1), last, 0).astype(np.int32)
    full = row_len[row_len > 0]
    return RowExtents(torch.from_numpy(row_len),
                      extent_group(full.mean() if full.size else 0.0))


def check_tensors(nbr: torch.Tensor, want: dict) -> None:
    """Raise unless each ``name: (tensor, dtype, shape)`` of ``want`` has
    that dtype and shape and lies on ``nbr``'s device."""
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != nbr.device:
            raise ValueError(f"{name} is on {t.device}, nbr on {nbr.device}")


def check_spans(nbr: torch.Tensor, lane_work: torch.Tensor,
                row_len: Optional[torch.Tensor] = None) -> None:
    """Raise unless ``lane_work`` names tiles of ``nbr`` that exist and, if
    given, every extent of ``row_len`` lies in [0, d].  Reads host tensors
    only, where a bucket's arrays are made (``core.fm.pack_fm_bucket``) or
    where the plain versions run, so the card's wrappers never sync for
    it; the kernels read a ``lane_work`` outside the tiles as an empty
    tile and clamp each extent to [0, d]."""
    W, _, d = nbr.shape
    for t, hi, name in ((lane_work, W - 1, "lane_work"),
                        (row_len, d, "row_len")):
        if t is None or not t.numel():
            continue
        if t.device.type != "cpu":
            raise ValueError(f"check_spans reads host tensors; {name} is on "
                             f"{t.device}")
        lo_t, hi_t = (int(x) for x in torch.aminmax(t))
        if lo_t < 0 or hi_t > hi:
            raise ValueError(f"{name} spans [{lo_t}, {hi_t}], outside "
                             f"[0, {hi}]")


def require_card(t: torch.Tensor) -> None:
    """Raise unless ``t`` is on the card: the kernels take CUDA tensors."""
    if t.device.type != "cuda":
        raise ValueError("the kernel takes CUDA tensors")


def _check_gain(nbr, lane_work, vwgt, part, extents) -> None:
    W, n, d = nbr.shape
    L = lane_work.shape[0]
    want = {"nbr": (nbr, torch.int32, (W, n, d)),
            "lane_work": (lane_work, torch.int32, (L,)),
            "vwgt": (vwgt, torch.float32, (L, n)),
            "part": (part, torch.int8, (L, n))}
    if extents is not None:
        if not isinstance(extents, RowExtents) or \
                extents.group not in (1, 2, 4, 8, 16, 32):
            raise ValueError("extents: want a RowExtents (row_extents) with "
                             "a group of 1 to 32 threads, a power of two")
        want["row_len"] = (extents.row_len, torch.int32, (W, n))
    check_tensors(nbr, want)


def sep_gain_multi_kernel(nbr, lane_work, vwgt, part,
                          extents: Optional[RowExtents] = None):
    """Launch the CUDA kernel on the current stream (CUDA tensors only;
    ``extents`` is required).  No host sync: ``lane_work`` and the
    extents are checked where they are made (``check_spans``)."""
    global gain_launches
    _check_gain(nbr, lane_work, vwgt, part, extents)
    require_card(nbr)
    if extents is None:
        raise ValueError("the gain kernel reads the tiles' row extents: "
                         "pass extents=row_extents(tiles)")
    nbr, lane_work, vwgt, part, row_len = (t.contiguous() for t in (
        nbr, lane_work, vwgt, part, extents.row_len))
    L = lane_work.shape[0]
    n, d = nbr.shape[1:]
    pulled0 = torch.empty((L, n), dtype=torch.float32, device=nbr.device)
    pulled1 = torch.empty_like(pulled0)
    lib = build.load("sep_gain")
    stream = torch.cuda.current_stream(nbr.device).cuda_stream
    err = lib.sep_gain_launch(nbr.data_ptr(), lane_work.data_ptr(),
                              row_len.data_ptr(), vwgt.data_ptr(),
                              part.data_ptr(), pulled0.data_ptr(),
                              pulled1.data_ptr(), L, nbr.shape[0], n, d,
                              extents.group, stream)
    build.check(err, "sep_gain")
    gain_launches += 1
    return pulled0, pulled1


def sep_gain_multi(nbr: torch.Tensor, lane_work: torch.Tensor,
                   vwgt: torch.Tensor, part: torch.Tensor,
                   extents: Optional[RowExtents] = None):
    """Batched separator FM gains: (pulled0, pulled1), each (L, n) float32.

    nbr (W, n, d) int32 ELL tiles (-1 pads), lane_work (L,) int32 naming
    each lane's tile, vwgt (L, n) float32, part (L, n) int8, and the
    tiles' ``extents`` (``row_extents``; on the tiles' device), which the
    kernel needs, so that it reads no slot past a row's last id.  The gain
    of moving v to side 0 is vwgt[v] − pulled0[v] (side 1 likewise).  CUDA
    tensors go to the kernel, CPU tensors to the plain version, which
    checks the extents given and has no use for them.
    """
    _check_gain(nbr, lane_work, vwgt, part, extents)
    if nbr.device.type == "cuda":
        return sep_gain_multi_kernel(nbr, lane_work, vwgt, part, extents)
    check_spans(nbr, lane_work, None if extents is None else extents.row_len)
    return sep_gain_multi_plain(nbr, lane_work, vwgt, part)

"""Shared utilities: seed mixing, pow2 bucketing, device resolution,
and the host↔device copies of the collectives' works."""
from __future__ import annotations

import threading

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def mix_seeds(*vals: int) -> int:
    """Splitmix64-style hash of a seed path → 31-bit PRNG seed.

    Per-node seeds in the ND tree are derived by chaining this over
    (seed, node path, level).  Affine formulas like ``seed * 31`` or
    ``seed * 101 + lvl`` collapse at ``seed=0`` (every node at a level
    reuses the identical noise stream); a full-avalanche mix does not.
    """
    h = 0
    for v in vals:
        h = (h + int(v) + 0x9E3779B97F4A7C15) & _MASK64
        h ^= h >> 30
        h = (h * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 27
        h = (h * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h & 0x7FFFFFFF


def pow2(x: int, lo: int = 64) -> int:
    v = lo
    while v < x:
        v *= 2
    return v


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless told otherwise.

    ``None`` means ``"cuda"``.  Asking for CUDA on a host without a card
    raises instead of quietly running on the CPU; the CPU is used only
    when the caller names it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def host_tensor(numel: int, device: torch.device) -> torch.Tensor:
    """An empty int32 host tensor to stage a work's inputs in before
    ``upload``: pinned when ``device`` is the card, so that the work
    uploads in one asynchronous copy (PyTorch's pinned-memory cache reuses
    the buffer once that copy has landed)."""
    return torch.empty(numel, dtype=torch.int32,
                       pin_memory=device.type == "cuda")


def upload(buf: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A staged host tensor (``host_tensor``) on ``device``, in one copy."""
    return buf.to(device, non_blocking=True)


def download(t: torch.Tensor) -> np.ndarray:
    """A work's result on the host, in one copy, which waits for its
    kernel."""
    return t.cpu().numpy()


class HostStage(threading.local):
    """A pinned host buffer of int32 words that a thread reuses for its
    round trips to the card, grown (to a power of two) when a call needs
    more: no pinned allocation a call.  A call that stages in it waits
    for its copies (``download_into``) before it returns, so the next
    call may overwrite it; each thread has its own."""

    def __init__(self):
        self.buf = None

    def take(self, numel: int, device: torch.device) -> torch.Tensor:
        """The first ``numel`` words: of the pinned buffer for the card,
        of a new host tensor for the CPU."""
        if device.type != "cuda":
            return torch.empty(numel, dtype=torch.int32)
        if self.buf is None or self.buf.numel() < numel:
            self.buf = torch.empty(pow2(numel, 1024), dtype=torch.int32,
                                   pin_memory=True)
        return self.buf[:numel]


def download_into(t: torch.Tensor, host: torch.Tensor) -> np.ndarray:
    """A result on the host as a new array: from the card in one copy into
    ``host``, a pinned staging tensor of its shape and type (one DMA, no
    bounce through CUDA's own pinned buffers), then out of it once the
    copy has landed; a CPU tensor as it is."""
    if t.device.type != "cuda":
        return t.numpy()
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy().copy()

"""One fused diffusion-smoother step: the CUDA kernel, its plain version, a count.

``diffusion_step`` is the port of the reference's ``kernels/diffusion.py``
``diffusion_step`` (a Pallas TPU kernel), one step of the diffusion scheme
the paper points to as a scalable replacement for sequential FM: two
liquids injected at the side anchors diffuse along edges and evaporate,

    y = x + dt·(Σ_j w_ij·x_j − deg_i·x_i) − dt·μ·sign(x_i) + inj_i,

in float32, with ``sign(0) = 0`` and ``dt·μ`` formed as a Python product
before it is rounded to float32, as the reference forms it.  On a CUDA
tensor the wrapper launches ``csrc/diffusion.cu`` (one thread a row with
16-byte loads for widths 4-16 when ids and values lie on 16 bytes, as
``ell_spmv`` reads them; a group of threads a row otherwise); on a CPU
tensor it runs ``diffusion_step_plain``.  ``launches`` counts kernel
launches, one per step.  The kernel takes any ``n``: no row padding and no
``block_rows``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: number of times ``diffusion_step`` launched its CUDA kernel
launches = 0


def diffusion_step_plain(nbr: torch.Tensor, val: torch.Tensor,
                         x: torch.Tensor, inj: torch.Tensor,
                         dt: float = 0.25, mu: float = 0.1) -> torch.Tensor:
    """The step in torch, on any device (the kernel's plain version)."""
    mask = nbr >= 0
    xf = x.to(torch.float32)
    wv = torch.where(mask, val.to(torch.float32), 0.0)
    flow = (wv * xf[torch.where(mask, nbr, 0).long()]).sum(1)
    deg = wv.sum(1)
    y = xf + dt * (flow - deg * xf) - dt * mu * torch.sign(xf) \
        + inj.to(torch.float32)
    return y.to(x.dtype)


def _check(nbr, val, x, inj) -> None:
    if nbr.dim() != 2 or val.shape != nbr.shape or \
            x.shape != nbr.shape[:1] or inj.shape != x.shape:
        raise ValueError(f"nbr and val (n, d), x and inj (n,) expected, got "
                         f"{tuple(nbr.shape)}, {tuple(val.shape)}, "
                         f"{tuple(x.shape)} and {tuple(inj.shape)}")
    if nbr.dtype != torch.int32:
        raise TypeError(f"nbr must be int32, got {nbr.dtype}")
    if not val.dtype == x.dtype == inj.dtype == torch.float32:
        raise TypeError("val, x and inj must be float32")
    if not nbr.device == val.device == x.device == inj.device:
        raise ValueError("nbr, val, x and inj must be on one device")


def diffusion_step_kernel(nbr, val, x, inj, dt: float = 0.25,
                          mu: float = 0.1) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (CUDA tensors only)."""
    global launches
    _check(nbr, val, x, inj)
    if nbr.device.type != "cuda":
        raise ValueError("diffusion_step_kernel takes CUDA tensors")
    nbr, val, x, inj = (t.contiguous() for t in (nbr, val, x, inj))
    n, d = nbr.shape
    y = torch.empty_like(x)
    lib = build.load("diffusion")
    stream = torch.cuda.current_stream(nbr.device).cuda_stream
    err = lib.diffusion_launch(nbr.data_ptr(), val.data_ptr(), x.data_ptr(),
                               inj.data_ptr(), y.data_ptr(), n, d,
                               float(dt), float(dt * mu), stream)
    build.check(err, "diffusion")
    launches += 1
    return y


def diffusion_step(nbr: torch.Tensor, val: torch.Tensor, x: torch.Tensor,
                   inj: torch.Tensor, dt: float = 0.25,
                   mu: float = 0.1) -> torch.Tensor:
    """One fused diffusion step on the ELL graph: nbr (n, d) int32 (-1
    pads), val (n, d), x and inj (n,) float32 → the next x.  CUDA tensors
    go to the kernel, CPU tensors to the plain version."""
    _check(nbr, val, x, inj)
    if nbr.device.type == "cuda":
        return diffusion_step_kernel(nbr, val, x, inj, dt, mu)
    return diffusion_step_plain(nbr, val, x, inj, dt, mu)

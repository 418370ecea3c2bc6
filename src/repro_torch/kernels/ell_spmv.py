"""ELL sparse matrix–vector product: the CUDA kernel, its plain version, a count.

``ell_spmv`` is the port of the reference's ``kernels/ell_spmv.py``
``ell_spmv`` (a Pallas TPU kernel): ``y[i] = Σ_j val[i,j]·x[nbr[i,j]]``
over the valid (``nbr >= 0``) slots, summed in float32 and returned in
``x``'s type.  float32 and bfloat16 are supported; in bfloat16 each
product is rounded to bfloat16 before the float32 sum, as the reference
forms ``val * xv`` in the input type.  On a CUDA tensor the wrapper
launches ``csrc/ell_spmv.cu``; on a CPU tensor it runs ``ell_spmv_plain``.
``launches`` counts kernel launches.  The kernel takes any ``n``: no row
padding and no ``block_rows``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: number of times ``ell_spmv`` launched its CUDA kernel
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ell_spmv_plain(nbr: torch.Tensor, val: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """The product in torch, on any device (the kernel's plain version)."""
    mask = nbr >= 0
    xv = x[torch.where(mask, nbr, 0).long()]
    acc = torch.where(mask, val * xv, 0).to(torch.float32).sum(1)
    return acc.to(x.dtype)


def _check(nbr: torch.Tensor, val: torch.Tensor, x: torch.Tensor) -> None:
    if nbr.dim() != 2 or val.shape != nbr.shape or \
            x.shape != nbr.shape[:1]:
        raise ValueError(f"nbr and val (n, d) and x (n,) expected, got "
                         f"{tuple(nbr.shape)}, {tuple(val.shape)} and "
                         f"{tuple(x.shape)}")
    if nbr.dtype != torch.int32:
        raise TypeError(f"nbr must be int32, got {nbr.dtype}")
    if x.dtype not in _DTYPES or val.dtype != x.dtype:
        raise TypeError(f"val and x must share float32 or bfloat16, got "
                        f"{val.dtype} and {x.dtype}")
    if not nbr.device == val.device == x.device:
        raise ValueError("nbr, val and x must be on one device")


def ell_spmv_kernel(nbr: torch.Tensor, val: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (CUDA tensors only)."""
    global launches
    _check(nbr, val, x)
    if nbr.device.type != "cuda":
        raise ValueError("ell_spmv_kernel takes CUDA tensors")
    nbr, val, x = nbr.contiguous(), val.contiguous(), x.contiguous()
    n, d = nbr.shape
    y = torch.empty_like(x)
    lib = build.load("ell_spmv")
    stream = torch.cuda.current_stream(nbr.device).cuda_stream
    err = lib.ell_spmv_launch(nbr.data_ptr(), val.data_ptr(), x.data_ptr(),
                              y.data_ptr(), n, d, _DTYPES[x.dtype], stream)
    build.check(err, "ell_spmv")
    launches += 1
    return y


def ell_spmv(nbr: torch.Tensor, val: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = A·x for the ELL matrix (nbr, val): nbr (n, d) int32 (-1 pads),
    val (n, d) and x (n,) of one type (float32 or bfloat16) → y (n,).
    CUDA tensors go to the kernel, CPU tensors to the plain version."""
    _check(nbr, val, x)
    if nbr.device.type == "cuda":
        return ell_spmv_kernel(nbr, val, x)
    return ell_spmv_plain(nbr, val, x)

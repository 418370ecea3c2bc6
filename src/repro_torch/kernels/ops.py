"""Public entry points over the device kernels (the bucketed dispatch API).

The port of the reference's ``kernels/ops.py``.  ``fm_refine_batch`` is
the one entry the FM executor (``core.fm.execute_fm_works``) dispatches
through; ``REPRO_FM_MODE`` picks its path.  ``spmv`` and ``diffuse``
drive the ELL kernels.  The reference's ``band_bfs_batch``,
``match_batch`` and ``sep_gain_batch`` have no entry here: the port's
callers use ``band_batch.bfs_multi``, ``matching.heavy_edge_matching_multi``
and ``band_batch.sep_gain_multi`` directly.

Every entry takes ``device`` (default: the card, which it raises without
unless the caller asks for ``"cpu"``) and moves its inputs there; on the
card each runs its CUDA kernel, on the CPU the kernel's plain version.

The reference's TPU tiling knobs are gone from the signatures: the CUDA
kernels take any ``n`` unpadded, so there is no ``block_rows``, no
``interpret`` and no row padding (``_pad_rows``).  ``ell_relax_step``
is the distributed BFS's relaxation (``kernels.dgraph_ops``).
"""
from __future__ import annotations

import os

import torch

from repro_torch import obs
from repro_torch.kernels.band_batch import RowExtents
from repro_torch.kernels.dgraph_ops import ell_relax
from repro_torch.kernels.diffusion import diffusion_step
from repro_torch.kernels.ell_spmv import ell_spmv
from repro_torch.kernels.fm_fused import fm_fused_multi, fm_noise
from repro_torch.util import resolve_device

FM_MODES = ("fused", "hoisted", "oracle")


def _on(device, *arrays, dtype=None):
    dev = resolve_device(device)
    return [torch.as_tensor(a, dtype=dtype).to(dev) for a in arrays]


def fm_mode_default() -> str:
    """FM refinement path: REPRO_FM_MODE=fused|hoisted|oracle|auto.

    ``fused`` runs the whole pass loop as one kernel per bucket
    (``kernels.fm_fused``); ``hoisted`` runs the pass loop on the host
    with two kernels per pass, the gains and the move loop
    (``core.fm.fm_refine_multi``); ``oracle`` is the independent per-lane
    reference (``kernels.ref``), plain torch that runs only on the CPU.
    ``auto`` resolves to ``fused``.  All three return the same bits.
    """
    mode = os.environ.get("REPRO_FM_MODE", "auto")
    return "fused" if mode == "auto" else mode


def fm_refine_batch(nbr, lane_work, vwgt, parts, locked, keys, eps_frac,
                    max_moves, n_pert, passes: int = 3,
                    pos_only: bool = False, mode: str | None = None,
                    gain_mode: str | None = None,
                    extents: RowExtents | None = None, device=None):
    """Batched FM refinement over a bucket's lanes (mode-switched).

    Shapes as ``fm_fused_multi``: nbr (W, n, d) int32 tiles with
    lane_work (L,) int32; vwgt (L, n); parts (L, n) int8; locked (L, n)
    bool; keys (L, 2); eps_frac (L,) float32; max_moves, n_pert (L,)
    int32; ``extents``, the tiles' host ``RowExtents``, which the kernels
    of both paths read and which the fused and hoisted modes require
    (``core.fm.pack_fm_bucket`` makes and checks them with the tiles;
    direct callers pass ``band_batch.row_extents(nbr)``).  ``mode``
    defaults to ``fm_mode_default()``; ``gain_mode`` applies only to the
    hoisted path.  Returns (parts int8, sep_w, imb).  Raises
    ``ValueError`` for a mode other than fused, hoisted or oracle, for
    the fused and hoisted modes without extents, and for the oracle on the
    card: it has no kernel, and the card's work never goes to plain
    torch.
    """
    mode = fm_mode_default() if mode is None else mode
    if mode not in FM_MODES:
        raise ValueError(f"REPRO_FM_MODE={mode!r} not in "
                         "fused|hoisted|oracle|auto")
    if mode == "oracle" and resolve_device(device).type == "cuda":
        raise ValueError("REPRO_FM_MODE=oracle is plain torch and runs only "
                         "on the CPU")
    if extents is None and mode != "oracle":
        raise ValueError(f"REPRO_FM_MODE={mode} reads the tiles' row "
                         "extents: pass extents=row_extents(nbr)")
    with obs.span("fm:upload"):
        args = _on(device, nbr, lane_work, vwgt, parts, locked, keys,
                   eps_frac, max_moves, n_pert)
        if mode != "oracle":
            (row_len,) = _on(device, extents.row_len)
            extents = RowExtents(row_len, extents.group)
    if mode == "fused":
        return fm_fused_multi(*args, passes=passes, pos_only=pos_only,
                              extents=extents)
    if mode == "hoisted":
        from repro_torch.core.fm import fm_refine_multi
        return fm_refine_multi(*args, passes=passes, pos_only=pos_only,
                               gain_mode=gain_mode, extents=extents)
    from repro_torch.kernels.ref import fm_fused_ref
    nbr, lane_work, vwgt, parts, locked, keys, eps_frac, max_moves, \
        n_pert = args
    vwgt_f = vwgt.to(torch.float32)
    return fm_fused_ref(nbr.index_select(0, lane_work.long()), vwgt_f,
                        parts, locked, fm_noise(keys, nbr.shape[1], passes),
                        eps_frac.to(torch.float32) * vwgt_f.sum(1),
                        max_moves, n_pert, passes=passes, pos_only=pos_only)


def ell_relax_step(nbr, dist_ext, big, device=None) -> torch.Tensor:
    """One min-plus ELL relaxation: min over valid neighbours of ext + 1.

    ``nbr`` (n, d) compact ids with -1 padding (read as ``big``);
    ``dist_ext`` (m,) is any vector the ids index into — in the
    distributed sweep the halo-extended local+ghost vector.  Lane-stacked
    form: ``nbr`` (L, n, d) with ``dist_ext`` (L, m) relaxes every lane
    against its own vector, and each lane equals its 2-D relaxation bit
    for bit.  Returns int32 (n,) or (L, n).
    """
    (nbr, ext) = _on(device, nbr, dist_ext, dtype=torch.int32)
    if nbr.dim() == 2:
        return ell_relax(nbr[None], ext[None], int(big))[0]
    return ell_relax(nbr, ext, int(big))


def spmv(nbr, val, x, device=None) -> torch.Tensor:
    """ELL SpMV: y (n,) in x's type (float32 or bfloat16)."""
    (nbr,) = _on(device, nbr, dtype=torch.int32)
    val, x = _on(device, val, x)
    return ell_spmv(nbr, val, x)


def diffuse(nbr, val, x, inj, steps: int = 1, dt: float = 0.25,
            mu: float = 0.1, device=None) -> torch.Tensor:
    """Run ``steps`` fused diffusion steps (one launch each) from x."""
    (nbr,) = _on(device, nbr, dtype=torch.int32)
    val, x, inj = _on(device, val, x, inj, dtype=torch.float32)
    for _ in range(steps):
        x = diffusion_step(nbr, val, x, inj, dt=dt, mu=mu)
    return x

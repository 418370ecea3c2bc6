"""The control: the plain reference put in the program's place with one
guarantee of the configuration broken, to show that the check fails it.

``short_matching`` runs the coarsening's matching as
``reference.kernels.match`` with half the rounds of the configuration's
``match_rounds``: coarsening is cheaper and the ordering no longer the
one the configuration states.  A later change could be tempted by that
step; the check has to refuse it.  ``run.py --control short_matching``
runs a cell's window with it; the benchmark's own runs never do.
"""
from __future__ import annotations

import contextlib

from orderbench.reference import kernels as ref

CONTROLS = ("short_matching",)


@contextlib.contextmanager
def installed(name: str):
    if name not in CONTROLS:
        raise ValueError(f"unknown control {name!r}")
    import torch
    from repro_torch.core import coarsen

    def match(nbr, wgt, keys, rounds=8):
        out = ref.match(nbr.cpu().numpy(), wgt.cpu().numpy(),
                        keys.cpu().numpy(), int(rounds) // 2)
        return torch.from_numpy(out).to(nbr.device)

    saved = coarsen.heavy_edge_matching_multi
    coarsen.heavy_edge_matching_multi = match
    try:
        yield
    finally:
        coarsen.heavy_edge_matching_multi = saved

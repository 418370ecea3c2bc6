"""Thin adapters over the router's stage table.

The port of the reference's ``service/batch.py``: ``run_works`` and
``drive_tasks`` serve callers that hold bare host-side work lists or
generators.  Same contract as the router: per-lane results independent
of batch composition, so batched execution is result-identical to
one-at-a-time, with the same bucketed dispatch counts.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.service.router import WaveRouter, execute_wave


def run_works(works: Sequence[object], device=None) -> List[object]:
    """Execute a heterogeneous batch of works on ``device``; results in
    input order (``execute_wave`` rejects unknown kinds)."""
    results, _ = execute_wave(list(works), device=device)
    return results


def drive_tasks(generators: Sequence, device=None) -> List[object]:
    """Drive work-yielding generators through one shared router.

    Each wave gathers the current outstanding work of every live
    generator, executes it bucketed on ``device``, and resumes them.
    Generators finish at different depths; the wave simply shrinks.
    Returns each generator's return value, in order.
    """
    router = WaveRouter(device=device)
    for gen in generators:
        router.submit(gen)
    return router.run()

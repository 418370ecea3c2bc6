"""Router-fed nested dissection over many graphs at once.

The port of the reference's ``service/scheduler.py``.  Every request's
whole ND recursion is ONE work-yielding task tree (``core.nd.nd_task`` —
leaves, component splits and the separator-ordering host steps inline,
subtrees spawned as sibling tasks).  ``core.nd.nested_dissection`` runs
that tree depth-first, one work a kernel call; the scheduler instead
submits all requests' trees to a shared ``service.router.WaveRouter``.  Every router wave gathers the
outstanding matching / BFS / FM work of every live subtree of every
request and executes it bucketed — one kernel call per ELL bucket per
wave, with lanes from different *requests* stacking into the same
launch.  The left/right subgraphs of every dissection are independent
(paper §3.1) — exactly the parallelism the paper spreads over
processes, here spread over the lanes of a batched kernel call.

Work items run the same computation whether batched or not, the helpers
(``leaf_perm`` / ``resolve_separator`` / ``split_by_separator`` /
``separator_perm``) are pure per-subgraph, and ``Ordering.assemble``
sorts fragments by start — so ``order_batch`` returns permutations
identical to looped ``nested_dissection`` calls regardless of wave
composition.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from repro_torch import obs
from repro_torch.core.graph import Graph
from repro_torch.core.nd import NDConfig, nd_task
from repro_torch.core.ordering import Ordering


def _as_list(x, n: int) -> list:
    if isinstance(x, (list, tuple)):
        if len(x) != n:
            raise ValueError(f"expected {n} values, got {len(x)}")
        return list(x)
    return [x] * n


def request_task(g: Graph, seed: int, nproc: int, cfg: NDConfig,
                 ordering: Ordering, hints=None, rec=None,
                 path: str = ""):
    """Root ND task of one host-graph request (the service pump's unit).

    The service admits one of these per request onto its persistent
    ``WaveRouter`` and assembles ``ordering`` once the root completes —
    the same task tree ``order_batch`` builds, exposed so admission can
    be incremental (and warm-started / recorded via ``hints`` / ``rec``).
    """
    return nd_task(g, np.arange(g.n, dtype=np.int64), seed, nproc, cfg,
                   ordering, ordering.root, 0, hints=hints, rec=rec,
                   path=path)


def order_batch(graphs: Sequence[Graph],
                seeds: Union[int, Sequence[int]] = 0,
                nprocs: Union[int, Sequence[int]] = 1,
                cfgs: Union[NDConfig, Sequence[NDConfig], None] = None,
                tags: Union[Sequence, None] = None,
                device=None) -> List[np.ndarray]:
    """Order many graphs through one shared wave router on ``device``.

    Returns one permutation per graph, identical to
    ``[nested_dissection(g, seed, nproc, cfg, device) for ...]``.  The
    works run on the card unless ``device`` names the CPU.  ``tags``
    (optional, one per graph) attribute each request's lanes in the
    router's wave summaries.
    """
    from repro_torch.service.router import WaveRouter
    n_req = len(graphs)
    seeds = _as_list(seeds, n_req)
    nprocs = _as_list(nprocs, n_req)
    cfgs = _as_list(cfgs or NDConfig(), n_req)
    if tags is not None and len(tags) != n_req:
        raise ValueError(f"expected {n_req} tags, got {len(tags)}")
    orderings = [Ordering(g.n) for g in graphs]

    router = WaveRouter(device=device)
    with obs.span("sched:batch", requests=n_req):
        for i, g in enumerate(graphs):
            root = request_task(g, seeds[i], nprocs[i], cfgs[i],
                                orderings[i])
            router.submit(root, tag=i if tags is None else tags[i])
        router.run()

    perms = []
    for g, ordering in zip(graphs, orderings):
        perm = ordering.assemble()
        if not np.array_equal(np.sort(perm), np.arange(g.n)):
            raise AssertionError("order_batch produced no permutation")
        perms.append(perm)
    return perms

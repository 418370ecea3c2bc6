"""Nested dissection driver (paper §3.1) + separator pipeline (§3.2–3.3).

Control plane: host recursion with fold bookkeeping (process counts halve at
every dissection level, as in the paper's fold of induced subgraphs onto
⌈p/2⌉ / ⌊p/2⌋ processes).  Data plane: the matching, band-BFS and FM works,
run on the device the caller names (the card by default).

``nproc`` only drives the *quality-relevant* parallel mechanisms — fold-dup
instance counts and the number of multi-sequential FM/initial-partition
instances — exactly the knobs through which process count affects ordering
quality in the paper (its Tables 2–3 vary nothing else).

The separator pipeline is *stage-separated*: ``separator_task`` is a
generator that runs the host control plane (coarsen → initial separator →
per-level band extract + FM) but **yields** its device work (``MatchWork``
/ ``BFSWork`` / ``FMWork``) instead of dispatching it.  ``nd_task``
wraps it in the whole recursion as one task tree, which yields a node's
separator works and ``_Spawn``s its subtrees.  Two drivers run that one
tree: ``nested_dissection`` here, depth-first with one work a call, and
the service's ``WaveRouter``, which stacks the works of many live
subtrees (of many requests) into the lanes of one kernel call.
"""
from __future__ import annotations

import dataclasses
from typing import Generator, List, Optional, Tuple, Union

import numpy as np

from repro_torch import obs
from repro_torch.core.band import BFSWork, execute_bfs_works, extract_band, \
    project_band
from repro_torch.core.coarsen import MatchWork, coarsen_multilevel_task, \
    execute_match_works
from repro_torch.core.fm import FMWork, execute_fm_works, fm_lane_count, \
    separator_is_valid
from repro_torch.core.graph import Graph
from repro_torch.core.initsep import initial_parts
from repro_torch.core.ordering import Ordering
from repro_torch.sparse.mindeg import min_degree
from repro_torch.util import mix_seeds, resolve_device

Work = Union[BFSWork, FMWork, MatchWork]


@dataclasses.dataclass
class NDConfig:
    leaf_size: int = 96             # switch to minimum degree below this
    coarse_target: int = 120        # coarsest-graph size
    fold_threshold: int = 100       # vertices/process before fold-dup (paper)
    band_width: int = 3             # paper's principled default
    eps_frac: float = 0.12          # balance tolerance
    k_fm_cap: int = 16              # max multi-sequential FM instances
    k_init: int = 8                 # initial-partition tries (per instance)
    fm_passes: int = 3
    use_band: bool = True           # ablation switch (§3.3)
    fold_dup: bool = True           # ablation switch (§3.2)
    seq_threshold: int = 0          # below this n, pretend nproc=1
    # --- ParMETIS-like baseline knobs (paper §3.3's description of [20]) ---
    refine_strict: bool = False     # only strictly-improving moves
    freeze_interface: bool = False  # vertices with remote neighbors frozen


@obs.traced("nd:project")
def _project(part_coarse: np.ndarray, cmap: np.ndarray) -> np.ndarray:
    """Separator projection: coarse separator vertex -> both fine children."""
    return part_coarse[cmap].astype(np.int8)


# ------------------------------------------------------------------ #
# stage-separated separator pipeline
# ------------------------------------------------------------------ #
def valid_warm_part(g: Graph, part) -> Optional[np.ndarray]:
    """Validate a cached split as a warm-start separator for ``g``.

    A part vector recorded from a *different* graph's ordering tree is
    a sound separator here iff it matches ``g``'s vertex count, leaves
    both sides non-empty, and no 0–1 edge crosses it.  Returns the
    validated int8 part or None.
    """
    if part is None or len(part) != g.n:
        return None
    part = np.asarray(part, dtype=np.int8)
    if min(int((part == 0).sum()), int((part == 1).sum())) == 0:
        return None
    src = np.repeat(np.arange(g.n), g.degrees())
    # symmetric CSR: checking 0->1 arcs covers 1->0 too
    if np.any((part[src] == 0) & (part[g.adjncy] == 1)):
        return None
    return part


def separator_task(g: Graph, seed: int, nproc: int, cfg: NDConfig,
                   warm_part: Optional[np.ndarray] = None
                   ) -> Generator[Work, object, Optional[np.ndarray]]:
    """Multilevel + band-FM separator pipeline as a work-yielding generator.

    Yields ``MatchWork`` / ``BFSWork`` / ``FMWork`` items; the driver sends
    back each result (the matching, the dist array, ``(part, sep_w,
    imb)``).  Returns the final part vector, or None when g is too small.
    A ``warm_part`` that validates via ``valid_warm_part`` is returned at
    once; an invalid hint falls through to the full cold pipeline.
    """
    if warm_part is not None:
        cached = valid_warm_part(g, warm_part)
        if cached is not None:
            return cached
    if g.n < 4:
        return None
    state = yield from coarsen_multilevel_task(
        g, seed, nproc=nproc if cfg.fold_dup else 1,
        coarse_target=cfg.coarse_target, fold_threshold=cfg.fold_threshold,
        max_instances=cfg.k_fm_cap)
    coarsest = state.coarsest
    n_inst = state.levels[-1].n_instances
    k_init = min(cfg.k_init * n_inst, 32)

    # initial separator on the coarsest graph (multi-sequential tries)
    parts0 = initial_parts(coarsest, seed, k_tries=k_init)
    nbr_c, _ = coarsest.to_ell()
    part, _, _ = yield FMWork(
        nbr=nbr_c, vwgt=coarsest.vwgt, part=parts0[0],
        locked=np.zeros(coarsest.n, bool), seed=mix_seeds(seed, 0),
        k_inst=k_init, eps_frac=cfg.eps_frac, passes=3, n_pert=4,
        parts_init=parts0)
    assert separator_is_valid(nbr_c, part)

    k_fm = fm_lane_count(nproc, cfg.k_fm_cap, cfg.fold_dup,
                         strict=cfg.refine_strict)
    pos_only = cfg.refine_strict
    n_pert = 0 if pos_only else 8

    # uncoarsen: project, band-extract, multi-sequential FM
    for lvl in range(len(state.levels) - 1, 0, -1):
        cmap = state.levels[lvl].cmap
        fine = state.levels[lvl - 1].graph
        part = _project(part, cmap)
        lvl_seed = mix_seeds(seed, lvl)
        if cfg.use_band:
            nbr_f, _ = fine.to_ell()
            dist = yield BFSWork(nbr=nbr_f, src=part == 2,
                                 width=cfg.band_width)
            band, bpart, locked, old_ids = extract_band(
                fine, part, width=cfg.band_width, dist=dist)
            nbr_b, _ = band.to_ell()
            bpart, _, _ = yield FMWork(
                nbr=nbr_b, vwgt=band.vwgt, part=bpart, locked=locked,
                seed=lvl_seed, k_inst=k_fm, eps_frac=cfg.eps_frac,
                passes=cfg.fm_passes, n_pert=n_pert, pos_only=pos_only)
            assert separator_is_valid(nbr_b, bpart)
            part = project_band(part, bpart, old_ids)
        else:
            locked = np.zeros(fine.n, bool)
            if cfg.freeze_interface and nproc > 1:
                locked |= _interface_frozen(fine, nproc)
            nbr_f, _ = fine.to_ell()
            part, _, _ = yield FMWork(
                nbr=nbr_f, vwgt=fine.vwgt, part=part, locked=locked,
                seed=lvl_seed, k_inst=k_fm, eps_frac=cfg.eps_frac,
                passes=cfg.fm_passes, n_pert=n_pert, pos_only=pos_only)
            assert separator_is_valid(nbr_f, part)
    return part


def execute_work(work: Work, device=None):
    """Synchronous single-work execution (the non-batched driver)."""
    if isinstance(work, FMWork):
        return execute_fm_works([work], device)[0]
    if isinstance(work, MatchWork):
        return execute_match_works([work], device)[0]
    return execute_bfs_works([work], device)[0]


def _interface_frozen(g: Graph, nproc: int) -> np.ndarray:
    """Vertices with neighbors on another process of a block distribution.

    Models the parallel-FM communication constraint the paper attributes to
    ParMETIS [20]: a move whose gain update would need remote coordination
    is not attempted.
    """
    blk = (np.arange(g.n, dtype=np.int64) * nproc) // max(g.n, 1)
    src = np.repeat(np.arange(g.n), g.degrees())
    remote = blk[src] != blk[g.adjncy]
    frozen = np.zeros(g.n, bool)
    frozen[np.unique(src[remote])] = True
    return frozen


def _fallback_separator(g: Graph, seed: int) -> Optional[np.ndarray]:
    from repro_torch.core.mapping import edge_bisect
    half = edge_bisect(g, seed=seed, k_tries=2, passes=2)
    part = half.astype(np.int8)
    src = np.repeat(np.arange(g.n), g.degrees())
    touch = (part[src] == 0) & (part[g.adjncy] == 1)
    part[np.unique(g.adjncy[touch])] = 2
    return part


# ------------------------------------------------------------------ #
# shared ND building blocks
# ------------------------------------------------------------------ #
def leaf_perm(g: Graph, seed: int) -> np.ndarray:
    """Order a leaf subgraph with sequential minimum degree."""
    return min_degree(g, tie_seed=seed)


def separator_perm(gs: Graph, seed: int) -> np.ndarray:
    """Order the separator vertices themselves (highest indices).

    Minimum degree internally (paper couples ND with MD [10]); very large
    separators (circuit-like graphs) would stall the host MD —
    profile-order them instead.
    """
    if gs.n <= 2:
        return np.arange(gs.n, dtype=np.int64)
    if gs.n <= 600:
        return min_degree(gs, tie_seed=seed)
    from repro_torch.core.baselines import rcm
    return rcm(gs)


def resolve_separator(g: Graph, seed: int, part: Optional[np.ndarray],
                      cfg: NDConfig) -> Optional[np.ndarray]:
    """Apply the fallback policy to a (possibly degenerate) separator."""
    if part is None or min((part == 0).sum(), (part == 1).sum()) == 0:
        if g.n > 4 * cfg.leaf_size:
            # separator heuristic failed on a big subgraph: fall back to a
            # balanced edge bisection (boundary -> separator) rather than
            # handing O(n) vertices to sequential minimum degree.
            part = _fallback_separator(g, seed)
        if part is None or min((part == 0).sum(), (part == 1).sum()) == 0:
            return None
    return part


def split_by_separator(g: Graph, part: np.ndarray
                       ) -> Tuple[Tuple[Graph, np.ndarray],
                                  Tuple[Graph, np.ndarray],
                                  Tuple[Graph, np.ndarray]]:
    """Induced subgraphs of the two sides and the separator."""
    return (g.induced_subgraph(part == 0),
            g.induced_subgraph(part == 1),
            g.induced_subgraph(part == 2))


def effective_nproc(n: int, nproc: int, cfg: NDConfig) -> int:
    return 1 if n <= cfg.seq_threshold else nproc


def child_nprocs(nproc: int) -> Tuple[int, int]:
    """Paper §3.1: part 0 onto ⌈p/2⌉ processes, part 1 onto ⌊p/2⌋."""
    return (nproc + 1) // 2, max(nproc // 2, 1)


def child_seeds(seed: int) -> Tuple[int, int]:
    """Seeds of the two dissection children (splitmix over the node path)."""
    return mix_seeds(seed, 1), mix_seeds(seed, 2)


def component_seed(seed: int, c: int) -> int:
    """Seed of the c-th connected component of a node."""
    return mix_seeds(seed, 3 + c)


# ------------------------------------------------------------------ #
# the ND recursion as one task tree, and its sequential driver
# ------------------------------------------------------------------ #
@dataclasses.dataclass
class _Spawn:
    """Yielded by a task to run subtasks; resumed with the list of their
    return values once they have all completed.

    The wave router advances them concurrently — this is how the two
    dissection children of every node, and the components of a
    disconnected graph, join the same wave frontier.
    """
    tasks: List


def nd_task(g: Graph, gids: np.ndarray, seed: int, nproc: int,
            cfg: NDConfig, ordering: Ordering, node, start: int,
            hints=None, rec=None, path: str = ""):
    """One ND tree node as a task: order ``g`` into ``ordering``.

    Leaves and connected-component splits are handled inline on the
    host; separators run through ``separator_task`` (yielding its device
    works to the driver); the two separated halves, or the components,
    spawn as sibling subtasks.  Every node's result is a pure function
    of its subgraph and seed, and ``Ordering.assemble`` sorts fragments
    by start, so any driver that runs every work and every spawned task
    builds the same permutation.

    ``hints`` / ``rec`` thread the warm-start surface through the
    recursion: ``path`` names this node in the ND tree (root ``""``,
    dissection children ``.0``/``.1``, components ``.c<k>``); a hint at
    this path short-circuits the separator pipeline through
    ``separator_task(warm_part=...)`` (re-validated on ``g``, so stale
    hints fall back cold per node), and ``rec`` records every *resolved*
    split so a completed tree can seed later structurally identical
    requests.
    """
    if g.n <= cfg.leaf_size:
        ordering.add_leaf(node, start, gids[leaf_perm(g, seed)])
        return
    comp = g.components()
    ncomp = int(comp.max()) + 1
    if ncomp > 1:                       # independent parts: no separator
        subs = []
        off = start
        for c in range(ncomp):
            sub, old = g.induced_subgraph(comp == c)
            child = ordering.add_internal(node, off, sub.n)
            subs.append(nd_task(sub, gids[old], component_seed(seed, c),
                                nproc, cfg, ordering, child, off,
                                hints, rec, f"{path}.c{c}"))
            off += sub.n
        yield _Spawn(subs)
        return
    part = yield from separator_task(
        g, seed, effective_nproc(g.n, nproc, cfg), cfg,
        warm_part=None if hints is None else hints.get(path))
    part = resolve_separator(g, seed, part, cfg)
    if part is None:                    # could not split
        ordering.add_leaf(node, start, gids[leaf_perm(g, seed)])
        return
    if rec is not None:
        rec[path] = part
    (g0, old0), (g1, old1), (gs, olds) = split_by_separator(g, part)
    p0, p1 = child_nprocs(nproc)
    s0, s1 = child_seeds(seed)
    c0 = ordering.add_internal(node, start, g0.n)
    c1 = ordering.add_internal(node, start + g0.n, g1.n)
    # separator ordered last (highest indices)
    sperm = separator_perm(gs, seed)
    ordering.add_leaf(node, start + g0.n + g1.n, gids[olds[sperm]], "sep")
    yield _Spawn([
        nd_task(g0, gids[old0], s0, p0, cfg, ordering, c0, start,
                hints, rec, path + ".0"),
        nd_task(g1, gids[old1], s1, p1, cfg, ordering, c1, start + g0.n,
                hints, rec, path + ".1"),
    ])


def _run_depth_first(task, device):
    """Run one task tree to its end and return its value: each work
    alone, each spawned subtask to its end before the next."""
    try:
        item = next(task)
        while True:
            if isinstance(item, _Spawn):
                item = task.send([_run_depth_first(sub, device)
                                  for sub in item.tasks])
            else:
                item = task.send(execute_work(item, device))
    except StopIteration as stop:
        return stop.value


def compute_separator(g: Graph, seed: int, nproc: int, cfg: NDConfig,
                      device=None) -> Optional[np.ndarray]:
    """Multilevel + band-FM vertex separator of g.  Returns part or None.

    Drives ``separator_task`` one work at a time (``execute_work``) on
    ``device`` (default: the card); the ordering service drives the same
    generator with bucketed batch execution instead.
    """
    return _run_depth_first(separator_task(g, seed, nproc, cfg),
                            resolve_device(device))


def nested_dissection(g: Graph, seed: int = 0, nproc: int = 1,
                      cfg: Optional[NDConfig] = None, device=None
                      ) -> np.ndarray:
    """Full ordering.  Returns perm (perm[k] = vertex eliminated k-th).

    Runs ``nd_task``'s tree depth-first, one work a kernel call, on
    ``device`` (default: the card; raises if there is none and the
    caller did not ask for ``"cpu"``).  Each work's stage seconds reach
    ``obs.instrument`` through the executors' dispatches.
    """
    dev = resolve_device(device)
    cfg = cfg or NDConfig()
    ordering = Ordering(g.n)
    _run_depth_first(nd_task(g, np.arange(g.n, dtype=np.int64), seed,
                             nproc, cfg, ordering, ordering.root, 0), dev)
    perm = ordering.assemble()
    if not np.array_equal(np.sort(perm), np.arange(g.n)):
        raise AssertionError("nested dissection produced no permutation")
    return perm

"""The port's ordering service on the CPU: bucketed parity, fingerprints,
cache, ``order_batch`` and the service end to end.

Ports of the host cases of ``tests/test_service.py``, plus the port held
to the reference: its fingerprints equal the reference's, and its
``order_batch`` returns the reference's ``nested_dissection``
permutation (the SLO and concurrency cases are in
``test_torch_service_slo.py``).  The tolerance is exact everywhere:
integer-valued weights and a bit-identical PRNG leave no room for
rounding.  Every entry runs with ``device="cpu"``, where the kernels'
plain versions run.
"""
import os
import time

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import torch  # noqa: E402

from repro.core.band import bfs_distance as jax_bfs_distance  # noqa: E402
from repro.core.nd import NDConfig as JaxNDConfig  # noqa: E402
from repro.core.nd import nested_dissection as jax_nd  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.service import fingerprint as jax_fp  # noqa: E402
from repro_torch.convert import graph_from_arrays  # noqa: E402
from repro_torch.core.band import BFSWork, bfs_distance, \
    execute_bfs_works  # noqa: E402
from repro_torch.core.fm import FMWork, execute_fm_works, \
    refine_parts  # noqa: E402
from repro_torch.core.initsep import grow_part  # noqa: E402
from repro_torch.core.nd import NDConfig, nested_dissection  # noqa: E402
from repro_torch.graphs import generators as G  # noqa: E402
from repro_torch.obs.instrument import instrument  # noqa: E402
from repro_torch.service import OrderingService, order_batch  # noqa: E402
from repro_torch.service.cache import FingerprintCache  # noqa: E402
from repro_torch.service.fingerprint import graph_fingerprint, \
    request_fingerprint, structural_fingerprint  # noqa: E402

CPU = "cpu"


def _nd(g, seed=0, nproc=1):
    return nested_dissection(g, seed=seed, nproc=nproc, device=CPU)


def _sep_work(g, seed):
    """A valid FM work: grown initial separator on g."""
    part = grow_part(g, seed)
    nbr, _ = g.to_ell()
    return FMWork(nbr=nbr, vwgt=g.vwgt, part=part,
                  locked=np.zeros(g.n, bool), seed=seed, k_inst=4)


MIXED = [lambda m: m.grid2d(12, 12), lambda m: m.grid3d(6, 6, 6),
         lambda m: m.grid2d(15, 10), lambda m: m.circuit(300, seed=3),
         lambda m: m.grid2d(13, 11), lambda m: m.rgg2d(250, seed=2),
         lambda m: m.grid3d(5, 5, 6), lambda m: m.grid2d(11, 14)]


@pytest.fixture(scope="module")
def mixed_graphs():
    """The reference's ``mixed_graphs`` (≤ 300 vertices), port graphs."""
    return [make(G) for make in MIXED]


# ------------------------------------------------------------------ #
# bucketed executors == singleton execution
# ------------------------------------------------------------------ #
def test_fm_bucketed_matches_singleton():
    works = [_sep_work(G.grid2d(11, 11), 0),
             _sep_work(G.grid2d(10, 12), 1),       # same bucket as above
             _sep_work(G.grid3d(5, 5, 5), 2),
             _sep_work(G.circuit(100, seed=4), 3)]
    together = execute_fm_works(works, CPU)
    alone = [execute_fm_works([w], CPU)[0] for w in works]
    for (pa, wa, ia), (pb, wb, ib) in zip(together, alone):
        assert np.array_equal(pa, pb)
        assert wa == wb and ia == ib


def test_refine_parts_unchanged_contract():
    g = G.grid2d(12, 12)
    part = grow_part(g, 5)
    nbr, _ = g.to_ell()
    out, sep_w, imb = refine_parts(nbr, g.vwgt, part,
                                   np.zeros(g.n, bool), 7, device=CPU)
    assert out.shape == (g.n,)
    assert sep_w == g.vwgt[out == 2].sum()


def test_bfs_bucketed_matches_singleton():
    gs = [G.grid2d(9, 9), G.grid2d(8, 10), G.grid3d(4, 4, 5)]
    works = []
    for i, g in enumerate(gs):
        nbr, _ = g.to_ell()
        src = np.zeros(g.n, bool)
        src[i] = True
        works.append(BFSWork(nbr=nbr, src=src, width=3))
    batched = execute_bfs_works(works, CPU)
    for w, dist in zip(works, batched):
        ref = bfs_distance(w.nbr, w.src, w.width).numpy()
        assert np.array_equal(np.minimum(dist, w.width + 1),
                              np.minimum(ref, w.width + 1))


@pytest.mark.parametrize("width", [0, 1, 3, 5])
def test_bfs_distance_equals_reference(width):
    import jax.numpy as jnp
    rng = np.random.default_rng(width)
    n, d = 300, 7
    nbr = rng.integers(-1, n, (n, d)).astype(np.int32)
    src = rng.random(n) < 0.03
    want = np.asarray(jax_bfs_distance(jnp.asarray(nbr), jnp.asarray(src),
                                       width))
    assert np.array_equal(bfs_distance(nbr, src, width).numpy(), want)


# ------------------------------------------------------------------ #
# fingerprints + cache
# ------------------------------------------------------------------ #
def test_fingerprint_sensitivity():
    g = G.grid2d(6, 6)
    g2 = G.grid2d(6, 6)
    assert graph_fingerprint(g) == graph_fingerprint(g2)
    cfg = NDConfig()
    fp = request_fingerprint(g, 0, 4, cfg)
    assert request_fingerprint(g, 1, 4, cfg) != fp         # seed
    assert request_fingerprint(g, 0, 8, cfg) != fp         # nproc
    assert request_fingerprint(g, 0, 4, NDConfig(band_width=2)) != fp
    g3 = G.grid2d(6, 6)
    g3.vwgt = g3.vwgt.copy()
    g3.vwgt[0] = 7
    assert graph_fingerprint(g3) != graph_fingerprint(g)   # weights
    assert structural_fingerprint(g3) == structural_fingerprint(g)


@pytest.mark.parametrize("k", range(len(MIXED)))
def test_fingerprints_equal_reference(k):
    """Same graph (weights drawn from a numpy seed) and equal ``NDConfig``
    fields: the port's three fingerprints are the reference's."""
    jg = MIXED[k](jgen)
    rng = np.random.default_rng(k)
    jg.vwgt = rng.integers(1, 5, jg.n).astype(jg.vwgt.dtype)
    g = graph_from_arrays(jg.xadj, jg.adjncy, jg.vwgt, jg.adjwgt)
    assert graph_fingerprint(g) == jax_fp.graph_fingerprint(jg)
    assert structural_fingerprint(g) == jax_fp.structural_fingerprint(jg)
    fields = dict(band_width=2 + k % 2, fm_passes=3 + k % 3,
                  use_band=bool(k % 2))
    assert (request_fingerprint(g, k, 4, NDConfig(**fields))
            == jax_fp.request_fingerprint(jg, k, 4, JaxNDConfig(**fields)))


def test_cache_put_does_not_freeze_caller():
    c = FingerprintCache(capacity=4)
    mine = np.arange(6)
    c.put("k", mine)
    assert mine.flags.writeable, "caller's array was frozen by the cache"
    mine[0] = 99                                  # must not raise
    got = c.get("k")
    assert got[0] == 0, "cache entry aliases the caller's array"
    assert not got.flags.writeable                # cached copy stays frozen


def test_cache_lru_and_counters():
    c = FingerprintCache(capacity=2)
    c.put("a", np.arange(3))
    c.put("b", np.arange(4))
    assert c.get("a") is not None                          # a now MRU
    c.put("c", np.arange(5))                               # evicts b
    assert c.get("b") is None
    assert c.get("a") is not None and c.get("c") is not None
    assert c.evictions == 1 and c.hits == 3 and c.misses == 1
    assert 0 < c.hit_rate < 1


# ------------------------------------------------------------------ #
# end to end: scheduler and service vs the looped driver
# ------------------------------------------------------------------ #
def test_entry_points_default_to_the_card():
    g = G.grid2d(4, 4)
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    with pytest.raises(RuntimeError):
        order_batch([g])
    with pytest.raises(RuntimeError):
        OrderingService()


def test_order_batch_matches_sequential(mixed_graphs):
    seeds = list(range(len(mixed_graphs)))
    with instrument() as ins:
        batched = order_batch(mixed_graphs, seeds, 4, device=CPU)
    for g, s, perm in zip(mixed_graphs, seeds, batched):
        assert np.array_equal(perm, _nd(g, s, 4))
    assert ins.waves and all(
        w["launches"][k] == w["buckets"][k] for w in ins.waves
        for k in w["launches"])


REF_CASES = (0, 3, 5, 6)        # grid2d, circuit, rgg2d, grid3d


@pytest.fixture(scope="module")
def batch_for_reference():
    """One ``order_batch`` over the reference cases together, nproc 4."""
    graphs = [MIXED[k](G) for k in REF_CASES]
    return dict(zip(REF_CASES, order_batch(graphs, list(REF_CASES), 4,
                                           device=CPU)))


@pytest.mark.parametrize("k", REF_CASES)
def test_order_batch_equals_reference(batch_for_reference, k):
    """The port's ``order_batch`` (several requests sharing waves) gives
    the reference's ``nested_dissection`` permutation, bit for bit."""
    want = jax_nd(MIXED[k](jgen), seed=k, nproc=4)
    assert np.array_equal(batch_for_reference[k], want)


def test_service_end_to_end(mixed_graphs):
    svc = OrderingService(cache_capacity=64, device=CPU)
    reqs = []
    for rep in range(2):
        for i, g in enumerate(mixed_graphs):
            reqs.append(svc.submit(g, seed=i, nproc=4))
    assert len(reqs) == 16
    assert svc.poll(reqs[0]) is None                       # still queued
    resolved = svc.drain()
    assert len(resolved) == 16
    st = svc.stats()
    assert st["computed"] == 8                             # dedup coalesced
    refs = [_nd(g, s, 4) for s, g in enumerate(mixed_graphs)]
    for i, rid in enumerate(reqs):
        assert np.array_equal(svc.poll(rid).perm, refs[i % 8])
    rid = svc.submit(mixed_graphs[0], seed=0, nproc=4)
    res = svc.poll(rid)
    assert res is not None and res.cached
    st = svc.stats()
    assert st["cache_hits"] >= 1
    assert st["p95_latency_ms"] >= st["p50_latency_ms"]
    assert st["orderings_per_sec"] > 0
    assert st["queue_depth"] == 0


def test_latency_split_queue_wait_vs_exec(mixed_graphs):
    """Queue wait and execution are reported apart.  Each request's
    ``exec_s`` is its own share of the waves it rode, so the reference's
    stale equality of two requests' ``exec_s`` is not ported."""
    svc = OrderingService(device=CPU)
    rid0 = svc.submit(mixed_graphs[0], seed=0, nproc=2)
    time.sleep(0.05)                    # measurable queue wait
    rid1 = svc.submit(mixed_graphs[1], seed=1, nproc=2)
    svc.drain()
    for rid in (rid0, rid1):
        res = svc.poll(rid)
        assert res.queue_wait_s >= 0 and res.exec_s > 0
        assert res.latency_s >= res.queue_wait_s
        assert res.latency_s >= res.exec_s
    assert svc.poll(rid0).queue_wait_s >= 0.05
    rid2 = svc.submit(mixed_graphs[0], seed=0, nproc=2)
    res2 = svc.poll(rid2)
    assert res2.cached and res2.queue_wait_s == 0.0
    st = svc.stats()
    for key in ("p50_queue_wait_ms", "p95_queue_wait_ms",
                "p50_exec_ms", "p95_exec_ms"):
        assert key in st and st[key] >= 0
    assert st["p95_queue_wait_ms"] >= st["p50_queue_wait_ms"]
    assert st["p95_exec_ms"] >= st["p50_exec_ms"]


def test_service_deterministic_across_drains(mixed_graphs):
    g = mixed_graphs[1]
    svc1 = OrderingService(device=CPU)
    svc2 = OrderingService(device=CPU)
    r1 = svc1.submit(g, seed=9, nproc=2)
    r2 = svc2.submit(g, seed=9, nproc=2)
    svc1.drain()
    svc2.drain()
    assert np.array_equal(svc1.poll(r1).perm, svc2.poll(r2).perm)

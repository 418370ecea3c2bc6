"""The port's distributed graph structure against the reference, on the CPU.

In process, against the reference's host functions (none of them needs a
device mesh): ``distribute``, the structure rebuilds (``dgraph_induced``,
``dgraph_fold``, ``dgraph_coarsen``, ``coarsen.coarse_vtxdist``), the
owner-routed vector moves, the boundary mask and the gid coloring, the
fingerprints, and the protocol hashes (``hash_mix`` / ``hash_unit``
against ``repro.core.matching``'s, ``np_hash_mix``) on values at and
above 2^24 and 2^31.  The tolerance is exact everywhere: every array is
integer, and ``hash_unit`` rounds one integer to float32 the same way in
both packages.
"""
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import coarsen as jcoarsen  # noqa: E402
from repro.core import dgraph as J  # noqa: E402
from repro.core import matching as jmatching  # noqa: E402
from repro.core.dnd import DNDConfig as JDNDConfig  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.service import fingerprint as jfp  # noqa: E402
from repro_torch.convert import dgraph_from_arrays, \
    graph_from_arrays  # noqa: E402
from repro_torch.core import coarsen, matching  # noqa: E402
from repro_torch.core import dgraph as T  # noqa: E402
from repro_torch.core.dnd import DNDConfig  # noqa: E402
from repro_torch.service import fingerprint as fp  # noqa: E402

FIELDS = ("vtxdist", "nbr_gst", "ewgt_gst", "ghost_gid", "n_loc",
          "n_ghost", "vwgt")
GRAPHS = {
    "grid2d_13x11_w": lambda m: _weighted(m.grid2d(13, 11)),
    "grid3d_6x5x4": lambda m: m.grid3d(6, 5, 4),
    "rgg2d_150": lambda m: m.rgg2d(150, seed=1),
    "circuit_200": lambda m: m.circuit(200, seed=2),
}


def _weighted(g):
    g.vwgt = (1 + np.arange(g.n) % 3).astype(np.int64)
    return g


def _pair(name):
    jg = GRAPHS[name](jgen)
    return jg, graph_from_arrays(jg.xadj, jg.adjncy, jg.vwgt, jg.adjwgt)


def _same(jdg, dg):
    for f in FIELDS:
        a, b = getattr(jdg, f), getattr(dg, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _port(jdg):
    return dgraph_from_arrays(*(getattr(jdg, f) for f in FIELDS))


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_distribute_equals_reference(name, P, bucket):
    jg, g = _pair(name)
    _same(J.distribute(jg, P, bucket=bucket), T.distribute(g, P,
                                                           bucket=bucket))
    assert T.dgraph_bucket(T.distribute(g, P)) == \
        J.dgraph_bucket(J.distribute(jg, P))


def test_distribute_custom_ranges_and_empty_parts():
    jg, g = _pair("grid2d_13x11_w")
    vtx = np.array([0, 40, 40, 100, 143])          # part 1 is empty
    _same(J.distribute(jg, 4, vtxdist=vtx), T.distribute(g, 4, vtxdist=vtx))


@pytest.mark.parametrize("nparts", [None, 1, 2, 5])
@pytest.mark.parametrize("name", ["grid2d_13x11_w", "rgg2d_150"])
def test_dgraph_induced_equals_reference(name, nparts):
    jg, _ = _pair(name)
    jdg = J.distribute(jg, 4)
    dg = _port(jdg)
    rng = np.random.default_rng(0)
    keep = rng.random(jdg.nbr_gst.shape[:2]) < 0.6
    pay = (J.shard_gids(jdg), rng.integers(0, 3, keep.shape).astype(np.int8))
    jsub, jmapped = J.dgraph_induced(jdg, keep, nparts=nparts,
                                     payloads=pay, fills=(-1, 3))
    sub, mapped = T.dgraph_induced(dg, keep, nparts=nparts, payloads=pay,
                                   fills=(-1, 3))
    _same(jsub, sub)
    for a, b in zip(jmapped, mapped):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("P", [4, 5, 8])
def test_dgraph_fold_equals_reference(P):
    jg, _ = _pair("grid2d_13x11_w")
    jdg = J.distribute(jg, P)
    _same(J.dgraph_fold(jdg), T.dgraph_fold(_port(jdg)))
    # a fold of a layout with empty parts keeps repeated vtxdist entries
    keep = J.shard_gids(jdg) < 30
    jsub, _ = J.dgraph_induced(jdg, keep)
    sub, _ = T.dgraph_induced(_port(jdg), keep)
    _same(J.dgraph_fold(jsub), T.dgraph_fold(sub))
    assert len(set(T.dgraph_fold(sub).vtxdist)) < len(sub.vtxdist) // 2 + 1


@pytest.mark.parametrize("P", [3, 4])
def test_dgraph_coarsen_and_coarse_vtxdist_equal_reference(P):
    jg, g = _pair("grid2d_13x11_w")
    rng = np.random.default_rng(3)
    m = np.arange(g.n)
    pairs = rng.permutation(g.n)
    for i in range(0, g.n - 1, 2):
        a, b = pairs[i], pairs[i + 1]
        m[a], m[b] = b, a
    jdg = J.distribute(jg, P)
    dg = _port(jdg)
    msh = J.shard_vector(jdg, m, fill=-1)
    jc, jcmap = J.dgraph_coarsen(jdg, msh)
    c, cmap = T.dgraph_coarsen(dg, msh)
    _same(jc, c)
    assert np.array_equal(jcmap, cmap)
    assert np.array_equal(coarsen.coarse_vtxdist(dg.vtxdist, m),
                          jcoarsen.coarse_vtxdist(jdg.vtxdist, m))


def test_vector_moves_equal_reference():
    jg, _ = _pair("rgg2d_150")
    jdg, jdf = J.distribute(jg, 5), J.dgraph_fold(J.distribute(jg, 5))
    dg, df = _port(jdg), _port(jdf)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 50, jg.n)
    for f in ("shard_gids", "valid_mask", "boundary_mask"):
        assert np.array_equal(getattr(J, f)(jdg), getattr(T, f)(dg)), f
    xs = J.shard_vector(jdg, x, fill=-7)
    assert np.array_equal(xs, T.shard_vector(dg, x, fill=-7))
    assert np.array_equal(J.unshard_vector(jdg, xs),
                          T.unshard_vector(dg, xs))
    gid = rng.integers(-3, jg.n + 3, (4, 9))
    assert np.array_equal(J.pull_by_gid(jdg, xs, gid, fill=-1),
                          T.pull_by_gid(dg, xs, gid, fill=-1))
    vals = rng.integers(0, 9, gid.size)
    assert np.array_equal(J.scatter_by_gid(jdg, xs, gid, vals),
                          T.scatter_by_gid(dg, xs, gid, vals))
    assert np.array_equal(J.reshard_vector(jdg, jdf, xs, fill=3),
                          T.reshard_vector(dg, df, xs, fill=3))
    assert np.array_equal(J.dgraph_arcs(jdg), T.dgraph_arcs(dg))
    h, hp = J.to_host(jdg), T.to_host(dg)
    for f in ("xadj", "adjncy", "vwgt", "adjwgt"):
        assert np.array_equal(getattr(h, f), getattr(hp, f))


@pytest.mark.parametrize("salt", [0, 3, 2 ** 31 - 1, 2 ** 40 + 5])
def test_color_by_gid_equals_reference(salt):
    jg, _ = _pair("grid2d_13x11_w")
    jdg = J.distribute(jg, 4)
    want = J.color_by_gid(jdg, salt=salt, exchange=False)
    got = T.color_by_gid(_port(jdg), salt=salt, exchange=False)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the exchanged ghost colors agree with the gid hash, on the CPU
    T.color_by_gid(_port(jdg), salt=salt, exchange=True, device="cpu")


def test_gathers_are_tracked():
    jg, _ = _pair("grid2d_13x11_w")
    dg = _port(J.distribute(jg, 4))
    with T.instrument() as outer:
        with T.track_gathers() as log:
            T.to_host(dg)
            T.unshard_vector(dg, dg.vwgt)
    assert log == [("to_host", jg.n), ("unshard_vector", jg.n)]
    assert outer.gathers == log
    with T.instrument() as ins:
        T.distribute(T.to_host(dg), 3)
    assert ins.stage_s.get("rebuild", 0.0) > 0.0


HASH_VALUES = np.array([-1, 0, 1, 2 ** 24 - 1, 2 ** 24, 2 ** 24 + 1,
                        2 ** 24 + 3, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 7,
                        2 ** 32 - 1, 123456789, 987654321], np.int64)


@pytest.mark.parametrize("salt", [0, 17, 31, 2 ** 31 - 1])
def test_hashes_equal_reference(salt):
    x = HASH_VALUES
    y = x[::-1].copy()
    jx, jy = (jnp.asarray(a.astype(np.uint32)) for a in (x, y))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert np.array_equal(
        np.asarray(jmatching.hash_u32(jx)).astype(np.int64),
        matching.hash_u32(tx).numpy())
    assert np.array_equal(
        np.asarray(jmatching.hash_mix(jx, jy, salt)).astype(np.int64),
        matching.hash_mix(tx, ty, salt).numpy())
    want = np.asarray(jmatching.hash_unit(jx, jy, salt))
    got = matching.hash_unit(tx, ty, salt).numpy()
    assert got.dtype == np.float32 and np.array_equal(want, got)
    assert np.all((got >= 0) & (got <= 1))
    assert np.array_equal(J.np_hash_mix(x, salt, 5),
                          T.np_hash_mix(x, salt, 5))


def test_fingerprints_equal_reference():
    jg, _ = _pair("grid2d_13x11_w")
    jdg = J.distribute(jg, 4)
    dg = _port(jdg)
    assert fp.dgraph_structural_fingerprint(dg) == \
        jfp.dgraph_structural_fingerprint(jdg)
    for seed, kw in ((0, {}), (3, {"centralize_threshold": 64})):
        assert fp.dgraph_fingerprint(dg, seed, DNDConfig(**kw)) == \
            jfp.dgraph_fingerprint(jdg, seed, JDNDConfig(**kw))
    assert fp.dgraph_fingerprint(dg, 0, DNDConfig()) != \
        fp.dgraph_fingerprint(dg, 1, DNDConfig())


def test_match_proposal_cap_equals_reference():
    dgs = [J.distribute(jgen.grid2d(13, 11), 4),
           J.distribute(jgen.grid2d(12, 12), 4)]
    nlm = dgs[0].n_loc_max
    assert T._match_proposal_cap([_port(d) for d in dgs], nlm) == \
        J._match_proposal_cap(dgs, nlm)
    x = np.arange(4 * nlm).reshape(4, nlm).astype(np.int32)
    assert np.array_equal(T.halo_reference(_port(dgs[0]), x),
                          J.halo_reference(dgs[0], x))

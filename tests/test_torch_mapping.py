"""The port's static mapping, configs and FLOP counter held to the
reference's on the CPU, and the LM-side examples run there.

* ``static_map``, ``traffic_cost`` and ``expert_placement``
  (``repro_torch.core.mapping``) bit for bit the reference's on the cases
  of ``tests/test_mapping_dgraph.py`` and on arctic-480b's 128 experts
  over 2 pods × 8 chips: host numpy on both sides, so exactly;
* every ``ArchConfig`` equal to the reference's field by field, with its
  parameter counts and ``reduced()``;
* ``flopcount.forward_flops`` / ``cell_flops`` equal for every
  architecture and shape;
* the ``expert_placement`` and ``serve_lm`` examples (reduced) on the CPU.
"""
import dataclasses
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro import flopcount as jax_flops  # noqa: E402
from repro.configs import base as jax_base  # noqa: E402
from repro.core import mapping as jax_mapping  # noqa: E402
from repro.core.graph import Graph as JaxGraph  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch import flopcount  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.convert import graph_from_arrays  # noqa: E402
from repro_torch.core import mapping  # noqa: E402
from repro_torch.core.graph import Graph  # noqa: E402
from repro_torch.examples import expert_placement, serve_lm  # noqa: E402


def port_graph(g):
    return graph_from_arrays(g.xadj, g.adjncy, g.vwgt, g.adjwgt)


def coactivation_graphs(co):
    """The task graph ``expert_placement`` builds, on both sides."""
    iu, ju = np.nonzero(np.triu(co, 1))
    w = co[iu, ju]
    ew = np.maximum((w / max(w.max(), 1e-9) * 1000).astype(np.int64), 1)
    edges = np.stack([iu, ju], 1)
    return (JaxGraph.from_edges(co.shape[0], edges, ewgt=ew),
            Graph.from_edges(co.shape[0], edges, ewgt=ew))


def clustered(E, seed):
    """``test_expert_placement_beats_random``'s co-activation: 4 hot
    cliques over a light background."""
    rng = np.random.default_rng(seed)
    co = rng.random((E, E)) * 0.05
    for blk in range(4):
        idx = np.arange(blk * E // 4, (blk + 1) * E // 4)
        co[np.ix_(idx, idx)] += 1.0
    return (co + co.T) / 2


def tiers(mod, pods, chips, inter=10.0):
    return [mod.DeviceTier(pods, inter), mod.DeviceTier(chips, 1.0)]


@pytest.mark.parametrize("case", ["grid2d_16", "grid2d_12", "circuit"])
def test_static_map_and_traffic_cost_equal_reference(case):
    jg = {"grid2d_16": lambda: jgen.grid2d(16, 16),
          "grid2d_12": lambda: jgen.grid2d(12, 12),
          "circuit": lambda: jgen.circuit(300, seed=3)}[case]()
    g = port_graph(jg)
    for seed in (0, 1):
        want = jax_mapping.static_map(jg, tiers(jax_mapping, 2, 4), seed)
        got = mapping.static_map(g, tiers(mapping, 2, 4), seed)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert mapping.traffic_cost(g, got, tiers(mapping, 2, 4)) == \
            jax_mapping.traffic_cost(jg, want, tiers(jax_mapping, 2, 4))
    assert set(np.unique(got)) == set(range(8))
    if case == "grid2d_16":         # the reference test's balance check
        counts = np.bincount(got, minlength=8)
        assert counts.min() >= 0.5 * counts.max()
    half = mapping.edge_bisect(g, seed=0)
    assert np.array_equal(half, jax_mapping.edge_bisect(jg, seed=0))
    assert mapping.cut_weight(g, half) == jax_mapping.cut_weight(jg, half)


@pytest.mark.parametrize("E,pods,chips", [(32, 2, 4), (128, 2, 8)])
def test_expert_placement_equals_reference(E, pods, chips):
    co = clustered(E, seed=0)
    want = jax_mapping.expert_placement(co, pods, chips, 10.0, seed=0)
    got = mapping.expert_placement(co, pods, chips, 10.0, seed=0)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    jg, g = coactivation_graphs(co)
    cost = mapping.traffic_cost(g, got, tiers(mapping, pods, chips))
    assert cost == jax_mapping.traffic_cost(
        jg, want, tiers(jax_mapping, pods, chips))
    rand = [mapping.traffic_cost(
        g, np.random.default_rng(s).integers(0, pods * chips, E),
        tiers(mapping, pods, chips)) for s in range(5)]
    assert cost < 0.7 * np.mean(rand)


def test_expert_placement_example_equals_reference_mapping():
    out = expert_placement.main(["--arch", "arctic-480b"])
    cfg = base.get_config("arctic-480b")
    assert cfg.n_experts == 128 and out["assign"].shape == (128,)
    co = expert_placement.synth_coactivation(128, n_clusters=4)
    want = jax_mapping.expert_placement(co, 2, 8, 10.0, seed=0)
    assert np.array_equal(out["assign"], want)
    assert out["scotch"] < out["random"] and out["scotch"] < \
        out["round_robin"]


@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_config_equals_reference(arch):
    got, want = base.get_config(arch), jax_base.get_config(arch)
    assert type(got).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    for c, w in ((got, want), (got.reduced(), want.reduced())):
        assert c.param_count() == w.param_count()
        assert c.active_param_count() == w.active_param_count()
        assert c.layer_kinds() == w.layer_kinds()
        assert c.layer_ffn() == w.layer_ffn()
        assert c.hd == w.hd
    for shape in base.SHAPES:
        assert base.cell_is_runnable(arch, shape) == \
            jax_base.cell_is_runnable(arch, shape)
        for remat in ("full", "dots"):
            assert flopcount.cell_flops(got, shape, remat) == \
                jax_flops.cell_flops(want, shape, remat)
    for T, kv in ((512, 128), (4, 160), (1, 1)):
        assert flopcount.forward_flops(got, T, kv) == \
            jax_flops.forward_flops(want, T, kv)


def test_registry_equals_reference():
    assert base.ARCH_IDS == jax_base.ARCH_IDS
    assert base.SHAPES == jax_base.SHAPES
    assert base.SUBQUADRATIC == jax_base.SUBQUADRATIC
    with pytest.raises(KeyError):
        base.get_config("gpt-2")


def test_serve_lm_example_on_cpu():
    out = serve_lm.main(["--device", "cpu", "--batch", "2",
                         "--prompt-len", "8", "--new-tokens", "4"])
    toks = out["tokens"]
    assert toks.shape == (2, 4)
    assert ((toks >= 0) & (toks < base.get_config("yi-6b").reduced()
                                 .vocab)).all()

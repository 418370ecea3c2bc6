"""The paper's headline claims, on the port alone, on the CPU.

A port of ``tests/test_system.py`` at the reference's sizes, through the
port's public API (``core.baselines``) with ``device="cpu"``:
  1. quality does not degrade as the (simulated) process count grows;
  2. the ParMETIS-like baseline degrades with process count and is beaten;
  3. orderings are deterministic for a fixed seed (paper §4);
  4. OPC scales like the theory for nested dissection on 3D meshes.
One case is also held to the reference exactly: ``parmetis_like`` on
``grid3d(9, 9, 9)`` at nproc 8 returns the reference's permutation.
"""
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.core.baselines import parmetis_like as jax_parmetis  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core.baselines import parmetis_like, pt_scotch_like  # noqa: E402
from repro_torch.graphs.generators import grid3d  # noqa: E402
from repro_torch.sparse.symbolic import nnz_opc  # noqa: E402


@pytest.fixture(scope="module")
def g():
    return grid3d(9, 9, 9)


@pytest.fixture(scope="module")
def opc_by_p(g):
    return {p: nnz_opc(g, pt_scotch_like(g, seed=2, nproc=p,
                                         device="cpu"))[1]
            for p in (1, 8, 64)}


def test_quality_stable_with_procs(opc_by_p):
    vals = list(opc_by_p.values())
    assert max(vals) <= min(vals) * 1.25


def test_beats_parmetis_like_at_scale(g, opc_by_p):
    o_pm = nnz_opc(g, parmetis_like(g, seed=2, nproc=64, device="cpu"))[1]
    assert o_pm > 1.5 * opc_by_p[64]       # paper: up to ~2x at p=64


def test_deterministic_fixed_seed(g):
    p1 = pt_scotch_like(g, seed=7, nproc=8, device="cpu")
    p2 = pt_scotch_like(g, seed=7, nproc=8, device="cpu")
    assert np.array_equal(p1, p2)


def test_opc_scaling_3d():
    """ND on an n-vertex 3D mesh: OPC = O(n^2) (separator O(n^{2/3}),
    dense frontal O(sep^3) = O(n^2)); natural order is far worse."""
    small, large = grid3d(6, 6, 6), grid3d(12, 12, 12)
    o_s = nnz_opc(small, pt_scotch_like(small, seed=0, device="cpu"))[1]
    o_l = nnz_opc(large, pt_scotch_like(large, seed=0, device="cpu"))[1]
    growth = o_l / o_s
    n_ratio = large.n / small.n               # 8
    assert growth < n_ratio ** 2.6            # clearly sub-natural-order
    o_nat = nnz_opc(large, baselines.natural(large))[1]
    assert o_l < 0.45 * o_nat


def test_parmetis_like_equals_reference(g):
    got = parmetis_like(g, seed=2, nproc=8, device="cpu")
    want = jax_parmetis(jgen.grid3d(9, 9, 9), seed=2, nproc=8)
    assert np.array_equal(got, want)


def test_baseline_orderings_are_permutations(g):
    for perm in (baselines.mindeg_ordering(g, seed=1), baselines.natural(g),
                 baselines.rcm(g)):
        assert np.array_equal(np.sort(perm), np.arange(g.n))
    assert nnz_opc(g, baselines.mindeg_ordering(g))[1] < \
        nnz_opc(g, baselines.natural(g))[1]

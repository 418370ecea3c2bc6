"""The whole slice: the port's nested dissection equals the reference's.

On the CPU the port runs its plain versions of the kernels; the bar is
the reference's exact permutation (exact equality is the stated
tolerance: integer-valued weights and a bit-identical PRNG leave no room
for rounding).  Also here: the numpy copies agree with their originals,
device resolution refuses a missing card, and importing the port pulls in
neither jax nor the reference package.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import torch  # noqa: E402

from repro.core.nd import nested_dissection as jax_nd  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.sparse.mindeg import min_degree as jax_min_degree  # noqa: E402
from repro.sparse.symbolic import nnz_opc as jax_nnz_opc  # noqa: E402
from repro_torch.convert import graph_from_arrays  # noqa: E402
from repro_torch.core import nd  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.obs.instrument import instrument  # noqa: E402
from repro_torch.sparse.mindeg import min_degree  # noqa: E402
from repro_torch.sparse.symbolic import nnz_opc  # noqa: E402
from repro_torch.util import resolve_device  # noqa: E402

GRAPHS = {
    "grid2d_16x16": lambda m: m.grid2d(16, 16),
    "grid3d_7": lambda m: m.grid3d(7, 7, 7),
    "rgg2d_400": lambda m: m.rgg2d(400, seed=1),
}


@pytest.mark.parametrize("nproc", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_nested_dissection_equals_reference(name, seed, nproc):
    jg = GRAPHS[name](jgen)
    g = graph_from_arrays(jg.xadj, jg.adjncy, jg.vwgt, jg.adjwgt)
    with instrument() as ins:
        got = nd.nested_dissection(g, seed=seed, nproc=nproc, device="cpu")
    want = jax_nd(jg, seed=seed, nproc=nproc)
    assert np.array_equal(got, want), f"{name} seed={seed} nproc={nproc}"
    assert set(ins.stage_s) <= {"match", "bfs", "fm"}
    assert ins.stage_s["fm"] > 0
    # the looped driver runs one work a call: one lane a match/bfs call
    assert all(r["lanes"] == 1 for r in ins.launches if r["kind"] != "fm")
    assert not ins.waves
    assert nnz_opc(g, got) == jax_nnz_opc(jg, want)


@pytest.mark.parametrize("name,args", [
    ("grid2d", (9, 7)), ("grid3d", (4, 5, 3)), ("rgg2d", (200, 4)),
    ("circuit", (300, 2)), ("cage_like", (200, 1)), ("knn3d", (120, 6, 3)),
])
def test_generators_and_mindeg_are_copies(name, args):
    jg, g = getattr(jgen, name)(*args), getattr(gen, name)(*args)
    for f in ("xadj", "adjncy", "vwgt", "adjwgt"):
        assert np.array_equal(getattr(jg, f), getattr(g, f))
    assert np.array_equal(min_degree(g, tie_seed=3),
                          jax_min_degree(jg, tie_seed=3))


def test_initial_separator_equals_reference():
    from repro.core.initsep import initial_separator as jax_initial_separator
    from repro_torch.core.initsep import initial_separator
    jg = jgen.grid2d(11, 10)
    g = graph_from_arrays(jg.xadj, jg.adjncy, jg.vwgt, jg.adjwgt)
    part, sep_w = initial_separator(g, seed=4, k_tries=4, device="cpu")
    want, want_w = jax_initial_separator(jg, seed=4, k_tries=4)
    assert np.array_equal(part, want) and sep_w == want_w


def test_resolve_device():
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        nd.nested_dissection(gen.grid2d(4, 4))      # the default is the card


def test_fallback_and_small_graph_policies():
    g = gen.grid2d(30, 30)
    part = nd._fallback_separator(g, seed=2)
    assert min((part == 0).sum(), (part == 1).sum()) > 0
    src = np.repeat(np.arange(g.n), g.degrees())
    assert not np.any((part[src] == 0) & (part[g.adjncy] == 1))
    assert nd.resolve_separator(g, 2, None, nd.NDConfig()) is not None
    big_sep = gen.grid2d(30, 30).induced_subgraph(np.arange(900) < 700)[0]
    assert sorted(nd.separator_perm(big_sep, 0)) == list(range(700))
    perm = nd.nested_dissection(gen.grid2d(3, 3), device="cpu")
    assert sorted(perm) == list(range(9))


#: the service slice's modules, which the import gate must reach
SERVICE_SLICE = [f"repro_torch.{m}" for m in (
    "obs", "obs.tracer", "obs.metrics", "obs.instrument", "train",
    "train.fault", "core.dnd", "service", "service.api", "service.batch",
    "service.cache", "service.faults", "service.fingerprint",
    "service.router", "service.sched_policy", "service.scheduler")]


def test_import_pulls_in_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "n = sum(m.startswith('repro_torch') for m in sys.modules)\n"
        f"missing = [m for m in {SERVICE_SLICE!r} if m not in sys.modules]\n"
        "print(n, bad, missing)\n"
        "sys.exit(1 if bad or missing or n < 20 else 0)\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode == 0, proc.stdout + proc.stderr

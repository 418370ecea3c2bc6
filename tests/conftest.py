"""Test-suite bootstrap.

Two jobs:

* a ``slow`` marker for the full-size dnd / gather-free cases (multiple
  minutes of CPU ``shard_map`` subprocess each).  They are skipped by
  default so the local tier-1 run stays fast — reduced-size unmarked
  variants cover the same code paths — and run with ``--runslow`` (or
  ``REPRO_RUN_SLOW=1``) in the CI ``spmd`` job, which keeps the
  full-size assertions on every PR.
* the property tests use ``hypothesis`` when it is installed; on
  machines without it (the CI/base image only ships jax + pytest) a
  minimal deterministic shim is registered in ``sys.modules`` *before*
  test modules import it.  The shim replays a fixed pseudo-random sample
  of each strategy (``max_examples`` draws, seeded per test name) so the
  property tests still exercise many input shapes, just without
  shrinking.
"""
from __future__ import annotations

import functools
import inspect
import os
import sys
import types
import zlib

import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run slow-marked full-size dnd/gather-free tests")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: full-size dnd/gather-free case (skipped by default; the CI "
        "spmd job runs them with --runslow)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (the PyTorch port's kernels); skipped "
        "on hosts without one")


def pytest_collection_modifyitems(config, items):
    if (config.getoption("--runslow")
            or os.environ.get("REPRO_RUN_SLOW") == "1"):
        return
    skip = pytest.mark.skip(
        reason="full-size case: needs --runslow (CI spmd job runs these)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


def _install_hypothesis_shim() -> None:
    try:
        import hypothesis  # noqa: F401  (real library available)
        return
    except ImportError:
        pass

    import numpy as np

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def integers(lo: int, hi: int) -> _Strategy:
        return _Strategy(lambda rng: int(rng.integers(lo, hi + 1)))

    def floats(lo: float, hi: float, **_kw) -> _Strategy:
        return _Strategy(lambda rng: float(rng.uniform(lo, hi)))

    def booleans() -> _Strategy:
        return _Strategy(lambda rng: bool(rng.integers(0, 2)))

    def sampled_from(seq) -> _Strategy:
        seq = list(seq)
        return _Strategy(lambda rng: seq[int(rng.integers(len(seq)))])

    _DEFAULT_EXAMPLES = 10

    def given(*strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                # @settings sits *outside* @given, so read the example count
                # it attached to this wrapper at call time.
                n_ex = getattr(wrapper, "_shim_max_examples", _DEFAULT_EXAMPLES)
                seed = zlib.crc32(fn.__qualname__.encode())
                rng = np.random.default_rng(seed)
                for _ in range(n_ex):
                    vals = tuple(s.draw(rng) for s in strategies)
                    fn(*args, *vals, **kwargs)
            # Marker object mirroring the real library: plugins (e.g. anyio)
            # introspect ``fn.hypothesis.inner_test``.
            wrapper.hypothesis = types.SimpleNamespace(inner_test=fn)
            # The strategy-supplied params are not pytest fixtures.
            del wrapper.__wrapped__
            wrapper.__signature__ = inspect.Signature()
            return wrapper
        return deco

    def settings(max_examples: int = _DEFAULT_EXAMPLES, **_kw):
        def deco(fn):
            fn._shim_max_examples = max_examples
            return fn
        return deco

    mod = types.ModuleType("hypothesis")
    mod.given = given
    mod.settings = settings
    st = types.ModuleType("hypothesis.strategies")
    st.integers = integers
    st.floats = floats
    st.booleans = booleans
    st.sampled_from = sampled_from
    mod.strategies = st
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st


_install_hypothesis_shim()

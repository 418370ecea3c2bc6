"""The benchmark's tests: the ``cuda`` marker for the ones that need a
card (they skip without one)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped without one")

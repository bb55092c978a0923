"""leafbench's tests: ``python -m pytest leafbench/tests -q`` (CPU); the
card test: ``python3 -m pytest --noconftest leafbench/tests -q -m card``
on a machine with a CUDA card (``--noconftest``: the repo's root conftest
imports JAX, which that machine does not have)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")

"""The benchmark's own tests (CPU, tiny sizes): ``python3 -m pytest
portbench/tests -q``. Tests that need a CUDA device carry the ``card``
marker and skip, deciding inside the test, where there is none."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")

"""The `card` marker: tests that need a CUDA card skip inside the test,
with a reason, where there is none."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")

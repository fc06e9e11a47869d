import numpy as np
import pytest

# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# host's real single device; only launch/dryrun.py forces 512 devices.


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")

